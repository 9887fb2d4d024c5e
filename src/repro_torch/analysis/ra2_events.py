"""RA2 — event-schema conformance (``core/events.py`` vs publish sites
vs ``docs/events.md``).

``EVENT_TYPES`` is the single vocabulary; this rule pins it from three
sides:

* every ``publish("type", field=...)`` call site uses a declared type
  with exactly the declared fields;
* every declared type is published somewhere (or allowlisted) — dead
  vocabulary is drift waiting to be misread;
* the ``docs/events.md`` tables agree with the vocabulary, type for
  type and field for field.

A publish whose type argument is not a string literal must carry a
``# ra: event-types a,b`` pragma naming the types that flow through
it; each named type is then field-checked as usual.  Fields beyond the
declared set are findings — additive optional fields are allowed by
the schema's versioning policy, but must be allowlisted here (with the
doc pointer as justification) so they stay a deliberate act.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import docsmd, engine
from repro_torch.analysis.engine import Finding

TITLE = "event-schema conformance (events.py / publish sites / docs)"

EVENTS = "src/repro_torch/core/events.py"
DOCS = "docs/events.md"
DOCS_SECTION = "Event types"
#: the port's own additions to the vocabulary are documented in a later
#: section of the same file, which the reference package's rule does not
#: read (``docs/events.md`` serves both packages)
PORT_SECTION = "Program spans"
#: every module that may publish; a site elsewhere simply isn't seen,
#: so new publishers must be added here (docs/analysis.md says so)
SCAN = (
    "src/repro_torch/core/events.py",
    "src/repro_torch/core/server.py",
    "src/repro_torch/core/simulator.py",
    "src/repro_torch/core/store.py",
    "src/repro_torch/core/runtime.py",
    "src/repro_torch/serve/engine.py",
    "src/repro_torch/train/trainer.py",
)
#: the program span recorder publishes ``span``; without this module
#: that type reads as unpublished, so its absence needs no finding of its
#: own
OPTIONAL_SCAN = ("src/repro_torch/core/tracing.py",)


def _event_types(sf: engine.SourceFile
                 ) -> tuple[dict[str, tuple[tuple[str, ...], int]], int]:
    """Parse the ``EVENT_TYPES`` literal: type -> (fields, lineno)."""
    for node in sf.tree.body:
        target = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
        elif isinstance(node, ast.AnnAssign):
            target = node.target
        if target is not None and isinstance(target, ast.Name) \
                and target.id == "EVENT_TYPES" \
                and isinstance(node.value, ast.Dict):
            out: dict[str, tuple[tuple[str, ...], int]] = {}
            for k, v in zip(node.value.keys, node.value.values):
                if not (isinstance(k, ast.Constant)
                        and isinstance(k.value, str)):
                    continue
                fields = tuple(
                    e.value for e in getattr(v, "elts", [])
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str))
                out[k.value] = (fields, k.lineno)
            return out, node.lineno
    return {}, 0


def _publish_calls(sf: engine.SourceFile
                   ) -> list[tuple[ast.Call, str | None]]:
    """``(call, literal_type_or_None)`` for every ``*.publish(...)``
    call except the ``EventBus.publish`` definition's own body."""
    out = []
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "publish" and node.args:
            a0 = node.args[0]
            lit = a0.value if (isinstance(a0, ast.Constant)
                              and isinstance(a0.value, str)) else None
            out.append((node, lit))
    return out


def _check_fields(sf, call, type_, declared, findings) -> None:
    fields, lineno = declared
    kwargs = {kw.arg for kw in call.keywords if kw.arg is not None}
    if any(kw.arg is None for kw in call.keywords):
        findings.append(Finding(
            "RA2", sf.rel, call.lineno,
            f"publish({type_!r}, **...) spreads unknown fields — "
            f"spell them out so the schema is checkable",
            key=f"RA2:splat:{type_}"))
        return
    for f in sorted(set(fields) - kwargs):
        findings.append(Finding(
            "RA2", sf.rel, call.lineno,
            f"publish({type_!r}) omits declared field {f!r}",
            key=f"RA2:missing-field:{type_}:{f}"))
    for f in sorted(kwargs - set(fields)):
        findings.append(Finding(
            "RA2", sf.rel, call.lineno,
            f"publish({type_!r}) passes field {f!r} not declared in "
            f"EVENT_TYPES (additive optional fields need an allowlist "
            f"entry citing docs/events.md)",
            key=f"RA2:extra-field:{type_}:{f}"))


def check(project: engine.Project) -> list[Finding]:
    sf_ev = project.source(EVENTS)
    if sf_ev is None:
        return [project.missing("RA2", EVENTS)]
    findings: list[Finding] = []
    types, decl_line = _event_types(sf_ev)
    if not types:
        return [Finding("RA2", EVENTS, 0,
                        "EVENT_TYPES dict literal not found",
                        key="RA2:no-event-types")]
    published: set[str] = set()
    for rel in SCAN + OPTIONAL_SCAN:
        sf = project.source(rel)
        if sf is None:
            if rel not in OPTIONAL_SCAN:
                findings.append(project.missing("RA2", rel))
            continue
        for call, lit in _publish_calls(sf):
            if lit is None:
                pragma = sf.pragma_for(call, "event-types")
                if pragma is None:
                    findings.append(Finding(
                        "RA2", sf.rel, call.lineno,
                        "publish() with a non-literal event type — "
                        "annotate the site with '# ra: event-types "
                        "a,b' naming the types that flow through it",
                        key=f"RA2:dynamic-publish:{sf.rel}"))
                    continue
                names = [t.strip() for t in pragma.split(",")
                         if t.strip()]
            else:
                names = [lit]
            for type_ in names:
                if type_ not in types:
                    findings.append(Finding(
                        "RA2", sf.rel, call.lineno,
                        f"publish({type_!r}): type not declared in "
                        f"EVENT_TYPES",
                        key=f"RA2:unknown-type:{type_}"))
                    continue
                published.add(type_)
                _check_fields(sf, call, type_, types[type_], findings)
    for type_ in sorted(set(types) - published):
        findings.append(Finding(
            "RA2", EVENTS, types[type_][1],
            f"EVENT_TYPES declares {type_!r} but no scanned module "
            f"publishes it",
            key=f"RA2:unpublished:{type_}"))
    # --- docs/events.md agreement ------------------------------------
    doc = project.text(DOCS)
    if doc is None:
        findings.append(project.missing("RA2", DOCS))
        return findings
    rows = docsmd.section_rows(doc, DOCS_SECTION)
    if rows is None:
        findings.append(Finding(
            "RA2", DOCS, 0,
            f"no '## {DOCS_SECTION}' section found",
            key="RA2:docs-no-section"))
        return findings
    rows += docsmd.section_rows(doc, PORT_SECTION) or []
    doc_types = {r.key: r for r in rows}
    for type_ in sorted(set(types) - set(doc_types)):
        findings.append(Finding(
            "RA2", EVENTS, types[type_][1],
            f"event type {type_!r} is not documented in {DOCS}",
            key=f"RA2:undocumented:{type_}"))
    for type_, row in sorted(doc_types.items()):
        if type_ not in types:
            findings.append(Finding(
                "RA2", DOCS, row.line,
                f"{DOCS} documents unknown event type {type_!r}",
                key=f"RA2:docs-stale:{type_}"))
            continue
        doc_fields = row.ticked_fields(1)
        declared = list(types[type_][0])
        if doc_fields != declared:
            findings.append(Finding(
                "RA2", DOCS, row.line,
                f"{type_!r} fields drifted: docs say {doc_fields}, "
                f"EVENT_TYPES says {declared}",
                key=f"RA2:docs-fields:{type_}"))
    return findings
