"""RA3 — meter drift (stats surfaces vs ``docs/meters.md``).

``docs/meters.md`` promises: "If a key is not listed here, it is not
part of the surface."  This rule makes the promise mechanical, in both
directions, for the four meter surfaces:

* ``RunResult.stats`` — the union of ``ReactorStats.as_dict()``,
  ``_ProcessDriver.stats_extra()``, ``ServerCore.memory_stats()`` and
  the ``stats["..."]`` assignments in ``ServerCore.run_stats()``;
* ``EpochStats.as_dict()``;
* ``RunResult``'s own fields and properties;
* the ``observe()`` snapshot dict.

Keys come straight out of the AST (dict literals, ``dict(k=...)``
keywords, subscript assignments); the docs side comes from the tables
under the section headings named below.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import docsmd, engine
from repro_torch.analysis.engine import Finding

TITLE = "meter drift (stats/EpochStats/observe vs docs/meters.md)"

DOCS = "docs/meters.md"
SERVER = "src/repro_torch/core/server.py"
REACTOR = "src/repro_torch/core/reactor.py"
RUNTIME = "src/repro_torch/core/runtime.py"

#: docs/meters.md section-heading substrings -> which surface they feed
STATS_SECTIONS = ("Reactor counters", "Driver wire/codec meters",
                  "Memory-subsystem meters",
                  "Scheduler / observability counters")
EPOCH_SECTION = "EpochStats"
RUNRESULT_SECTION = "RunResult` (one-shot"
OBSERVE_SECTION = "observe()"


def _subscript_assign_keys(fn: ast.AST, target: str
                           ) -> list[tuple[str, int]]:
    """Keys of ``target["k"] = ...`` assignments inside ``fn``."""
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if isinstance(t, ast.Subscript) \
                    and isinstance(t.value, ast.Name) \
                    and t.value.id == target \
                    and isinstance(t.slice, ast.Constant) \
                    and isinstance(t.slice.value, str):
                out.append((t.slice.value, node.lineno))
    return out


def _stats_code_keys(project: engine.Project, findings: list[Finding]
                     ) -> dict[str, tuple[str, int]]:
    """stats key -> (path, line) across the four contributing layers."""
    keys: dict[str, tuple[str, int]] = {}

    def add(pairs, path):
        for k, line in pairs:
            keys.setdefault(k, (path, line))

    sf = project.source(REACTOR)
    if sf is None:
        findings.append(project.missing("RA3", REACTOR))
    else:
        cls = engine.top_level_class(sf.tree, "ReactorStats")
        m = cls and engine.class_method(cls, "as_dict")
        if m is None:
            findings.append(Finding(
                "RA3", REACTOR, 0, "ReactorStats.as_dict not found",
                key="RA3:no-reactor-stats"))
        else:
            add(engine.returned_dict_keys(m), REACTOR)
    sf = project.source(RUNTIME)
    if sf is None:
        findings.append(project.missing("RA3", RUNTIME))
    else:
        cls = engine.top_level_class(sf.tree, "_ProcessDriver")
        m = cls and engine.class_method(cls, "stats_extra")
        if m is None:
            findings.append(Finding(
                "RA3", RUNTIME, 0,
                "_ProcessDriver.stats_extra not found",
                key="RA3:no-stats-extra"))
        else:
            add(engine.returned_dict_keys(m), RUNTIME)
    sf = project.source(SERVER)
    if sf is None:
        findings.append(project.missing("RA3", SERVER))
        return keys
    cls = engine.top_level_class(sf.tree, "ServerCore")
    for name, how in (("memory_stats", "dict"), ("run_stats", "sub")):
        m = cls and engine.class_method(cls, name)
        if m is None:
            findings.append(Finding(
                "RA3", SERVER, 0, f"ServerCore.{name} not found",
                key=f"RA3:no-{name}"))
        elif how == "dict":
            add(engine.returned_dict_keys(m), SERVER)
        else:
            add(_subscript_assign_keys(m, "stats"), SERVER)
    return keys


def _doc_keys(doc: str, sections: tuple[str, ...] | str,
              findings: list[Finding]) -> dict[str, int] | None:
    if isinstance(sections, str):
        sections = (sections,)
    keys: dict[str, int] = {}
    for sec in sections:
        rows = docsmd.section_rows(doc, sec)
        if rows is None:
            findings.append(Finding(
                "RA3", DOCS, 0,
                f"no '## …{sec}…' section found in {DOCS}",
                key=f"RA3:docs-no-section:{sec}"))
            return None
        for r in rows:
            keys.setdefault(r.key, r.line)
    return keys


def _diff(surface: str, code: dict[str, tuple[str, int]],
          doc: dict[str, int], findings: list[Finding]) -> None:
    for k in sorted(set(code) - set(doc)):
        path, line = code[k]
        findings.append(Finding(
            "RA3", path, line,
            f"{surface} key {k!r} is not documented in {DOCS}",
            key=f"RA3:{surface}:undocumented:{k}"))
    for k in sorted(set(doc) - set(code)):
        findings.append(Finding(
            "RA3", DOCS, doc[k],
            f"{DOCS} documents {surface} key {k!r} the code never "
            f"produces",
            key=f"RA3:{surface}:stale-doc:{k}"))


def check(project: engine.Project) -> list[Finding]:
    findings: list[Finding] = []
    doc = project.text(DOCS)
    if doc is None:
        return [project.missing("RA3", DOCS)]
    # RunResult.stats ---------------------------------------------------
    code = _stats_code_keys(project, findings)
    dock = _doc_keys(doc, STATS_SECTIONS, findings)
    if dock is not None:
        _diff("stats", code, dock, findings)
    sf = project.source(SERVER)
    if sf is None:
        return findings
    # EpochStats.as_dict ------------------------------------------------
    cls = engine.top_level_class(sf.tree, "EpochStats")
    m = cls and engine.class_method(cls, "as_dict")
    if m is None:
        findings.append(Finding(
            "RA3", SERVER, 0, "EpochStats.as_dict not found",
            key="RA3:no-epoch-stats"))
    else:
        dock = _doc_keys(doc, EPOCH_SECTION, findings)
        if dock is not None:
            _diff("epoch",
                  {k: (SERVER, ln)
                   for k, ln in engine.returned_dict_keys(m)},
                  dock, findings)
    # RunResult fields + properties ------------------------------------
    cls = engine.top_level_class(sf.tree, "RunResult")
    if cls is None:
        findings.append(Finding(
            "RA3", SERVER, 0, "RunResult not found",
            key="RA3:no-runresult"))
    else:
        fields: dict[str, int] = {}
        for node in cls.body:
            if isinstance(node, ast.AnnAssign) \
                    and isinstance(node.target, ast.Name):
                fields[node.target.id] = node.lineno
            elif isinstance(node, ast.FunctionDef) and any(
                    isinstance(d, ast.Name) and d.id == "property"
                    for d in node.decorator_list):
                fields[node.name] = node.lineno
        dock = _doc_keys(doc, RUNRESULT_SECTION, findings)
        if dock is not None:
            _diff("runresult",
                  {k: (SERVER, ln) for k, ln in fields.items()},
                  dock, findings)
    # observe() ---------------------------------------------------------
    cls = engine.top_level_class(sf.tree, "ServerCore")
    m = cls and engine.class_method(cls, "observe")
    if m is None:
        findings.append(Finding(
            "RA3", SERVER, 0, "ServerCore.observe not found",
            key="RA3:no-observe"))
    else:
        dock = _doc_keys(doc, OBSERVE_SECTION, findings)
        if dock is not None:
            _diff("observe",
                  {k: (SERVER, ln)
                   for k, ln in engine.returned_dict_keys(m)},
                  dock, findings)
    return findings
