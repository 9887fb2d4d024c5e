"""RA8 — spec vs docs drift (``protocol.py`` vs ``docs/protocol.md``).

``docs/protocol.md`` is the human-readable spec; this rule keeps it an
enforced mirror of the executable one, the way RA2/RA3 pin
``docs/events.md``/``docs/meters.md``:

* the "Task state machine" and "Worker state machine" tables (rows
  keyed `` `from--event` `` with a backticked target state in the next
  cell) must list exactly the edges in ``TASK_TRANSITIONS`` /
  ``WORKER_TRANSITIONS``, with matching targets;
* the "Invariants" table (rows keyed by invariant id with the owning
  rule backticked in the next cell) must list exactly
  ``protocol.INVARIANTS``.
"""
from __future__ import annotations

from repro_torch.analysis import docsmd, engine
from repro_torch.analysis.engine import Finding
from repro_torch.analysis.ra6_protocol import _assign_value, _edges
from repro_torch.analysis.ra7_invariants import _invariants

TITLE = "protocol docs drift (docs/protocol.md vs protocol.py)"

PROTOCOL = "src/repro_torch/analysis/protocol.py"
DOCS = "docs/protocol.md"

_MACHINES = (
    ("task", "Task state machine", "TASK_TRANSITIONS"),
    ("worker", "Worker state machine", "WORKER_TRANSITIONS"),
)
INV_SECTION = "Invariants"


def _section_line(doc: str, heading_substr: str) -> int:
    for heading, line, _body in docsmd.split_sections(doc):
        if heading_substr in heading:
            return line
    return 0


def _check_machine(findings, doc, name, section, edges) -> None:
    rows = docsmd.section_rows(doc, section)
    if rows is None:
        findings.append(Finding(
            "RA8", DOCS, 0,
            f"no '## {section}' section found",
            key=f"RA8:no-section:{name}"))
        return
    head = _section_line(doc, section)
    doc_edges = {r.key: r for r in rows}
    spec_edges = {f"{frm}--{evt}": (to, lineno)
                  for (frm, evt), (to, lineno) in edges.items()}
    for k in sorted(set(spec_edges) - set(doc_edges)):
        findings.append(Finding(
            "RA8", DOCS, head,
            f"{name} edge `{k}` (protocol.py:{spec_edges[k][1]}) is "
            f"not documented under '## {section}'",
            key=f"RA8:{name}-undocumented:{k}"))
    for k, row in sorted(doc_edges.items()):
        if k not in spec_edges:
            findings.append(Finding(
                "RA8", DOCS, row.line,
                f"documented {name} edge `{k}` is not in the "
                f"executable spec",
                key=f"RA8:{name}-stale:{k}"))
            continue
        target = row.ticked_fields(1)
        want = [spec_edges[k][0]]
        if target != want:
            findings.append(Finding(
                "RA8", DOCS, row.line,
                f"{name} edge `{k}` target drifted: docs say "
                f"{target}, spec says {want}",
                key=f"RA8:{name}-target:{k}"))


def check(project: engine.Project) -> list[Finding]:
    sf_p = project.source(PROTOCOL)
    if sf_p is None:
        return [project.missing("RA8", PROTOCOL)]
    doc = project.text(DOCS)
    if doc is None:
        return [project.missing("RA8", DOCS)]
    findings: list[Finding] = []
    for name, section, var in _MACHINES:
        edges = _edges(_assign_value(sf_p, var)[0])
        _check_machine(findings, doc, name, section, edges)
    # -- invariants table ---------------------------------------------
    registry = _invariants(sf_p)
    rows = docsmd.section_rows(doc, INV_SECTION)
    if rows is None:
        findings.append(Finding(
            "RA8", DOCS, 0,
            f"no '## {INV_SECTION}' section found",
            key="RA8:no-section:invariants"))
        return findings
    head = _section_line(doc, INV_SECTION)
    doc_invs = {r.key: r for r in rows}
    for inv in sorted(set(registry) - set(doc_invs)):
        findings.append(Finding(
            "RA8", DOCS, head,
            f"invariant `{inv}` (protocol.py:{registry[inv][1]}) is "
            f"not documented under '## {INV_SECTION}'",
            key=f"RA8:inv-undocumented:{inv}"))
    for inv, row in sorted(doc_invs.items()):
        if inv not in registry:
            findings.append(Finding(
                "RA8", DOCS, row.line,
                f"documented invariant `{inv}` is not in "
                f"protocol.INVARIANTS",
                key=f"RA8:inv-stale:{inv}"))
            continue
        rule = row.ticked_fields(1)
        want = [registry[inv][0]]
        if rule != want:
            findings.append(Finding(
                "RA8", DOCS, row.line,
                f"invariant `{inv}` owning rule drifted: docs say "
                f"{rule}, spec says {want}",
                key=f"RA8:inv-rule:{inv}"))
    return findings
