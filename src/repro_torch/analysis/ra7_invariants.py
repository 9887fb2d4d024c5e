"""RA7 — invariant registry vs checker implementation
(``protocol.INVARIANTS`` vs ``trace.TraceChecker.IMPLEMENTS``).

The spec's invariant registry is a promise; the trace checker is the
machine that keeps it.  This rule pins, by parsing both modules'
literals with :mod:`ast`:

* every registered invariant id is implemented by the checker
  (``TraceChecker.IMPLEMENTS``) — registering a contract nobody
  enforces is drift;
* every implemented id is registered — an undocumented check has no
  reviewable contract (and no docs row, see RA8);
* each registry entry names its owning rule (``RA6`` for
  machine/credential guards, ``RA7`` for cross-entity invariants), the
  rule prefix every finding key of that kind carries.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import engine
from repro_torch.analysis.engine import Finding
from repro_torch.analysis.ra6_protocol import _assign_value

TITLE = "invariant registry vs trace-checker implementation"

PROTOCOL = "src/repro_torch/analysis/protocol.py"
TRACE = "src/repro_torch/analysis/trace.py"

_VALID_RULES = ("RA6", "RA7")


def _invariants(sf: engine.SourceFile
                ) -> dict[str, tuple[str | None, int]]:
    """``INVARIANTS`` literal: id -> (rule tag, lineno)."""
    val, _ = _assign_value(sf, "INVARIANTS")
    out: dict[str, tuple[str | None, int]] = {}
    if not isinstance(val, ast.Dict):
        return out
    for k, v in zip(val.keys, val.values):
        if not (isinstance(k, ast.Constant)
                and isinstance(k.value, str)):
            continue
        rule = None
        elts = getattr(v, "elts", [])
        if elts and isinstance(elts[0], ast.Constant) \
                and isinstance(elts[0].value, str):
            rule = elts[0].value
        out[k.value] = (rule, k.lineno)
    return out


def _implements(sf: engine.SourceFile) -> dict[str, int]:
    """``TraceChecker.IMPLEMENTS`` literal: id -> lineno."""
    cls = engine.top_level_class(sf.tree, "TraceChecker")
    if cls is None:
        return {}
    for node in cls.body:
        target = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
        elif isinstance(node, ast.AnnAssign):
            target = node.target
        if isinstance(target, ast.Name) and target.id == "IMPLEMENTS":
            return {e.value: e.lineno
                    for e in getattr(node.value, "elts", [])
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)}
    return {}


def check(project: engine.Project) -> list[Finding]:
    sf_p = project.source(PROTOCOL)
    if sf_p is None:
        return [project.missing("RA7", PROTOCOL)]
    sf_t = project.source(TRACE)
    if sf_t is None:
        return [project.missing("RA7", TRACE)]
    findings: list[Finding] = []
    registry = _invariants(sf_p)
    if not registry:
        return [Finding("RA7", PROTOCOL, 0,
                        "INVARIANTS dict literal not found",
                        key="RA7:no-invariants")]
    impl = _implements(sf_t)
    if not impl:
        return [Finding("RA7", TRACE, 0,
                        "TraceChecker.IMPLEMENTS literal not found",
                        key="RA7:no-implements")]
    for inv in sorted(set(registry) - set(impl)):
        findings.append(Finding(
            "RA7", PROTOCOL, registry[inv][1],
            f"invariant {inv!r} is registered but TraceChecker does "
            f"not implement it",
            key=f"RA7:unimplemented:{inv}"))
    for inv in sorted(set(impl) - set(registry)):
        findings.append(Finding(
            "RA7", TRACE, impl[inv],
            f"TraceChecker implements {inv!r} which INVARIANTS does "
            f"not register",
            key=f"RA7:unregistered:{inv}"))
    for inv in sorted(registry):
        rule, lineno = registry[inv]
        if rule not in _VALID_RULES:
            findings.append(Finding(
                "RA7", PROTOCOL, lineno,
                f"invariant {inv!r} names owning rule {rule!r}; must "
                f"be one of {list(_VALID_RULES)}",
                key=f"RA7:bad-rule:{inv}"))
    return findings
