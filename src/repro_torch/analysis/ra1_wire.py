"""RA1 — wire-codec conformance (``core/messages.py``).

The two codecs must stay frame-for-frame symmetric: every ``OP_*``
constant needs an encoder *and* a decode branch in both ``DaskWire``
and ``StaticWire``, every op needs a machine-readable direction
comment (``# server -> worker: ...``), and every op a worker sends
*to the server* must be normalized by ``frame_event`` — otherwise one
codec grows a frame the other silently drops, exactly the drift class
this repo's two-runtime comparison cannot afford.

Everything is detected from the AST plus the constants' trailing
comments; the module is never imported.
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis import engine
from repro_torch.analysis.engine import Finding

TITLE = "wire-codec conformance (messages.py)"

MESSAGES = "src/repro_torch/core/messages.py"
WIRES = ("DaskWire", "StaticWire")
FRAME_EVENT = "frame_event"

_DIRECTION = re.compile(
    r"#\s*(server|worker)\s*->\s*(server|worker)\b")


def _op_constants(sf: engine.SourceFile) -> dict[str, tuple[int, str]]:
    """``OP_X -> (lineno, direction)``; direction is ``"src->dst"`` or
    ``""`` when the trailing comment is missing/unparseable."""
    ops: dict[str, tuple[int, str]] = {}
    for node in sf.tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        t = node.targets[0]
        if not (isinstance(t, ast.Name) and t.id.startswith("OP_")):
            continue
        m = _DIRECTION.search(sf.line(node.lineno))
        direction = f"{m.group(1)}->{m.group(2)}" if m else ""
        ops[t.id] = (node.lineno, direction)
    return ops


def _method_refs(cls: ast.ClassDef, pick) -> set[str]:
    refs: set[str] = set()
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and pick(node.name):
            refs |= engine.name_refs(node)
    return refs


def check(project: engine.Project) -> list[Finding]:
    sf = project.source(MESSAGES)
    if sf is None:
        return [project.missing("RA1", MESSAGES)]
    findings: list[Finding] = []
    ops = _op_constants(sf)
    if not ops:
        return [Finding("RA1", MESSAGES, 0,
                        "no OP_* constants found (layout changed?)",
                        key="RA1:no-ops")]
    for wire in WIRES:
        cls = engine.top_level_class(sf.tree, wire)
        if cls is None:
            findings.append(Finding(
                "RA1", MESSAGES, 0, f"wire class {wire} not found",
                key=f"RA1:no-class:{wire}"))
            continue
        enc = _method_refs(cls, lambda n: n.lstrip("_").
                           startswith("encode"))
        dec = _method_refs(cls, lambda n: n == "decode")
        for op, (line, _) in sorted(ops.items()):
            if op not in enc:
                findings.append(Finding(
                    "RA1", MESSAGES, line,
                    f"{op} has no encoder in {wire}",
                    key=f"RA1:encoder:{wire}:{op}"))
            if op not in dec:
                findings.append(Finding(
                    "RA1", MESSAGES, line,
                    f"{op} has no decode branch in {wire} (frames "
                    f"from the peer codec would be silently dropped)",
                    key=f"RA1:decode:{wire}:{op}"))
    fe = engine.top_level_func(sf.tree, FRAME_EVENT)
    if fe is None:
        findings.append(Finding(
            "RA1", MESSAGES, 0, f"{FRAME_EVENT}() not found",
            key="RA1:no-frame-event"))
        return findings
    fe_refs = engine.name_refs(fe)
    for op, (line, direction) in sorted(ops.items()):
        if not direction:
            findings.append(Finding(
                "RA1", MESSAGES, line,
                f"{op} has no machine-readable direction comment "
                f"(# server -> worker / # worker -> server)",
                key=f"RA1:direction:{op}"))
        elif direction.endswith("->server") and op not in fe_refs:
            findings.append(Finding(
                "RA1", MESSAGES, line,
                f"{op} is worker->server but {FRAME_EVENT}() never "
                f"normalizes it — the server would drop the frame",
                key=f"RA1:frame-event:{op}"))
    return findings
