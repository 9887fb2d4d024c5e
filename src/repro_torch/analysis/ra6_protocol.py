"""RA6 — protocol spec well-formedness (``analysis/protocol.py`` vs
``core/events.py``).

The executable spec is only an oracle if it covers the actual
vocabulary and is internally coherent.  This rule pins, by parsing both
files' literals with :mod:`ast` (never importing them):

* ``protocol.EVENT_FIELDS`` mirrors ``events.EVENT_TYPES`` type-for-type
  and field-for-field, both directions — a new event type must be given
  protocol semantics the moment it exists;
* the TASK/WORKER/EPOCH/STATELESS partition covers every type exactly
  once;
* every transition edge references declared states and partition-correct
  events, and every task/worker event is consumed by at least one edge;
* every state is reachable from the initial state over declared edges.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import engine
from repro_torch.analysis.engine import Finding
from repro_torch.analysis.ra2_events import _event_types

TITLE = "protocol spec coverage (protocol.py vs events.py vocabulary)"

PROTOCOL = "src/repro_torch/analysis/protocol.py"
EVENTS = "src/repro_torch/core/events.py"

_PARTITIONS = ("TASK_EVENTS", "WORKER_EVENTS", "EPOCH_EVENTS",
               "STATELESS_EVENTS")


def _assign_value(sf: engine.SourceFile, name: str):
    """``(ast value node, lineno)`` of a top-level ``name = literal``."""
    for node in sf.tree.body:
        target = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
        elif isinstance(node, ast.AnnAssign):
            target = node.target
        if isinstance(target, ast.Name) and target.id == name:
            return node.value, node.lineno
    return None, 0


def _str_items(value) -> list[tuple[str, int]]:
    """Strings of a tuple/list literal, with linenos."""
    return [(e.value, e.lineno) for e in getattr(value, "elts", [])
            if isinstance(e, ast.Constant) and isinstance(e.value, str)]


def _fields_dict(value) -> dict[str, tuple[tuple[str, ...], int]]:
    """``{"type": ("f1", "f2")}`` literal -> type -> (fields, lineno)."""
    out: dict[str, tuple[tuple[str, ...], int]] = {}
    if not isinstance(value, ast.Dict):
        return out
    for k, v in zip(value.keys, value.values):
        if isinstance(k, ast.Constant) and isinstance(k.value, str):
            fields = tuple(e.value for e in getattr(v, "elts", [])
                           if isinstance(e, ast.Constant)
                           and isinstance(e.value, str))
            out[k.value] = (fields, k.lineno)
    return out


def _edges(value) -> dict[tuple[str, str], tuple[str, int]]:
    """``{(state, event): next_state}`` literal -> edge -> (target,
    lineno)."""
    out: dict[tuple[str, str], tuple[str, int]] = {}
    if not isinstance(value, ast.Dict):
        return out
    for k, v in zip(value.keys, value.values):
        if isinstance(k, ast.Tuple) and len(k.elts) == 2 \
                and all(isinstance(e, ast.Constant)
                        and isinstance(e.value, str) for e in k.elts) \
                and isinstance(v, ast.Constant) \
                and isinstance(v.value, str):
            out[(k.elts[0].value, k.elts[1].value)] = (v.value, k.lineno)
    return out


def _check_machine(findings, rel, name, edges, states, events,
                   decl_line) -> None:
    """Edge well-formedness + event coverage + state reachability for
    one machine (``name`` in {"task", "worker"})."""
    state_set = {s for s, _ in states}
    event_set = {e for e, _ in events}
    used_events: set[str] = set()
    for (frm, evt), (to, lineno) in sorted(edges.items()):
        used_events.add(evt)
        for s, what in ((frm, "source"), (to, "target")):
            if s not in state_set:
                findings.append(Finding(
                    "RA6", rel, lineno,
                    f"{name} edge ({frm!r}, {evt!r}) -> {to!r} uses "
                    f"undeclared {what} state {s!r}",
                    key=f"RA6:bad-edge:{name}:{frm}:{evt}"))
        if evt not in event_set:
            findings.append(Finding(
                "RA6", rel, lineno,
                f"{name} edge ({frm!r}, {evt!r}) consumes an event "
                f"outside {name.upper()}_EVENTS",
                key=f"RA6:bad-edge:{name}:{frm}:{evt}"))
    for evt, lineno in sorted(events):
        if evt not in used_events:
            findings.append(Finding(
                "RA6", rel, lineno,
                f"{name} event {evt!r} is consumed by no transition "
                f"edge — the machine cannot accept it",
                key=f"RA6:unused-event:{name}:{evt}"))
    if not states:
        return
    init = states[0][0]
    seen = {init}
    frontier = [init]
    while frontier:
        s = frontier.pop()
        for (frm, _evt), (to, _ln) in edges.items():
            if frm == s and to not in seen:
                seen.add(to)
                frontier.append(to)
    for s, lineno in states:
        if s not in seen:
            findings.append(Finding(
                "RA6", rel, lineno,
                f"{name} state {s!r} is unreachable from {init!r} over "
                f"the declared edges",
                key=f"RA6:unreachable-state:{name}:{s}"))


def check(project: engine.Project) -> list[Finding]:
    sf_p = project.source(PROTOCOL)
    if sf_p is None:
        return [project.missing("RA6", PROTOCOL)]
    sf_ev = project.source(EVENTS)
    if sf_ev is None:
        return [project.missing("RA6", EVENTS)]
    findings: list[Finding] = []

    spec_val, spec_line = _assign_value(sf_p, "EVENT_FIELDS")
    spec = _fields_dict(spec_val)
    if not spec:
        return [Finding("RA6", PROTOCOL, spec_line,
                        "EVENT_FIELDS dict literal not found",
                        key="RA6:no-event-fields")]
    vocab, vocab_line = _event_types(sf_ev)

    # -- vocabulary mirror, both directions ---------------------------
    for type_ in sorted(set(vocab) - set(spec)):
        findings.append(Finding(
            "RA6", PROTOCOL, spec_line,
            f"event type {type_!r} (events.py:{vocab[type_][1]}) has no "
            f"protocol semantics in EVENT_FIELDS",
            key=f"RA6:vocab-missing:{type_}"))
    for type_ in sorted(set(spec) - set(vocab)):
        findings.append(Finding(
            "RA6", PROTOCOL, spec[type_][1],
            f"EVENT_FIELDS declares {type_!r} which EVENT_TYPES no "
            f"longer has",
            key=f"RA6:vocab-stale:{type_}"))
    for type_ in sorted(set(spec) & set(vocab)):
        if spec[type_][0] != vocab[type_][0]:
            findings.append(Finding(
                "RA6", PROTOCOL, spec[type_][1],
                f"{type_!r} fields drifted: protocol says "
                f"{list(spec[type_][0])}, EVENT_TYPES says "
                f"{list(vocab[type_][0])}",
                key=f"RA6:vocab-fields:{type_}"))

    # -- partition: every spec type in exactly one set ----------------
    membership: dict[str, list[str]] = {t: [] for t in spec}
    parts: dict[str, list[tuple[str, int]]] = {}
    for pname in _PARTITIONS:
        val, _ = _assign_value(sf_p, pname)
        parts[pname] = _str_items(val)
        for t, lineno in parts[pname]:
            if t in membership:
                membership[t].append(pname)
            else:
                findings.append(Finding(
                    "RA6", PROTOCOL, lineno,
                    f"{pname} lists {t!r} which is not in EVENT_FIELDS",
                    key=f"RA6:partition:{t}"))
    for t in sorted(membership):
        n = len(membership[t])
        if n != 1:
            findings.append(Finding(
                "RA6", PROTOCOL, spec[t][1],
                f"event type {t!r} is in {n} partition sets "
                f"({membership[t] or 'none'}); must be in exactly one",
                key=f"RA6:partition:{t}"))

    # -- state machines -----------------------------------------------
    task_states = _str_items(_assign_value(sf_p, "TASK_STATES")[0])
    worker_states = _str_items(_assign_value(sf_p, "WORKER_STATES")[0])
    task_edges = _edges(_assign_value(sf_p, "TASK_TRANSITIONS")[0])
    worker_edges = _edges(_assign_value(sf_p, "WORKER_TRANSITIONS")[0])
    _check_machine(findings, PROTOCOL, "task", task_edges, task_states,
                   parts.get("TASK_EVENTS", []), spec_line)
    _check_machine(findings, PROTOCOL, "worker", worker_edges,
                   worker_states, parts.get("WORKER_EVENTS", []),
                   spec_line)
    return findings
