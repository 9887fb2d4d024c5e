"""RA5 — lock discipline for shared mutable state.

Two objects in this runtime are touched from more than one thread and
carry a documented protection contract; this rule enforces both:

* ``ObjectStore`` (``core/store.py``) — every write to the two-tier
  state (``_mem``/``_disk``/``_pinned`` and the byte meters) must sit
  lexically inside ``with self._lock``, except in the documented
  callers-hold-the-lock helpers — and those helpers may only be called
  from code that does hold the lock.
* ``ServerCore`` (``core/server.py``) — the scheduling ledgers are
  single-threaded by design: only methods reachable from the server
  loop's entry points may write them without a lock.  Any other method
  must wrap the write in ``with self._lock`` / ``with self._epoch_lock``
  (the documented thread-safe surfaces) or it is exactly the
  cross-thread mutation class this rule exists to catch.

Both method sets below are the *documented* contract (docs/analysis.md
mirrors them); changing the contract means changing them here, in the
docs, and in the code — which is the point.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import engine
from repro_torch.analysis.engine import Finding

TITLE = "lock discipline (ObjectStore / ServerCore shared state)"

STORE = "src/repro_torch/core/store.py"
SERVER = "src/repro_torch/core/server.py"

#: ObjectStore two-tier state + meters — writes require self._lock
STORE_GUARDED = {"_mem", "_disk", "_pinned", "mem_bytes", "peak_bytes",
                 "disk_bytes", "spill_bytes", "unspill_bytes",
                 "spill_count", "unspill_count"}
#: documented "callers hold self._lock" helpers (store.py says so)
STORE_HELPERS = {"_spill_path", "_spill_one", "_shrink", "_mem_add",
                 "_mem_sub", "_unspill", "_drop_disk"}
#: construction/GC run single-threaded by definition
STORE_EXEMPT = {"__init__", "__del__"}

#: ServerCore scheduling/memory ledgers — loop-thread-owned
SERVER_LEDGERS = {"dead", "worker_mem", "mem_pressured",
                  "peak_worker_bytes", "_w_spill_b", "_w_unspill_b",
                  "_w_spill_c", "_w_unspill_c", "_data_addrs",
                  "_replicas", "_gather_state", "_gather_failed",
                  "_parked", "_hinted", "_lost_handled", "_tasks_table",
                  "_completed", "_range_los", "_range_epochs",
                  "_epochs", "_finished_by_worker", "results"}
#: documented single-threaded entry points: the loop body plus the
#: driver callbacks that run on the loop thread, plus one-shot run()
SERVER_LOOP_ROOTS = {"_serve", "_bootstrap", "_loop_tick",
                     "_process_events", "_drain_control",
                     "_worker_lost", "run"}
SERVER_EXEMPT = {"__init__", "_init_epochs"}
SERVER_LOCKS = {"_lock", "_epoch_lock"}

_MUTATOR_METHODS = {"add", "append", "clear", "discard", "extend",
                    "insert", "pop", "popitem", "remove", "update",
                    "setdefault", "move_to_end", "difference_update",
                    "intersection_update", "symmetric_difference_update"}


def _methods(cls: ast.ClassDef) -> dict[str, ast.AST]:
    return {n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _is_lock_with(node: ast.With, locks: set[str]) -> bool:
    for item in node.items:
        if engine.is_self_attr(item.context_expr, locks):
            return True
    return False


def _nodes_under_lock(fn: ast.AST, locks: set[str]) -> set[int]:
    """ids of every AST node lexically inside ``with self.<lock>``."""
    inside: set[int] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.With) and _is_lock_with(node, locks):
            for sub in ast.walk(node):
                inside.add(id(sub))
    return inside


def _mutations(fn: ast.AST, guarded: set[str]):
    """``(node, attr, how)`` for writes to ``self.<attr>`` state:
    assignments, augmented assignments, deletes, subscript stores and
    mutating method calls (``self._mem.pop(...)``)."""
    for node in ast.walk(fn):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [getattr(node, "target", None)]
                       if isinstance(node, ast.AugAssign)
                       else node.targets)
            for t in targets:
                if isinstance(t, (ast.Tuple, ast.List)):
                    tt = list(t.elts)
                else:
                    tt = [t]
                for x in tt:
                    if isinstance(x, ast.Subscript):
                        x = x.value
                    attr = x is not None and engine.is_self_attr(
                        x, guarded)
                    if attr:
                        yield node, attr, "write"
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATOR_METHODS:
            attr = engine.is_self_attr(node.func.value, guarded)
            if attr:
                yield node, attr, f".{node.func.attr}()"


def _self_calls(fn: ast.AST) -> set[str]:
    """Every ``self.X`` reference — calls AND bare method references
    (``self._charge(self._compact_to, …)`` defers a loop-context call,
    so a reference is an edge too)."""
    out = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self":
            out.add(node.attr)
    return out


def _closure(methods: dict[str, ast.AST], roots: set[str]) -> set[str]:
    seen, todo = set(), [r for r in roots if r in methods]
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        for callee in _self_calls(methods[name]):
            if callee in methods and callee not in seen:
                todo.append(callee)
    return seen


def _check_store(project: engine.Project,
                 findings: list[Finding]) -> None:
    sf = project.source(STORE)
    if sf is None:
        findings.append(project.missing("RA5", STORE))
        return
    cls = engine.top_level_class(sf.tree, "ObjectStore")
    if cls is None:
        findings.append(Finding(
            "RA5", STORE, 0, "class ObjectStore not found",
            key="RA5:no-objectstore"))
        return
    methods = _methods(cls)
    for name, fn in sorted(methods.items()):
        if name in STORE_EXEMPT or name in STORE_HELPERS:
            continue
        locked = _nodes_under_lock(fn, {"_lock"})
        for node, attr, how in _mutations(fn, STORE_GUARDED):
            if id(node) not in locked:
                findings.append(Finding(
                    "RA5", STORE, node.lineno,
                    f"ObjectStore.{name} {how} writes self.{attr} "
                    f"outside 'with self._lock'",
                    key=f"RA5:store:{name}:{attr}"))
        # a callers-hold-the-lock helper may only be entered while
        # the lock is held
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id == "self" \
                    and node.func.attr in STORE_HELPERS \
                    and id(node) not in locked:
                findings.append(Finding(
                    "RA5", STORE, node.lineno,
                    f"ObjectStore.{name} calls lock-expecting helper "
                    f"{node.func.attr}() outside 'with self._lock'",
                    key=f"RA5:store-helper:{name}:{node.func.attr}"))


def _check_server(project: engine.Project,
                  findings: list[Finding]) -> None:
    sf = project.source(SERVER)
    if sf is None:
        findings.append(project.missing("RA5", SERVER))
        return
    cls = engine.top_level_class(sf.tree, "ServerCore")
    if cls is None:
        findings.append(Finding(
            "RA5", SERVER, 0, "class ServerCore not found",
            key="RA5:no-servercore"))
        return
    methods = _methods(cls)
    loop_ctx = _closure(methods, SERVER_LOOP_ROOTS)
    for name, fn in sorted(methods.items()):
        if name in SERVER_EXEMPT or name in loop_ctx:
            continue
        locked = _nodes_under_lock(fn, SERVER_LOCKS)
        for node, attr, how in _mutations(fn, SERVER_LEDGERS):
            if id(node) not in locked:
                findings.append(Finding(
                    "RA5", SERVER, node.lineno,
                    f"ServerCore.{name} {how} writes ledger "
                    f"self.{attr} off the loop thread without "
                    f"self._lock/self._epoch_lock (route it through "
                    f"_submit_q instead)",
                    key=f"RA5:server:{name}:{attr}"))


def check(project: engine.Project) -> list[Finding]:
    findings: list[Finding] = []
    _check_store(project, findings)
    _check_server(project, findings)
    return findings
