"""RA4 — blocking calls inside ``async def`` bodies.

The asyncio/uvloop server drivers share one event loop; one blocking
call inside a coroutine stalls every worker channel at once (the
paper's server-loop-occupancy story, inverted).  This rule walks every
``async def`` in ``src/repro_torch`` and flags:

* ``time.sleep(...)``;
* file opens — builtin ``open``, ``os.open``, ``os.fdopen``;
* blocking socket/selector methods (``accept``, ``connect``, ``recv``,
  ``recv_into``, ``sendall``, ``select``);
* un-awaited zero-argument ``.get()`` / ``.join()`` — the
  ``queue.Queue.get()`` / ``Thread.join()`` shapes (``dict.get`` takes
  a key, ``str.join`` an iterable, so neither false-positives; an
  awaited ``q.get()`` is an ``asyncio.Queue`` and fine).

Nested ``def``/``lambda`` bodies are skipped (they run when called,
usually as callbacks off the loop).  A legitimately-blocking line —
e.g. wrapping an already-open pipe fd during loop setup — carries a
``# ra: allow-blocking`` pragma on or directly above it.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import engine
from repro_torch.analysis.engine import Finding

TITLE = "blocking call in async def (event-loop stall lint)"

SCAN_DIR = "src/repro_torch"

#: module.func calls that always block (or hit the filesystem)
BLOCKING_DOTTED = {("time", "sleep"), ("os", "open"), ("os", "fdopen"),
                   ("os", "read"), ("os", "write")}
#: builtins that always block
BLOCKING_NAMES = {"open"}
#: method names that block on sockets/selectors regardless of receiver
BLOCKING_METHODS = {"accept", "connect", "recv", "recv_into",
                    "sendall", "select"}
#: zero-arg methods that block unless awaited (queue/thread shapes)
BLOCKING_ZERO_ARG = {"get", "join"}


def _async_defs(tree: ast.Module):
    for node in ast.walk(tree):
        if isinstance(node, ast.AsyncFunctionDef):
            yield node


def _direct_calls(fn: ast.AsyncFunctionDef):
    """Calls executed by the coroutine itself: skip nested function
    and lambda bodies, remember which calls are directly awaited."""
    todo: list[tuple[ast.AST, bool]] = [(s, False) for s in fn.body]
    while todo:
        node, awaited = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Await):
            todo.append((node.value, True))
            continue
        if isinstance(node, ast.Call):
            yield node, awaited
            # arguments of an awaited call still execute synchronously,
            # but a bare coroutine-factory arg (await gather(q.get()))
            # does not block — treat direct args as awaited too
            for child in ast.iter_child_nodes(node):
                todo.append((child, awaited))
            continue
        for child in ast.iter_child_nodes(node):
            todo.append((child, False))


def _blocking_reason(call: ast.Call, awaited: bool) -> str | None:
    f = call.func
    if isinstance(f, ast.Name) and f.id in BLOCKING_NAMES:
        return f"{f.id}() performs file I/O"
    if isinstance(f, ast.Attribute):
        if isinstance(f.value, ast.Name) \
                and (f.value.id, f.attr) in BLOCKING_DOTTED:
            return f"{f.value.id}.{f.attr}() blocks the loop"
        if f.attr in BLOCKING_METHODS and not awaited:
            return f".{f.attr}() is a blocking socket/selector call"
        if f.attr in BLOCKING_ZERO_ARG and not call.args \
                and not call.keywords and not awaited:
            return (f".{f.attr}() with no timeout blocks the loop "
                    f"(queue.Queue/Thread shape)")
    return None


def check(project: engine.Project) -> list[Finding]:
    findings: list[Finding] = []
    for rel in project.walk_py(SCAN_DIR):
        sf = project.source(rel)
        if sf is None:
            continue
        for fn in _async_defs(sf.tree):
            for call, awaited in _direct_calls(fn):
                reason = _blocking_reason(call, awaited)
                if reason is None:
                    continue
                if sf.pragma_for(call, "allow-blocking") is not None:
                    continue
                findings.append(Finding(
                    "RA4", rel, call.lineno,
                    f"in async {fn.name}(): {reason} — fix it or "
                    f"annotate the line with '# ra: allow-blocking'",
                    key=f"RA4:{rel}:{fn.name}:{call.lineno}"))
    return findings
