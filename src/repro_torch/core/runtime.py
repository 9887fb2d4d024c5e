"""Real-time (wall-clock) execution engine for thread workers: the part
of :mod:`repro_torch.core.runtime` that ``runtime="thread"`` needs.

The protocol state machine lives ONCE in
:class:`repro_torch.core.server.ServerCore`; this module supplies the
execution driver that plugs into it:

* :class:`InprocDriver` — worker *threads* over object queues
  (:class:`repro_torch.core.transport.InprocTransport`); no codec is paid
  on the channel (the Dask-style reactor keeps simulating it).

The driver publishes into the observability feed
(:mod:`repro_torch.core.events`, enabled via ``events=`` on the runtime
or on ``Cluster``) because the instrumentation lives in the shared
ServerCore; it additionally publishes worker-side ``task-started``
events (thread workers share the server's process).

:class:`ThreadRuntime` is a thin shell over
:class:`~repro_torch.core.server.ServerCore` preserving the original
public surface (``start``/``submit_tasks``/``wait_epoch``/``fetch``/
``fail_worker``/``run``/``shutdown``, plus the attributes the fault/
elasticity utilities poke).  The one-shot ``run()`` wraps the persistent
lifecycle; the user-facing surface lives in
:mod:`repro_torch.core.client`.

Not copied: ``ProcessRuntime`` and its selector, asyncio and uvloop
drivers (OS-process workers behind a byte transport).
"""
from __future__ import annotations

import queue
import threading
import time

from repro_torch.core import transport as tp
from repro_torch.core.graph import TaskGraph
from repro_torch.core.server import Driver, EpochStats, RunResult, \
    ServerCore

__all__ = ["EpochStats", "RunResult", "ServerCore", "Driver",
           "InprocDriver", "ThreadRuntime", "run_graph"]


# ---------------------------------------------------------------------------
# In-process driver (thread workers)
# ---------------------------------------------------------------------------

class InprocDriver(Driver):
    """Thread workers over object queues.  No wire, no worker caches:
    results land directly in ``core.results``."""

    name = "inproc"
    transport_kind = "inproc"
    transport: tp.InprocTransport    # wired by the ThreadRuntime shell

    def start_workers(self) -> None:
        core = self.core
        for w in range(core.n_workers):
            threading.Thread(target=core._worker_loop, args=(w,),
                             daemon=True).start()

    def poll(self, timeout: float) -> list[tuple]:
        core = self.core
        try:
            first = self.transport.recv(timeout=timeout)
        except queue.Empty:
            return []
        # drain for batching (RSDS-style batch processing)
        batch = [first] + self.transport.drain()
        events: list[tuple] = []
        fins: list[tuple[int, int]] = []
        for ev in batch:
            kind = ev[0]
            if kind == "finished":
                fins.append((int(ev[1]), int(ev[2])))
            elif kind == "worker-lost":
                events.append(("lost", ev[1], list(ev[2])))
            elif kind == "lost-route":
                events.append(("lost", ev[2], [ev[1]]))
            elif kind == "stop":
                core._stop_requested = True
            elif kind in ("epoch", "release"):
                core._submit_q.put(ev)     # legacy injection path
        if fins:
            events.append(("finished", fins, None))
        return events

    def wake(self) -> None:
        self.transport.inject(("wake",))

    # -- queue accounting: dict-of-lists guarded by the runtime lock
    # (worker threads dequeue under the same lock; fail_worker snapshots
    # it from any thread) --------------------------------------------------

    def queue_push(self, wid: int, tid: int) -> bool:
        # dead-check and queue append under ONE lock: fail_worker's
        # snapshot of queued[wid] happens under the same lock, so a task
        # is always either captured by the snapshot or rerouted as lost
        # by the core — never silently stranded in between
        core = self.core
        with core._lock:
            if wid in core.dead:
                return False
            core.queued.setdefault(wid, []).append(tid)
        return True

    def queue_discard(self, wid: int, tid: int) -> None:
        pass    # the worker dequeues at execution start (retraction check)

    def queue_pop(self, wid: int) -> list[int]:
        with self.core._lock:
            return list(self.core.queued.pop(wid, []))

    def queue_snapshot(self) -> dict[int, list[int]]:
        with self.core._lock:
            return {w: list(q) for w, q in self.core.queued.items() if q}

    def queue_contains(self, wid: int, tid: int) -> bool:
        with self.core._lock:
            return tid in self.core.queued.get(wid, ())

    def retract_moves(self, moves):
        """Definitive retraction: the task is removed from its source
        queue under the lock, so a moved task can never double-execute."""
        core = self.core
        real, failed = [], []
        with core._lock:
            for tid, nw in moves:
                src = next((w for w, q in core.queued.items()
                            if tid in q), None)
                if src is None:
                    failed.append(tid)  # already running
                    continue
                core.queued[src].remove(tid)
                real.append((tid, nw))
        return real, failed

    # -- sends ----------------------------------------------------------

    def send_compute(self, wid: int, items) -> None:
        for tid, _dur in items:
            self.transport.send(wid, tid)

    # -- failure injection ----------------------------------------------

    def fail_worker(self, wid: int) -> None:
        """Worker stops responding; the loss is routed through the server
        inbox as a ``("worker-lost", wid, lost)`` event so the reactor is
        only ever touched by the server loop (safe from any thread)."""
        core = self.core
        with core._lock:
            core.dead.add(wid)
            lost = list(core.queued.pop(wid, []))
            r = core.running.get(wid)
            if r is not None:
                lost.append(r)
        self.transport.inject(("worker-lost", wid, tuple(lost)))

    def finalize(self, force: bool) -> None:
        for wid in range(len(self.transport.worker_queues)):
            self.transport.send(wid, None)


# ---------------------------------------------------------------------------
# Engine shells
# ---------------------------------------------------------------------------

class ThreadRuntime(ServerCore):
    """Server thread + worker threads connected by an
    :class:`repro_torch.core.transport.InprocTransport`.  Tasks are real
    Python callables (or calibrated sleeps, or zero-worker instant
    completions); workers are threads — the GIL is released during sleeps
    and numpy/torch work, matching the paper's single-threaded-worker
    setup.  Also the substrate for the framework integration: the trainer
    and serving engine submit task graphs here."""

    def __init__(self, graph: TaskGraph, reactor, n_workers: int,
                 *, zero_worker: bool = False, simulate_durations=True,
                 balance_interval: float = 0.05, timeout: float = 300.0,
                 memory_limit: int | None = None,
                 spill_dir: str | None = None, high_water: float = 0.8,
                 compact_threshold: int | None = 8192, events=None,
                 tracing: bool = False):
        self.zero_worker = zero_worker
        self.simulate_durations = simulate_durations
        # thread workers share the server's ObjectStore, so the memory
        # limit bounds the POOL's result footprint (one node, one store)
        super().__init__(graph, reactor, n_workers, InprocDriver(),
                         p2p=False, balance_interval=balance_interval,
                         timeout=timeout, memory_limit=memory_limit,
                         spill_dir=spill_dir, high_water=high_water,
                         compact_threshold=compact_threshold,
                         events=events, tracing=tracing)
        self.transport = tp.InprocTransport(n_workers)
        self.driver.transport = self.transport
        self.queued: dict[int, list[int]] = {}
        self.running: dict[int, int] = {}   # wid -> tid

    # back-compat views onto the transport (trainer / faults poke these)
    @property
    def server_inbox(self) -> queue.Queue:
        return self.transport.inbox

    @property
    def worker_inbox(self) -> list[queue.Queue]:
        return self.transport.worker_queues

    # ------------------------------------------------------------------
    def _worker_loop(self, wid: int) -> None:
        while True:
            item = self.transport.worker_recv(wid)
            if item is None:
                return
            tid = item
            recv = time.perf_counter_ns() if self.tracing else 0
            if wid in self.dead:
                continue
            with self._lock:
                q = self.queued.setdefault(wid, [])
                if tid in q:
                    q.remove(tid)
                else:
                    # retracted: the server stole this task after queuing
                    # it here (it left queued[wid] under the lock), so
                    # skip it instead of double-executing — on a warm
                    # pool a straggler's stale backlog would otherwise
                    # delay the next epoch
                    continue
                self.running[wid] = tid
            ev = self.events
            if ev is not None:
                ev.publish("task-started", tid=tid, wid=wid)
            start = time.perf_counter_ns() if self.tracing else 0
            if not self.zero_worker:
                t = self.g.task(tid)
                if t.fn is not None:
                    # store reads unspill transparently; the put pays
                    # the byte accounting (and any LRU spill) here
                    args = [self.results.get(d) for d in t.inputs]
                    self.results.put(tid, t.fn(*args) if t.args == ()
                                     else t.fn(*t.args))
                elif self.simulate_durations and t.duration > 0:
                    time.sleep(t.duration)
            with self._lock:
                self.running.pop(wid, None)
            if self.tracing:
                # same clock domain as the server (thread workers):
                # _note_timing folds + publishes, offset ends up ~0
                self._note_timing(
                    wid, ((tid, recv, start, time.perf_counter_ns(), 0),))
            self.transport.worker_send(wid, ("finished", tid, wid))



# ---------------------------------------------------------------------------

def run_graph(graph: TaskGraph, server: str = "rsds",
              scheduler: str = "ws", n_workers: int = 8,
              runtime: str = "thread", seed: int = 0, **kw) -> RunResult:
    """Run a graph on the wall-clock thread engine.

    runtime="thread": in-process worker threads (codec simulated for the
    Dask-style server).  ``runtime="process"`` (and its shorthand
    ``server="selector"|"asyncio"|"uvloop"``) raises
    ``NotImplementedError``: the port has no process runtime yet.

    Memory subsystem kwargs: ``memory_limit`` bounds the pool's shared
    :class:`repro_torch.core.store.ObjectStore` in bytes; overflow spills
    to ``spill_dir`` (a private temp dir by default) and unspills on
    access; ``high_water`` (fraction of the limit) marks workers as
    under memory pressure for stealing decisions.

    Observability: ``events=True`` turns on the structured event feed
    (:mod:`repro_torch.core.events`), ``events=<path>`` additionally
    records it to a rotating JSONL log;
    ``RunResult.stats["n_events"]`` reports the publish count.  Off (the
    default) costs nothing.  ``tracing=True`` (with ``events=`` set)
    additionally publishes per-task worker-side timestamps as
    ``task-timing`` events.

    Back-compat wrapper over the persistent Cluster/Client API: spins a
    one-shot :class:`repro_torch.core.client.Cluster` up, submits
    ``graph`` as a single epoch, waits, and tears the pool down —
    equivalent to::

        with Cluster(...) as c:
            c.client.submit_graph(graph).result()
    """
    from repro_torch.core.client import Cluster

    if server in ("selector", "asyncio", "uvloop"):
        runtime = "process"
    if runtime not in ("thread", "process"):
        raise ValueError(f"unknown runtime {runtime!r} (want thread|process)")
    timeout = kw.get("timeout", 300.0)
    cluster = Cluster(server=server, scheduler=scheduler,
                      n_workers=n_workers, runtime=runtime, seed=seed,
                      name=graph.name, **kw)
    timed_out = False
    try:
        gf = cluster.client.submit_graph(graph)
        timed_out = not gf.wait(timeout)
        return cluster.run_result(gf, timed_out=timed_out)
    finally:
        cluster.close(force=timed_out)
