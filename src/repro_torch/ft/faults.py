"""Fault tolerance & elasticity utilities around the core runtime (a
copy of :mod:`repro.ft.faults` on :mod:`repro_torch.core`).

The paper's runtime already gives us the primitives (task resubmission via
``handle_worker_lost``, lineage recompute, scheduler worker-removal); this
module adds the *policies* a 1000-node deployment needs:

  * heartbeat monitoring with automatic failover,
  * straggler detection -> forced balancing (work stealing as mitigation,
    the paper's scheduler doing double duty),
  * an elastic controller that grows/shrinks the worker pool,
  * deterministic failure-injection schedules for tests/benchmarks.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np


@dataclasses.dataclass
class FailurePlan:
    """Deterministic injection schedule: [(virtual_or_wall_time, wid)]."""
    events: tuple = ()

    def for_simulator(self):
        return tuple(self.events)

    def apply_wallclock(self, runtime) -> list[threading.Timer]:
        """Arm the schedule against a wall-clock runtime.

        Works uniformly on both engines: on a ThreadRuntime,
        ``fail_worker`` routes a worker-lost event through the server
        inbox; on a ProcessRuntime it SIGKILLs the worker process and the
        server resubmits its outstanding tasks.  Call before
        ``runtime.run()``; returns the timers (cancel to abort)."""
        timers = []
        for delay, wid in self.events:
            t = threading.Timer(delay, runtime.fail_worker, args=(wid,))
            t.daemon = True
            t.start()
            timers.append(t)
        return timers


def kill_worker_after(runtime, wid: int, delay: float) -> threading.Timer:
    """One-shot process/thread worker kill (first-class failure
    injection for tests and benchmarks)."""
    (t,) = FailurePlan(((delay, wid),)).apply_wallclock(runtime)
    return t


class HeartbeatMonitor:
    """Watches a ThreadRuntime's workers; a worker that hasn't reported a
    completion within ``grace`` while holding tasks is declared dead and
    failed over (resubmission through the reactor)."""

    def __init__(self, runtime, grace: float = 1.0, interval: float = 0.2):
        self.rt = runtime
        self.grace = grace
        self.interval = interval
        self.last_seen = {w: time.perf_counter()
                          for w in range(runtime.n_workers)}
        self.failed: list[int] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def beat(self, wid: int) -> None:
        self.last_seen[wid] = time.perf_counter()

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.is_set():
            now = time.perf_counter()
            for wid, seen in list(self.last_seen.items()):
                if wid in self.rt.dead:
                    continue
                busy = (wid in self.rt.running
                        or self.rt.queued.get(wid))
                if busy and now - seen > self.grace:
                    self.failed.append(wid)
                    self.rt.fail_worker(wid)
            time.sleep(self.interval)


class StragglerMitigator:
    """Detects straggling workers (queue age >> mean) and triggers an
    immediate balancing pass — the paper's work stealing applied as
    straggler mitigation for SPMD microbatch dispatch."""

    def __init__(self, runtime, factor: float = 3.0):
        self.rt = runtime
        self.factor = factor
        self.interventions = 0

    def check(self) -> int:
        with self.rt._lock:
            qlens = {w: len(q) for w, q in self.rt.queued.items()
                     if w not in self.rt.dead}
        if not qlens:
            return 0
        lens = np.array(list(qlens.values()))
        if lens.max() >= max(self.factor * max(lens.mean(), 0.5), 2):
            qbw = {w: list(self.rt.queued.get(w, []))
                   for w in qlens}
            moves = self.rt.reactor.rebalance(qbw)
            applied = self.rt._apply_moves(moves)
            self.interventions += len(applied)
            return len(applied)
        return 0


class ElasticController:
    """Grows/shrinks a ThreadRuntime's worker pool at runtime.  Growth
    spawns a worker thread and notifies the scheduler; shrink retires the
    worker gracefully (its queue is rebalanced, not lost).

    Thread runtime only: process workers cannot be grown this way (a new
    OS process would need transport registration and a live handshake),
    so attaching to a ProcessRuntime — or a process-backed Cluster —
    raises immediately instead of failing at scale-up time.  Extending
    elasticity to process pools stays a ROADMAP item."""

    def __init__(self, runtime):
        # accept a Cluster (unwrap to its runtime) or a runtime directly
        runtime = getattr(runtime, "runtime", runtime)
        if not hasattr(runtime, "transport") \
                or not hasattr(runtime.transport, "add_worker"):
            raise NotImplementedError(
                "ElasticController supports thread runtimes only; "
                f"{type(runtime).__name__} workers are OS processes and "
                "cannot be scaled in-place (see ROADMAP: process-elastic "
                "support)")
        self.rt = runtime

    def scale_up(self, n: int = 1) -> list[int]:
        new_ids = []
        for _ in range(n):
            wid = self.rt.transport.add_worker()
            self.rt.n_workers += 1
            self.rt.reactor.n_workers += 1
            self.rt.reactor.scheduler.on_worker_change(self.rt.n_workers)
            t = threading.Thread(target=self.rt._worker_loop, args=(wid,),
                                 daemon=True)
            t.start()
            new_ids.append(wid)
        return new_ids

    def scale_down(self, wid: int) -> None:
        """Graceful retire: reassign queued tasks, then stop the thread.

        The loss is routed through the server inbox so the reactor is
        only ever mutated on the server thread (same discipline as
        ``fail_worker``)."""
        with self.rt._lock:
            pending = list(self.rt.queued.pop(wid, []))
            self.rt.dead.add(wid)
        self.rt.transport.inject(("worker-lost", wid, tuple(pending)))
        self.rt.transport.send(wid, None)
