"""Fault tolerance & elasticity utilities around the core runtime (a
copy of :mod:`repro.ft.faults` on :mod:`repro_torch.core`).

The paper's runtime already gives us the primitives (task resubmission via
``handle_worker_lost``, lineage recompute, scheduler worker-removal); this
module adds policies on top:

  * an elastic controller that grows/shrinks the worker pool,
  * deterministic failure-injection schedules for tests/benchmarks.

Not copied: the reference's ``HeartbeatMonitor`` and
``StragglerMitigator``, which nothing in the port uses.
"""
from __future__ import annotations

import dataclasses
import threading


@dataclasses.dataclass
class FailurePlan:
    """Deterministic injection schedule: [(virtual_or_wall_time, wid)]."""
    events: tuple = ()

    def for_simulator(self):
        return tuple(self.events)

    def apply_wallclock(self, runtime) -> list[threading.Timer]:
        """Arm the schedule against a wall-clock runtime.

        On a ThreadRuntime, ``fail_worker`` routes a worker-lost event
        through the server inbox and the server resubmits the worker's
        outstanding tasks.  Call before ``runtime.run()``; returns the
        timers (cancel to abort)."""
        timers = []
        for delay, wid in self.events:
            t = threading.Timer(delay, runtime.fail_worker, args=(wid,))
            t.daemon = True
            t.start()
            timers.append(t)
        return timers


def kill_worker_after(runtime, wid: int, delay: float) -> threading.Timer:
    """One-shot thread worker kill (first-class failure injection for
    tests and benchmarks)."""
    (t,) = FailurePlan(((delay, wid),)).apply_wallclock(runtime)
    return t


class ElasticController:
    """Grows/shrinks a ThreadRuntime's worker pool at runtime.  Growth
    spawns a worker thread and notifies the scheduler; shrink retires the
    worker gracefully (its queue is rebalanced, not lost).

    Thread runtime only, as in the reference: a runtime without an
    in-process transport raises immediately instead of failing at
    scale-up time."""

    def __init__(self, runtime):
        # accept a Cluster (unwrap to its runtime) or a runtime directly
        runtime = getattr(runtime, "runtime", runtime)
        if not hasattr(runtime, "transport") \
                or not hasattr(runtime.transport, "add_worker"):
            raise NotImplementedError(
                "ElasticController supports thread runtimes only; "
                f"{type(runtime).__name__} workers cannot be scaled "
                "in-place")
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
