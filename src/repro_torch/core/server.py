"""Driver-pluggable server core: the protocol state machine, written once
(a copy of :mod:`repro.core.server`).

The paper's central claim is that Dask's bottleneck is the *runtime* — the
central server's event loop and codec path — not the scheduling algorithm.
Measuring that axis needs the same protocol state machine running on
different server architectures.  This module is that split:

* :class:`ServerCore` — the single runtime-agnostic server: epoch ledger,
  graph ingestion, dependency accounting, dispatch, worker-lost / steal
  handling, release, and the stats meters.  It never touches a queue or
  a thread of a worker: all I/O goes through an abstract :class:`Driver`.
* :class:`Driver` — how work moves and workers live: poll for events,
  deliver compute messages, start/kill workers, account worker queues.
  The reference has four implementations; the port copies one,
  ``InprocDriver`` in :mod:`repro_torch.core.runtime` (thread workers
  over object queues, results straight into the core's store).  The
  reference's remote-result half of the protocol (gather and release
  frames, worker caches, p2p hints, worker usage records) serves only
  its process drivers and is not copied; it comes back with them.

Drivers hand the core *normalized events*:

==================================  =======================================
``("finished", recs, payloads)``    task completions ``[(tid, wid)]`` plus
                                    optional ``{tid: value}`` payloads
``("lost", wid, tids_or_None)``     worker death/retirement; ``None`` means
                                    "reclaim its queue snapshot yourself"
==================================  =======================================

The memory subsystem lives here on the control-plane side: every task
result sits in one :class:`repro_torch.core.store.ObjectStore`
(byte-accounted LRU with spill-to-disk), which the thread workers share
with the server.

Observability rides the same single-state-machine design: with
``events=`` set, the core publishes a typed event
(:mod:`repro_torch.core.events`) at every point the state machine mutates —
dispatch, finish, steal, worker loss, spill, epoch open/close, release,
compaction — so one instrumentation pass covers every driver.  The default (``events=None``) keeps the
hot path untouched: every publish site is a single ``is None`` check.
:meth:`ServerCore.observe` snapshots the live state for dashboards.
"""
from __future__ import annotations

import bisect
import dataclasses
import queue
import threading
import time

from repro_torch.core.events import make_bus
from repro_torch.core.graph import Task, TaskGraph
from repro_torch.core.store import ObjectStore


@dataclasses.dataclass
class EpochStats:
    """Per-epoch accounting: one record per ``submit_tasks`` call (the
    one-shot ``run()`` registers a single epoch spanning its graph)."""
    eid: int
    n_tasks: int
    t_submit: float = 0.0          # client-side submission timestamp
    t_ingest: float = 0.0          # server-side ingestion timestamp
    t_done: float = 0.0            # all tasks completed at least once
    lo: int = -1                   # global tid range [lo, hi)
    hi: int = -1
    remaining: int = -1
    server_busy0: float = 0.0      # server_busy snapshot at ingest
    server_busy1: float = 0.0      # server_busy snapshot at completion
    relay_bytes0: int = 0          # server-relayed payload-byte snapshots
    relay_bytes1: int = 0
    p2p_bytes0: int = 0            # direct worker↔worker payload bytes
    p2p_bytes1: int = 0
    spill_bytes0: int = 0          # cumulative spill-to-disk snapshots
    spill_bytes1: int = 0
    unspill_bytes0: int = 0        # cumulative unspill-from-disk snapshots
    unspill_bytes1: int = 0
    frames_sent0: int = 0          # transport-send snapshots (outbox)
    frames_sent1: int = 0
    frames_coalesced0: int = 0     # sub-frames folded into batch envelopes
    frames_coalesced1: int = 0
    dispatch_s0: float = 0.0       # cumulative _dispatch wall-time
    dispatch_s1: float = 0.0
    n_dispatched0: int = 0         # cumulative dispatched-task count
    n_dispatched1: int = 0
    error: BaseException | None = None
    done_evt: threading.Event = dataclasses.field(
        default_factory=threading.Event)

    @property
    def makespan(self) -> float:
        """Client-visible per-epoch makespan (submission to completion)."""
        return max(self.t_done - (self.t_submit or self.t_ingest), 0.0)

    @property
    def server_busy(self) -> float:
        return max(self.server_busy1 - self.server_busy0, 0.0)

    @property
    def relay_bytes(self) -> int:
        """Task payload bytes that rode through the server while this
        epoch was in flight (~0 on the p2p data plane)."""
        return max(self.relay_bytes1 - self.relay_bytes0, 0)

    @property
    def p2p_bytes(self) -> int:
        """Payload bytes moved worker-to-worker while this epoch was in
        flight (0 on the server-mediated data plane)."""
        return max(self.p2p_bytes1 - self.p2p_bytes0, 0)

    @property
    def spill_bytes(self) -> int:
        """Bytes the object stores spilled to disk while this epoch was
        in flight (0 while every live value fits under the limit)."""
        return max(self.spill_bytes1 - self.spill_bytes0, 0)

    @property
    def unspill_bytes(self) -> int:
        """Bytes read back from the spill tier while this epoch was in
        flight."""
        return max(self.unspill_bytes1 - self.unspill_bytes0, 0)

    @property
    def frames_sent(self) -> int:
        """Transport sends the driver performed while this epoch was in
        flight (batch envelopes count once — the point of coalescing)."""
        return max(self.frames_sent1 - self.frames_sent0, 0)

    @property
    def frames_coalesced(self) -> int:
        """Logical control frames that rode inside batch envelopes while
        this epoch was in flight (0 with the batching knob off)."""
        return max(self.frames_coalesced1 - self.frames_coalesced0, 0)

    @property
    def dispatch_ns_per_task(self) -> float:
        """Server-side dispatch cost per task over this epoch: wall time
        spent inside ``_dispatch`` divided by tasks handed to workers."""
        return (max(self.dispatch_s1 - self.dispatch_s0, 0.0) * 1e9
                / max(self.n_dispatched1 - self.n_dispatched0, 1))

    def as_dict(self) -> dict:
        return {"eid": self.eid, "n_tasks": self.n_tasks,
                "makespan": self.makespan,
                "server_busy": self.server_busy,
                "relay_bytes": self.relay_bytes,
                "p2p_bytes": self.p2p_bytes,
                "spill_bytes": self.spill_bytes,
                "unspill_bytes": self.unspill_bytes,
                "frames_sent": self.frames_sent,
                "frames_coalesced": self.frames_coalesced,
                "dispatch_ns_per_task": self.dispatch_ns_per_task,
                "error": repr(self.error) if self.error else None}


@dataclasses.dataclass
class RunResult:
    makespan: float
    n_tasks: int
    server_busy: float
    stats: dict
    results: dict
    timed_out: bool = False
    epochs: tuple = ()

    @property
    def aot(self) -> float:
        return self.makespan / max(self.n_tasks, 1)


def _check_epoch_deps(graph: TaskGraph, reactor, tasks) -> None:
    """Reject an epoch referencing released keys BEFORE any state is
    mutated: raising from inside ``graph.extend``/``reactor.add_tasks``
    would leave the persistent graph and reactor half-wired (tasks
    registered but never runnable, waiter refcounts pinned forever)."""
    n_known = graph.n_tasks
    for t in tasks:
        for d in t.inputs:
            d = int(d)
            if d < n_known and reactor.is_released(d):
                raise ValueError(
                    f"task {t.tid} depends on released key {d}")


class Driver:
    """Abstract execution driver: transport + worker pool + event pump.

    The default :meth:`serve` is the synchronous event loop shared by the
    blocking drivers (inproc queues, selector transports); an async driver
    overrides it and runs the same :class:`ServerCore` steps from its own
    event loop.  Everything protocol-shaped stays in the core."""

    name = "driver"
    transport_kind = "inproc"
    #: Outbox accounting (wire drivers override these as instance
    #: counters; in-process drivers have no frames to count).
    n_frames_sent = 0
    frames_coalesced = 0

    def bind(self, core: "ServerCore") -> None:
        self.core = core

    # -- lifecycle ------------------------------------------------------
    def start_workers(self) -> None:
        raise NotImplementedError

    def connect(self) -> None:
        """Finish wiring the worker channels (runs on the loop thread)."""

    def serve(self) -> None:
        core = self.core
        try:
            core._bootstrap()
            while core._loop_tick():
                core._process_events(self.poll(0.01))
        finally:
            self.finalize(core._timed_out or core._force_shutdown)

    def finalize(self, force: bool) -> None:
        """Graceful goodbye to live workers (runs in loop context)."""

    def teardown(self, force: bool) -> None:
        """Release OS resources / reap workers (runs on caller thread)."""

    # -- event plane ----------------------------------------------------
    def poll(self, timeout: float) -> list[tuple]:
        raise NotImplementedError

    def wake(self) -> None:
        """Nudge a blocked :meth:`poll` after a control submission."""

    def drain_kills(self) -> None:
        """Apply pending ``fail_worker`` requests (on the loop thread)."""

    def sweep(self) -> list[int]:
        """Workers found dead out-of-band (EOF-less deaths)."""
        return []

    def drop(self, wid: int) -> None:
        """Detach a dead worker's channel."""

    def fail_worker(self, wid: int) -> None:
        raise NotImplementedError

    # -- worker-queue accounting (container semantics are per-driver) ---
    def queue_push(self, wid: int, tid: int) -> bool:
        raise NotImplementedError

    def queue_discard(self, wid: int, tid: int) -> None:
        pass

    def queue_pop(self, wid: int) -> list[int]:
        raise NotImplementedError

    def queue_snapshot(self) -> dict[int, list[int]]:
        raise NotImplementedError

    def queue_contains(self, wid: int, tid: int) -> bool:
        raise NotImplementedError

    def retract_moves(self, moves) -> tuple[list, list]:
        """Apply steal reassignments; -> (real_moves, failed_tids)."""
        raise NotImplementedError

    # -- sends ----------------------------------------------------------
    def send_compute(self, wid: int, items) -> None:
        raise NotImplementedError

    def flush_sends(self) -> None:
        """Flush the per-worker outbox: wire drivers coalesce every frame
        queued during this poll iteration into one batch envelope per
        worker and hand them to the transport.  The core calls this at
        the end of ``_bootstrap``/``_drain_control``/``_process_events``
        so the outbox is always empty between loop iterations.
        In-process drivers send nothing — no-op."""

    # -- meters ---------------------------------------------------------
    def stats_extra(self) -> dict:
        return {}


class ServerCore:
    """The single server protocol state machine, shared by every driver.

    Engines subclass this (``ThreadRuntime`` is a thin shell choosing a
    driver and keeping its legacy surface); the server loop itself runs
    on a background thread and is the only place the reactor is mutated.
    ``p2p=True`` (worker-to-worker payloads, a process-driver data plane)
    raises ``NotImplementedError``: the port has no process runtime yet."""

    def __init__(self, graph: TaskGraph, reactor, n_workers: int,
                 driver: Driver, *, p2p: bool = False,
                 balance_interval: float = 0.05, timeout: float = 300.0,
                 memory_limit: int | None = None,
                 spill_dir: str | None = None, high_water: float = 0.8,
                 compact_threshold: int | None = 8192,
                 events=None, tracing: bool = False):
        if p2p:
            raise NotImplementedError("p2p data plane: not ported yet")
        self.g = graph
        self.reactor = reactor
        self.n_workers = n_workers
        self.driver = driver
        self.p2p = p2p
        self.balance_interval = balance_interval
        self.timeout = timeout
        # memory subsystem: every result lives in an ObjectStore, and for
        # in-process drivers this one store IS the worker store
        self.memory_limit = memory_limit
        self.spill_dir = spill_dir
        self.high_water = high_water
        self.compact_threshold = compact_threshold
        self.results: ObjectStore = ObjectStore(
            memory_limit=memory_limit, spill_dir=spill_dir, name="server")
        # observability: None (the default) keeps every publish site at
        # one attribute check — see repro_torch.core.events.  tracing=True
        # additionally asks workers for per-task timing records
        # (repro_torch.core.tracing builds spans from them); it only produces
        # events when a bus exists, so tracing without events= publishes
        # nothing and the hot path stays at the same single check.
        self.tracing = tracing
        self.n_timing = 0             # worker timing records folded
        self.events = make_bus(events)
        if self.events is not None:
            # in-process drivers share this one store with their
            # workers: stream its spill/unspill transitions directly
            # (wid=-1 = the node-level shared store)
            bus = self.events
            self.results.event_cb = (
                # ra: event-types spill,unspill
                lambda kind, tid, nb: bus.publish(kind, wid=-1,
                                                  nbytes=nb, tid=tid))
        self._finished_by_worker: dict[int, int] = {}
        self.n_steals = 0
        self.n_compactions = 0
        self.dead: set[int] = set()
        self.server_busy = 0.0
        self.dispatch_s = 0.0         # wall time inside _dispatch
        self.n_dispatched = 0         # tasks handed to workers
        self._lost_handled: set[int] = set()
        # schedule explorer hook (repro.analysis.explore): a callable
        # that may reorder/defer the control-event batch before the
        # loop consumes it.  None (the default) costs one attr check.
        self.schedule_hook = None
        self._submit_q: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._init_epochs()
        self._started = False
        self._shut = False
        self._run_to_done = False
        self._stop_requested = False
        self._force_shutdown = False
        self._timed_out = False
        self._t_deadline: float | None = None
        self._pending_run_epoch: EpochStats | None = None
        self._last_balance = 0.0
        self._server: threading.Thread | None = None
        self._loop_exited = threading.Event()
        driver.bind(self)

    # ------------------------------------------------------------------
    # epoch ledger: per-epoch completion tracking shared by all drivers.
    # Epochs are contiguous global tid ranges appended in submission
    # order; a task counts as complete on its *first* finished event, so
    # lineage re-execution after a worker loss never un-completes one.
    # ------------------------------------------------------------------

    def _init_epochs(self) -> None:
        self._epochs: list[EpochStats] = []
        self._epoch_lock = threading.Lock()
        self._completed: set[int] = set()
        self._range_los: list[int] = []      # parallel to _range_epochs
        self._range_epochs: list[EpochStats] = []

    def _register_epoch(self, n_tasks: int) -> EpochStats:
        with self._epoch_lock:
            e = EpochStats(eid=len(self._epochs), n_tasks=n_tasks,
                           t_submit=time.perf_counter())
            self._epochs.append(e)
        return e

    def _spill_totals(self) -> tuple[int, int]:
        """Current cumulative (spill_bytes, unspill_bytes) of the node's
        shared store."""
        return self.results.spill_bytes, self.results.unspill_bytes

    def _bind_epoch(self, e: EpochStats, lo: int, hi: int) -> None:
        e.lo, e.hi, e.remaining = lo, hi, hi - lo
        e.t_ingest = time.perf_counter()
        e.server_busy0 = self.server_busy
        e.spill_bytes0, e.unspill_bytes0 = self._spill_totals()
        e.frames_sent0 = self.driver.n_frames_sent
        e.frames_coalesced0 = self.driver.frames_coalesced
        e.dispatch_s0 = self.dispatch_s
        e.n_dispatched0 = self.n_dispatched
        self._range_los.append(lo)
        self._range_epochs.append(e)
        ev = self.events
        if ev is not None:
            # t_submit optional (schema-additive): the submit-side
            # perf_counter stamp prices tracing's submit->ingest segment
            ev.publish("epoch-open", eid=e.eid, n_tasks=e.n_tasks,
                       lo=lo, hi=hi, t_submit=e.t_submit)
        if e.remaining == 0:
            self._finish_epoch(e)

    def _finish_epoch(self, e: EpochStats,
                      error: BaseException | None = None) -> None:
        if e.done_evt.is_set():
            return
        e.error = e.error or error
        e.t_done = time.perf_counter()
        e.server_busy1 = self.server_busy
        e.spill_bytes1, e.unspill_bytes1 = self._spill_totals()
        e.frames_sent1 = self.driver.n_frames_sent
        e.frames_coalesced1 = self.driver.frames_coalesced
        e.dispatch_s1 = self.dispatch_s
        e.n_dispatched1 = self.n_dispatched
        ev = self.events
        if ev is not None:
            if e.t_ingest == 0.0:
                # Never ingested (quarantined before wiring, or failed
                # open at shutdown): publish the open the bind path
                # would have, with an empty tid range, so every
                # epoch-close pairs with an epoch-open.
                ev.publish("epoch-open", eid=e.eid, n_tasks=e.n_tasks,
                           lo=0, hi=0, t_submit=e.t_submit)
            ev.publish("epoch-close", eid=e.eid,
                       error=repr(e.error) if e.error else None)
        e.done_evt.set()

    def _fail_epoch(self, e: EpochStats, error: BaseException) -> None:
        self._finish_epoch(e, error=error)

    def _quarantine_epoch(self, e: EpochStats, tasks,
                          exc: BaseException) -> None:
        """Epoch ingestion failed before (or during) wiring: tids were
        already allocated client-side, so fill the range with inert
        released placeholders to keep the dense tid space aligned — one
        poisoned submission must not brick every later epoch."""
        try:
            lo = self.g.n_tasks
            if tasks and tasks[0].tid == lo:
                self.g.extend([Task(lo + i, ())
                               for i in range(len(tasks))])
                self.reactor.add_poisoned(lo, lo + len(tasks))
        except BaseException:
            pass
        self._fail_epoch(e, exc)

    def _fail_open_epochs(self, error: BaseException) -> None:
        for e in self._epochs:
            if not e.done_evt.is_set():
                self._fail_epoch(e, error)

    def _note_finished(self, tids) -> None:
        for tid in tids:
            tid = int(tid)
            if tid in self._completed or tid < self.g.tid_base:
                continue
            self._completed.add(tid)
            i = bisect.bisect_right(self._range_los, tid) - 1
            if i < 0:
                continue
            e = self._range_epochs[i]
            if tid < e.hi:
                e.remaining -= 1
                if e.remaining <= 0:
                    self._finish_epoch(e)

    # public epoch surface (used by the Cluster/Client layer) ----------
    def wait_epoch(self, eid: int, timeout: float | None = None) -> bool:
        return self._epochs[eid].done_evt.wait(timeout)

    def epoch(self, eid: int) -> EpochStats:
        return self._epochs[eid]

    def epoch_dicts(self) -> tuple:
        return tuple(e.as_dict() for e in self._epochs)

    # ------------------------------------------------------------------
    # timing helpers
    # ------------------------------------------------------------------

    def _charge(self, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.server_busy += time.perf_counter() - t0
        return out

    # ------------------------------------------------------------------
    # persistent submission surface (thread-safe; work lands on the loop)
    # ------------------------------------------------------------------

    def submit_tasks(self, tasks, retain: bool = True) -> int:
        """Submit a new graph epoch to the running server loop.  Tasks
        must carry dense global tids continuing from the current graph;
        inputs may reference any earlier tid.  Returns the epoch id."""
        if not self._started or self._shut or self._loop_exited.is_set():
            raise RuntimeError("runtime is not running (start() first)")
        e = self._register_epoch(len(tasks))
        self._submit_q.put(("epoch", e.eid, list(tasks), retain))
        self.driver.wake()
        return e.eid

    def release_tasks(self, tids) -> None:
        """Drop the client hold on ``tids``; released values are purged
        from ``self.results`` on the server loop."""
        self._submit_q.put(("release", [int(t) for t in tids]))
        self.driver.wake()

    def fetch(self, tids, timeout: float | None = None) -> bool:
        """Ensure ``tids`` results are present server-side.  In-process
        drivers hold results directly: nothing to fetch (the reference's
        gather over wire frames serves its process drivers)."""
        return True

    def fail_worker(self, wid: int) -> None:
        """First-class failure injection, driver-flavored: thread workers
        are marked dead and their queue is routed through the loop as a
        worker-lost event; process workers are SIGKILLed."""
        self.driver.fail_worker(wid)

    # ------------------------------------------------------------------
    # protocol: ingestion / release
    # ------------------------------------------------------------------

    def _ingest_epoch(self, eid: int, tasks, retain: bool) -> None:
        e = self._epochs[eid]
        try:
            _check_epoch_deps(self.g, self.reactor, tasks)
            lo, hi = self.g.extend(tasks)
            out = self._charge(self.reactor.add_tasks, lo, hi, retain)
            self._bind_epoch(e, lo, hi)
            self._dispatch(out)
        except BaseException as exc:   # surface to the waiting Future
            self._quarantine_epoch(e, tasks, exc)

    def _do_release(self, tids) -> None:
        released = self._charge(self.reactor.release_keys, tids)
        ev = self.events
        if ev is not None and released:
            # tids is optional (schema-additive): the conformance
            # checker reads it
            ev.publish("release", n=len(released),
                       tids=[int(t) for t in released])
        for tid in released:
            self.results.discard(tid)
        # drain the reclaim log (it contains ``released``) so the same
        # keys are not evicted a second time by the loop's drain
        self._evict_workers(self.reactor.drain_reclaimed())
        self._maybe_compact()

    def _evict_workers(self, reclaimed) -> None:
        """Drop every reclaimed key from the store the thread workers
        share, under a memory limit (bounded footprint); unlimited runs
        keep every value, preserving the legacy one-shot
        ``RunResult.results`` surface."""
        if self.memory_limit is not None:
            for tid in reclaimed:
                self.results.discard(tid)

    # ------------------------------------------------------------------
    # protocol: worker timing records
    # ------------------------------------------------------------------

    def _note_timing(self, wid: int, records) -> None:
        """Fold a worker's piggybacked per-task timing records into the
        event feed (``task-timing``; worker-clock ``perf_counter_ns``
        values converted to float seconds).  Records ride the finished
        frame that reported the tasks and are published as that frame is
        processed, so a ``task-timing`` always precedes its task's
        ``task-finished`` in seq order — :mod:`repro_torch.core.tracing`
        aligns the worker clock and assembles the spans offline."""
        if not records:
            return
        self.n_timing += len(records)
        ev = self.events
        if ev is None:
            return
        for tid, recv, start, end, fetch in records:
            ev.publish("task-timing", tid=int(tid), wid=wid,
                       recv=recv / 1e9, start=start / 1e9,
                       end=end / 1e9, fetch=fetch / 1e9)

    # ------------------------------------------------------------------
    # protocol: dispatch
    # ------------------------------------------------------------------

    def _send_compute(self, wid: int, items) -> None:
        ev = self.events
        if ev is not None:
            # published BEFORE the send so an inproc worker's
            # task-started always carries a later seq than its dispatch
            for tid, _ in items:
                ev.publish("task-dispatched", tid=int(tid), wid=wid)
        self.driver.send_compute(wid, items)

    def _dispatch(self, assignments) -> None:
        """Queue-account and send compute batches; reroutes assignments
        that hit a dead worker (may cascade through handle_worker_lost)."""
        pending = list(assignments)
        if not pending:
            return
        t0 = time.perf_counter()
        # hot path: hoist lookups out of the per-task loop — this runs
        # once per dispatched task, the per-task cost the paper measures
        dead = self.dead
        queue_push = self.driver.queue_push
        while pending:
            durations = self.g.durations
            base = self.g.tid_base
            rerouted: list = []
            by_wid: dict[int, list] = {}
            ev = self.events
            for tid, wid in pending:
                if wid in dead or not queue_push(wid, int(tid)):
                    out = self._charge(self.reactor.handle_worker_lost,
                                       wid, [tid])
                    rerouted.extend(out)
                    continue
                if ev is not None:
                    if self.tracing:
                        # deps optional (schema-additive, tracing only):
                        # lets critical-path extraction run offline from
                        # the log alone
                        ev.publish("task-queued", tid=int(tid), wid=wid,
                                   deps=[int(d) for d
                                         in self.g.inputs_of(tid)])
                    else:
                        ev.publish("task-queued", tid=int(tid), wid=wid)
                by_wid.setdefault(wid, []).append(
                    (int(tid), float(durations[tid - base])))
            for wid, items in by_wid.items():
                self._send_compute(wid, items)
                self.n_dispatched += len(items)
            pending = rerouted
        self.dispatch_s += time.perf_counter() - t0

    # ------------------------------------------------------------------
    # protocol: worker loss and stealing
    # ------------------------------------------------------------------

    def _worker_lost(self, wid: int, lost=None) -> None:
        first = wid not in self._lost_handled
        if first:
            self._lost_handled.add(wid)
            self.dead.add(wid)
            ev = self.events
            if ev is not None:
                # n_lost=-1: queue snapshot reclaimed below / by caller
                ev.publish("worker-lost", wid=wid,
                           n_lost=len(lost) if lost is not None else -1)
            self.driver.drop(wid)
            if len(self.dead) >= self.n_workers and self._run_to_done:
                # no capacity left to resubmit onto: a one-shot run
                # cannot wait for one, so the run cannot finish.  A
                # *persistent* thread pool CAN be scaled back up
                # (ElasticController), so its loop survives a
                # momentarily-empty pool.
                self._timed_out = True
                return
            if lost is None:
                lost = self.driver.queue_pop(wid)
        elif lost is None:
            return
        out = self._charge(self.reactor.handle_worker_lost, wid,
                           sorted(int(t) for t in lost))
        self._dispatch(out)

    def _apply_moves(self, moves) -> list[tuple[int, int]]:
        """Apply steal reassignments: retract each task from its source
        (definitive under the inproc driver's lock), report failed retractions back to
        the reactor so scheduler load bookkeeping stays balanced, and
        dispatch the survivors."""
        real_moves, failed = self.driver.retract_moves(moves)
        for tid in failed:
            self.reactor.steal_failed(tid)
        self.n_steals += len(real_moves)
        ev = self.events
        if ev is not None:
            for tid, wid in real_moves:
                ev.publish("task-steal", tid=int(tid), wid=wid)
            for tid in failed:
                ev.publish("steal-failed", tid=int(tid))
        self._dispatch(real_moves)
        return real_moves

    def _do_balance(self) -> None:
        qbw = self.driver.queue_snapshot()
        if not qbw:
            return
        moves = self._charge(self.reactor.rebalance, qbw)
        self._apply_moves(moves)

    # ------------------------------------------------------------------
    # the server loop (driven by Driver.serve)
    # ------------------------------------------------------------------

    def _bootstrap(self) -> None:
        self.driver.connect()
        ev = self.events
        if ev is not None:
            for wid in range(self.n_workers):
                ev.publish("worker-join", wid=wid)
        if self._run_to_done:
            self._t_deadline = time.perf_counter() + self.timeout
        init = self._charge(self.reactor.start)
        e = self._pending_run_epoch
        if e is not None:
            self._pending_run_epoch = None
            self._bind_epoch(e, 0, self.g.n_tasks)
        self._last_balance = time.perf_counter()
        self._dispatch(init)
        self.driver.flush_sends()

    def _loop_tick(self) -> bool:
        """Once per iteration, before polling: stop/timeout/done checks
        plus the control plane (epoch/release submissions, kill
        requests).  False exits the loop."""
        if self._stop_requested or self._timed_out:
            return False
        if self._run_to_done and self.reactor.done():
            return False
        if self._t_deadline is not None \
                and time.perf_counter() > self._t_deadline:
            self._timed_out = True
            return False
        self._drain_control()
        return not (self._stop_requested or self._timed_out)

    def _drain_control(self) -> None:
        while True:
            try:
                item = self._submit_q.get_nowait()
            except queue.Empty:
                break
            kind = item[0]
            if kind == "epoch":
                self._ingest_epoch(item[1], item[2], item[3])
            elif kind == "release":
                self._do_release(item[1])
            elif kind == "stop":
                self._stop_requested = True
        self.driver.drain_kills()
        self.driver.flush_sends()

    def _process_events(self, events) -> None:
        hook = self.schedule_hook
        if hook is not None:
            events = hook(events)
        finished: list[tuple[int, int]] = []
        for ev in events:
            kind = ev[0]
            if kind == "finished":
                for tid, rw in ev[1]:
                    finished.append((int(tid), int(rw)))
                    self.driver.queue_discard(int(rw), int(tid))
                if ev[2]:
                    self.results.update(ev[2])
            elif kind == "lost":
                self._worker_lost(ev[1], ev[2])
        if finished:
            self._handle_finished(finished)
        now = time.perf_counter()
        if now - self._last_balance > self.balance_interval:
            self._last_balance = now
            for wid in self.driver.sweep():
                self._worker_lost(wid)
            self._do_balance()
        self.driver.flush_sends()

    def _handle_finished(self, finished) -> None:
        ev = self.events
        for tid, wid in finished:
            # same site as the per-worker counter so replayed event
            # streams agree with RunResult.stats["tasks_per_worker"]
            self._finished_by_worker[wid] = \
                self._finished_by_worker.get(wid, 0) + 1
            if ev is not None:
                ev.publish("task-finished", tid=tid, wid=wid)
        out = self._charge(self.reactor.handle_finished, finished)
        self._dispatch(out)
        for tid in self.reactor.drain_purged():
            self.results.discard(tid)
        self._evict_workers(self.reactor.drain_reclaimed())
        self._note_finished(t for t, _ in finished)
        self._maybe_compact()

    # ------------------------------------------------------------------
    # released-tid prefix compaction (bounded footprint for long-lived
    # clusters: the dense tid space advances instead of growing forever)
    # ------------------------------------------------------------------

    def _maybe_compact(self) -> None:
        """Advance the tid base past a fully-released prefix once it is
        ``compact_threshold`` rows deep: graph columns, reactor state and
        every core ledger drop those rows for good.  Compaction finalizes
        the releases — lineage below the base is unrecoverable (the same
        trade Dask makes when it forgets a released key)."""
        thr = self.compact_threshold
        if not thr:
            return
        if not getattr(self.reactor.scheduler, "supports_compaction",
                       True):
            return    # precomputed-plan schedulers index from tid 0
        new_base = self.reactor.released_prefix()
        if new_base - self.g.tid_base < thr:
            return
        self._charge(self._compact_to, new_base)

    def _compact_to(self, new_base: int) -> None:
        self.g.compact_prefix(new_base)
        self.reactor.compact_prefix(new_base)
        self._completed = {t for t in self._completed if t >= new_base}
        # drop finished epoch ranges that sit entirely below the base
        # (the EpochStats objects stay reachable via epoch(eid))
        while self._range_epochs and self._range_epochs[0].hi <= new_base \
                and self._range_epochs[0].done_evt.is_set():
            self._range_los.pop(0)
            self._range_epochs.pop(0)
        self.n_compactions += 1
        ev = self.events
        if ev is not None:
            ev.publish("compact", base=new_base)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def _serve(self) -> None:
        try:
            self.driver.serve()
        except BaseException as exc:
            # bootstrap/loop failures must reach the waiting futures as
            # the REAL exception, not a causeless "server loop exited"
            self._fail_open_epochs(exc)
            raise
        finally:
            self._fail_open_epochs(
                TimeoutError("server loop exited")
                if self._timed_out else
                RuntimeError("server loop exited"))
            self._loop_exited.set()

    def start(self):
        """Bring up the persistent worker pool + server loop (no graph
        required yet; epochs arrive via :meth:`submit_tasks`)."""
        if self._started:
            return self
        self._started = True
        self.driver.start_workers()
        self._server = threading.Thread(target=self._serve, daemon=True)
        self._server.start()
        return self

    def shutdown(self, force: bool = False, timeout: float = 10.0) -> None:
        """Stop the server loop and retire the workers (``force`` skips
        the graceful drain; threads are daemonic and park on their
        queues)."""
        if not self._started or self._shut:
            return
        self._shut = True
        if force:
            self._force_shutdown = True
        self._stop_requested = True
        self.driver.wake()
        if self._server is not None:
            self._server.join(timeout=timeout)
            if self._server.is_alive():
                force = True
        self.driver.teardown(force=force)
        if self.events is not None:
            self.events.close()     # flush sinks; ring stays readable

    def run(self) -> RunResult:
        """One-shot run over the pre-loaded graph: start -> one epoch ->
        run to completion -> tear the pool down."""
        self._run_to_done = True
        e = self._register_epoch(self.g.n_tasks)
        self._pending_run_epoch = e
        t_start = time.perf_counter()
        self.start()
        self._loop_exited.wait(self.timeout + 30.0)
        makespan = time.perf_counter() - t_start
        self.driver.teardown(force=self._timed_out)
        if self.events is not None:
            self.events.close()
        # materialize to a plain dict (unspilling anything the bounded
        # store pushed to disk): the legacy one-shot surface is eager
        return RunResult(makespan=makespan, n_tasks=self.g.n_tasks,
                         server_busy=self.server_busy,
                         stats=self.run_stats(),
                         results=dict(self.results.items()),
                         timed_out=self._timed_out,
                         epochs=self.epoch_dicts())

    def run_stats(self) -> dict:
        """Reactor stats plus the driver's meters plus the memory
        subsystem's meters plus the observability counters (see
        ``docs/meters.md`` for the authoritative key table)."""
        stats = self.reactor.stats.as_dict()
        stats.update(self.driver.stats_extra())
        stats.update(self.memory_stats())
        stats["n_steals"] = self.n_steals
        stats["tasks_per_worker"] = dict(self._finished_by_worker)
        stats["n_events"] = (self.events.n_published
                             if self.events is not None else 0)
        stats["dispatch_ns_per_task"] = round(
            self.dispatch_s * 1e9 / max(self.n_dispatched, 1), 1)
        stats["n_timing"] = self.n_timing
        return stats

    def observe(self) -> dict:
        """Best-effort live snapshot for dashboards (no lock on the
        server loop: counters are read racily, which is fine for a
        display refreshed a few times per second).  Works with or
        without an event bus."""
        try:
            queues = {int(w): len(ts) for w, ts in
                      self.driver.queue_snapshot().items()}
        except Exception:
            queues = {}     # driver mid-teardown / snapshot racing
        with self._epoch_lock:
            epochs = list(self._epochs)
        open_eids = [e.eid for e in epochs if not e.done_evt.is_set()]
        spill_b, unspill_b = self._spill_totals()
        ev = self.events
        return {
            "t": time.perf_counter(),
            "driver": self.driver.name,
            "n_workers": self.n_workers,
            "dead": sorted(self.dead),
            "queues": queues,
            "tasks_per_worker": dict(self._finished_by_worker),
            "n_finished": sum(self._finished_by_worker.values()),
            "n_steals": self.n_steals,
            "n_frames_sent": self.driver.n_frames_sent,
            "frames_coalesced": self.driver.frames_coalesced,
            "dispatch_ns_per_task": (self.dispatch_s * 1e9
                                     / max(self.n_dispatched, 1)),
            "memory_limit": self.memory_limit,
            "spill_bytes": spill_b,
            "unspill_bytes": unspill_b,
            "server_busy": self.server_busy,
            "n_epochs": len(epochs),
            "open_epochs": open_eids,
            "tid_base": self.g.tid_base,
            "n_events": ev.n_published if ev is not None else 0,
            "event_counts": dict(ev.counts) if ev is not None else {},
            "last_events": ev.tail(20) if ev is not None else [],
        }

    def memory_stats(self) -> dict:
        """Object-store meters of the store the thread workers share."""
        st = self.results
        spill_b, unspill_b = self._spill_totals()
        return {"memory_limit": self.memory_limit,
                "peak_worker_bytes": st.peak_bytes,
                "spill_bytes": spill_b,
                "unspill_bytes": unspill_b,
                "spill_count": st.spill_count,
                "unspill_count": st.unspill_count,
                "n_compactions": self.n_compactions,
                "tid_base": self.g.tid_base}
