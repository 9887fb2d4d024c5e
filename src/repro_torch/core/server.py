"""Driver-pluggable server core: the protocol state machine, written once
(a copy of :mod:`repro.core.server`).

The paper's central claim is that Dask's bottleneck is the *runtime* — the
central server's event loop and codec path — not the scheduling algorithm.
Measuring that axis needs the same protocol state machine running on
different server architectures.  This module is that split:

* :class:`ServerCore` — the single runtime-agnostic server: epoch ledger,
  graph ingestion, dependency accounting, dispatch and who_has hint
  computation, worker-lost / fetch-failed / steal handling, gather and
  release, and the stats meters.  It never touches a socket, pipe, queue
  or process: all I/O goes through an abstract :class:`Driver`.
* :class:`Driver` — how bytes move and workers live: poll for events,
  deliver compute/control messages, spawn/kill workers, account worker
  queues.  Four implementations live in :mod:`repro_torch.core.runtime`:
  ``InprocDriver`` (thread workers over object queues), ``SelectorDriver``
  (OS-process workers behind a blocking-selector loop — Dask's shape),
  ``AsyncioDriver`` (the same workers served by an asyncio event loop)
  and ``UvloopDriver`` (asyncio on a uvloop policy when installed), so
  the server-architecture axis is selectable per run while every driver
  consults this one state machine.

Drivers hand the core *normalized events*:

==================================  =======================================
``("finished", recs, payloads)``    task completions ``[(tid, wid)]`` plus
                                    optional ``{tid: value}`` payloads
``("lost", wid, tids_or_None)``     worker death/retirement; ``None`` means
                                    "reclaim its queue snapshot yourself"
``("gather-reply", wid, a, p)``     gather answer: absent keys + payloads
``("fetch-failed", wid, recs)``     tasks whose dependency fetch failed
``("data-addr", wid, addr)``        a worker's data-plane listener address
``("stats", recs)``                 p2p transfer-byte deltas
``("usage", wid, usage)``           a worker's object-store usage record
                                    (``repro_torch.core.store.USAGE_FIELDS``)
==================================  =======================================

The memory subsystem lives here on the control-plane side: every task
result — server-side and worker-side — sits in a
:class:`repro_torch.core.store.ObjectStore` (byte-accounted LRU with
spill-to-disk), workers piggyback usage records on finished/stats
frames (``repro_torch.core.store.USAGE_FIELDS`` 6-tuples), and the core keeps
per-worker memory ledgers that feed dispatch hinting (prefer
pressure-free holders) and the schedulers' steal-target choice (never
steal onto a worker above the high-water mark).

Observability rides the same single-state-machine design: with
``events=`` set, the core publishes a typed event
(:mod:`repro_torch.core.events`) at every point the state machine mutates —
dispatch, finish, steal, rehint, worker loss, memory pressure, spill,
epoch open/close, gather, release, compaction — so one instrumentation
pass covers all four drivers.  The default (``events=None``) keeps the
hot path untouched: every publish site is a single ``is None`` check.
:meth:`ServerCore.observe` snapshots the live state for dashboards.
"""
from __future__ import annotations

import bisect
import dataclasses
import queue
import threading
import time
from typing import Any

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
    #: True when results live in worker caches behind a byte wire (the
    #: gather/update-graph/release half of the protocol is active).
    remote_results = False
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
    def send_compute(self, wid: int, items, data=None, deps=None,
                     hints=None) -> None:
        raise NotImplementedError

    def send_retract(self, wid: int, tids) -> None:
        pass

    def send_release(self, wid: int, tids) -> None:
        pass

    def send_gather(self, wid: int, tids) -> None:
        pass

    def flush_sends(self) -> None:
        """Flush the per-worker outbox: wire drivers coalesce every frame
        queued during this poll iteration into one batch envelope per
        worker and hand them to the transport.  The core calls this at
        the end of ``_bootstrap``/``_drain_control``/``_process_events``
        so the outbox is always empty between loop iterations.
        In-process drivers send nothing — no-op."""

    def broadcast_compact(self, base: int) -> None:
        """Tell live workers the tid prefix below ``base`` is compacted
        for good (they drop task-table/store rows).  In-process drivers
        share the server's structures — nothing to send."""

    def prepare_epoch(self, tasks):
        """Encode an epoch for live workers (may raise, e.g. unpicklable
        callables — BEFORE any core state is mutated)."""
        return None

    def broadcast_epoch(self, prepared) -> None:
        pass

    # -- meters ---------------------------------------------------------
    def take_payload_bytes(self) -> int:
        return 0

    def take_gather_bytes(self) -> int:
        return 0

    def stats_extra(self) -> dict:
        return {}


class ServerCore:
    """The single server protocol state machine, shared by every driver.

    Engines subclass this (``ThreadRuntime``/``ProcessRuntime`` are thin
    shells choosing a driver and keeping their legacy surface); the
    server loop itself runs on a background thread — or inside the
    driver's own event loop — and is the only place the reactor is
    mutated."""

    def __init__(self, graph: TaskGraph, reactor, n_workers: int,
                 driver: Driver, *, p2p: bool = False,
                 balance_interval: float = 0.05, timeout: float = 300.0,
                 memory_limit: int | None = None,
                 spill_dir: str | None = None, high_water: float = 0.8,
                 compact_threshold: int | None = 8192,
                 events=None, tracing: bool = False):
        self.g = graph
        self.reactor = reactor
        self.n_workers = n_workers
        self.driver = driver
        self.p2p = p2p
        self.balance_interval = balance_interval
        self.timeout = timeout
        # memory subsystem: every result lives in an ObjectStore.  For
        # in-process drivers this one store IS the worker store, so the
        # limit applies here; remote-result drivers enforce the limit in
        # each worker process and keep the client-facing store unbounded
        self.memory_limit = memory_limit
        self.spill_dir = spill_dir
        self.high_water = high_water
        self.compact_threshold = compact_threshold
        limit_here = None if driver.remote_results else memory_limit
        self.results: ObjectStore = ObjectStore(
            memory_limit=limit_here, spill_dir=spill_dir, name="server")
        # observability: None (the default) keeps every publish site at
        # one attribute check — see repro_torch.core.events.  tracing=True
        # additionally asks workers for per-task timing records
        # (repro_torch.core.tracing builds spans from them); it only produces
        # events when a bus exists, so tracing without events= publishes
        # nothing and the hot path stays at the same single check.
        self.tracing = tracing
        self.n_timing = 0             # worker timing records folded
        self.events = make_bus(events)
        if self.events is not None and not driver.remote_results:
            # in-process drivers share this one store with their
            # workers: stream its spill/unspill transitions directly
            # (wid=-1 = the node-level shared store).  Remote drivers
            # derive the same events from piggybacked usage deltas.
            bus = self.events
            self.results.event_cb = (
                # ra: event-types spill,unspill
                lambda kind, tid, nb: bus.publish(kind, wid=-1,
                                                  nbytes=nb, tid=tid))
        self._finished_by_worker: dict[int, int] = {}
        self.n_steals = 0
        # per-worker memory ledgers (fed by piggybacked usage records)
        self.worker_mem: dict[int, int] = {}
        self.mem_pressured: set[int] = set()
        self.peak_worker_bytes = 0
        self._w_spill_b: dict[int, int] = {}
        self._w_unspill_b: dict[int, int] = {}
        self._w_spill_c: dict[int, int] = {}
        self._w_unspill_c: dict[int, int] = {}
        self.n_compactions = 0
        self.dead: set[int] = set()
        self.server_busy = 0.0
        self.codec_s = 0.0
        self.dispatch_s = 0.0         # wall time inside _dispatch
        self.n_dispatched = 0         # tasks handed to workers
        self.wire_bytes = 0
        self.wire_frames = 0
        self.relay_bytes = 0          # payload bytes relayed via server
        self.p2p_bytes = 0            # payload bytes moved peer-to-peer
        self.gather_bytes = 0         # client-facing gather-reply bytes
        self.n_p2p_fetches = 0
        self.n_rehints = 0            # proactive who_has rewrites on loss
        self._data_addrs: dict[int, tuple] = {}    # wid -> (host, port)
        # wid sets that hold fetched COPIES of a key (beyond the
        # reactor's holders): release frames must reach these too
        self._replicas: dict[int, set[int]] = {}
        # in-flight gathers: tid -> {"wid": current target, "tried": set}
        self._gather_state: dict[int, dict] = {}
        self._gather_failed: set[int] = set()
        # tasks a worker handed back because a dependency fetch failed:
        # tid -> {"wid": assigned worker, "missing": set, "tried": dict}
        self._parked: dict[int, dict] = {}
        self._park_dirty = False
        # hints in the last compute frame: tid -> (owner, {dep: holder})
        self._hinted: dict[int, tuple[int, dict[int, int]]] = {}
        self._lost_handled: set[int] = set()
        # schedule explorer hook (repro.analysis.explore): a callable
        # that may reorder/defer the control-event batch before the
        # loop consumes it.  None (the default) costs one attr check.
        self.schedule_hook = None
        self._tasks_table: dict[int, tuple] = {}
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
        self._collect_req = False
        self._collect_want: list[int] = []
        self._collect_deadline: float | None = None
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
        """Current cumulative (spill_bytes, unspill_bytes) across the
        node: the shared store for in-process drivers, the per-worker
        ledgers for remote-result drivers."""
        if not self.driver.remote_results:
            return self.results.spill_bytes, self.results.unspill_bytes
        return (sum(self._w_spill_b.values()),
                sum(self._w_unspill_b.values()))

    def _bind_epoch(self, e: EpochStats, lo: int, hi: int) -> None:
        e.lo, e.hi, e.remaining = lo, hi, hi - lo
        e.t_ingest = time.perf_counter()
        e.server_busy0 = self.server_busy
        e.relay_bytes0 = self.relay_bytes
        e.p2p_bytes0 = self.p2p_bytes
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
        e.relay_bytes1 = self.relay_bytes
        e.p2p_bytes1 = self.p2p_bytes
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

    def _charge_codec(self, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        dt = time.perf_counter() - t0
        self.codec_s += dt
        self.server_busy += dt
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
        """Ensure ``tids`` results are present server-side, re-fetching
        worker-cached values over ``gather`` wire frames if needed.
        In-process drivers hold results directly — nothing to fetch.
        ``timeout=None`` waits up to the runtime's own timeout (a busy
        single-threaded holder answers gathers only between tasks);
        definitively-absent keys still fail fast — False returns before
        the deadline once every holder answered absent or died."""
        if not self.driver.remote_results:
            return True
        if timeout is None:
            timeout = self.timeout
        missing = [int(t) for t in tids if int(t) not in self.results]
        if not missing:
            return True
        # stale failure markers from an earlier fetch must not fail this
        # one before the server even processes it.  The loop's fresh
        # _do_gather discards them; until it has run (ack set) the
        # markers are ignored here rather than cleared from this thread
        # (_gather_failed is loop-owned — a client-side clear races the
        # loop's rebind of the set during tid compaction)
        ack = threading.Event()
        self._submit_q.put(("gather", missing, ack))
        self.driver.wake()
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            if all(t in self.results for t in missing):
                return True
            if ack.is_set() and \
                    any(t in self._gather_failed and t not in self.results
                        for t in missing):
                return False
            if self._loop_exited.is_set():
                break
            time.sleep(0.002)
        return all(t in self.results for t in missing)

    def fail_worker(self, wid: int) -> None:
        """First-class failure injection, driver-flavored: thread workers
        are marked dead and their queue is routed through the loop as a
        worker-lost event; process workers are SIGKILLed."""
        self.driver.fail_worker(wid)

    # ------------------------------------------------------------------
    # protocol: ingestion / release / gather
    # ------------------------------------------------------------------

    def _ingest_epoch(self, eid: int, tasks, retain: bool) -> None:
        e = self._epochs[eid]
        try:
            _check_epoch_deps(self.g, self.reactor, tasks)
            # encode BEFORE any state mutation — an unpicklable callable
            # must fail the epoch, not desync graph and reactor
            prepared = self.driver.prepare_epoch(tasks)
            lo, hi = self.g.extend(tasks)
            if prepared is not None:
                self.driver.broadcast_epoch(prepared)
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
            # checker uses it to prove gathers never target these keys
            ev.publish("release", n=len(released),
                       tids=[int(t) for t in released])
        for tid in released:
            self.results.discard(tid)
        # drain the reclaim log (it contains ``released``) so the same
        # keys are not evicted a second time by the loop's drain
        self._evict_workers(self.reactor.drain_reclaimed())
        self._maybe_compact()

    def _evict_workers(self, reclaimed) -> None:
        """Release frames for every reclaimed key to every worker that
        holds a copy (computing holder AND fetch replicas), so a
        long-lived pool sheds values nobody can ask for again.  Inproc
        drivers share one store with their workers: under a memory
        limit the reclaim log evicts it directly (bounded footprint);
        unlimited in-process runs keep every value, preserving the
        legacy one-shot ``RunResult.results`` surface."""
        if not self.driver.remote_results:
            if self.memory_limit is not None:
                for tid in reclaimed:
                    self.results.discard(tid)
            return
        by_wid: dict[int, list[int]] = {}
        for tid in reclaimed:
            tid = int(tid)
            for wid in self._holders(tid):
                if wid not in self.dead:
                    by_wid.setdefault(wid, []).append(tid)
            self._replicas.pop(tid, None)
            self._gather_state.pop(tid, None)
            self._gather_failed.discard(tid)
        for wid, ts in by_wid.items():
            self.driver.send_release(wid, ts)

    def _holders(self, tid: int) -> list[int]:
        """Workers believed to hold ``tid``'s value: the reactor's
        completion holders plus fetch-replicas inferred from finished
        tasks that consumed it."""
        hs = [int(w) for w in self.reactor.holders_of(tid)]
        for w in self._replicas.get(int(tid), ()):
            if w not in hs:
                hs.append(w)
        return hs

    def _do_gather(self, tids, fresh: bool = True) -> None:
        """Ask a live holder for each missing result.  ``fresh`` resets
        the tried-holder memory (a new client fetch); re-issues after an
        absent reply or a holder death keep it, so every holder is tried
        at most once before the gather fails fast."""
        by_wid: dict[int, list[int]] = {}
        for tid in tids:
            tid = int(tid)
            if tid in self.results:
                self._gather_state.pop(tid, None)
                continue
            st = self._gather_state.get(tid)
            if st is None or fresh:
                st = self._gather_state[tid] = {"wid": -1, "tried": set()}
                self._gather_failed.discard(tid)
            wid = next((w for w in self._holders(tid)
                        if w not in self.dead and w not in st["tried"]),
                       None)
            if wid is None:
                if not self.reactor.all_done_in(tid, tid + 1):
                    # lineage re-execution is rematerializing the value
                    # (holder died): keep the gather pending; it is
                    # re-issued when the task re-finishes
                    st["wid"] = -1
                    continue
                # done but absent on every holder (never cached /
                # evicted): fail fast instead of letting the client
                # spin out its whole timeout
                self._gather_state.pop(tid, None)
                self._gather_failed.add(tid)
                continue
            st["wid"] = wid
            st["tried"].add(wid)
            by_wid.setdefault(wid, []).append(tid)
        ev = self.events
        for wid, ts in by_wid.items():
            if ev is not None:
                # tids optional (schema-additive), keys gather targets
                ev.publish("gather", wid=wid, n=len(ts),
                           tids=[int(t) for t in ts])
            self.driver.send_gather(wid, ts)

    def _on_gather_reply(self, wid: int, absent, payloads) -> None:
        """Gather replies are explicit frames — they never re-enter the
        finished path, so completion/epoch accounting cannot be double
        counted by a re-sent result."""
        ev = self.events
        if ev is not None:
            ev.publish("gather-reply", wid=wid,
                       n_present=len(payloads) if payloads else 0,
                       n_absent=len(absent) if absent else 0)
        if payloads:
            self.results.update(payloads)
            for tid in payloads:
                self._gather_state.pop(int(tid), None)
                self._gather_failed.discard(int(tid))
            self._park_dirty = True
        if absent:
            # the holder no longer has it (evicted/restarted): re-route
            # to the next untried holder or fail fast
            self._do_gather([int(t) for t in absent], fresh=False)

    # ------------------------------------------------------------------
    # protocol: per-worker memory ledger
    # ------------------------------------------------------------------

    def _note_usage(self, wid: int, usage) -> None:
        """Fold a worker's piggybacked object-store usage record into
        the memory ledger; high-water transitions are fed to the
        scheduler so stealing stops targeting pressured workers."""
        if wid in self.dead:
            return
        mem, peak, sb, ub, sc, uc = (int(x) for x in usage)
        ev = self.events
        if ev is not None and self.driver.remote_results:
            # usage records are cumulative per worker: publish the
            # deltas, so summing spill/unspill events over a replayed
            # log reproduces _spill_totals() exactly (the ledgers are
            # retained for dead workers for the same reason)
            d_sb = sb - self._w_spill_b.get(wid, 0)
            d_ub = ub - self._w_unspill_b.get(wid, 0)
            if d_sb > 0:
                ev.publish("spill", wid=wid, nbytes=d_sb)
            if d_ub > 0:
                ev.publish("unspill", wid=wid, nbytes=d_ub)
        self.worker_mem[wid] = mem
        # the worker reports its own store-tracked peak, so transient
        # put-then-evict spikes between flushes are not lost
        if peak > self.peak_worker_bytes:
            self.peak_worker_bytes = peak
        self._w_spill_b[wid] = sb
        self._w_unspill_b[wid] = ub
        self._w_spill_c[wid] = sc
        self._w_unspill_c[wid] = uc
        if not self.memory_limit:
            return
        pressured = mem >= self.high_water * self.memory_limit
        if pressured != (wid in self.mem_pressured):
            if pressured:
                self.mem_pressured.add(wid)
            else:
                self.mem_pressured.discard(wid)
            if ev is not None:
                ev.publish("worker-pressure", wid=wid,
                           pressured=pressured, mem_bytes=mem)
            self._charge(self.reactor.handle_memory_pressure, wid,
                         pressured)

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
    # protocol: dispatch, hints, parked tasks
    # ------------------------------------------------------------------

    def _compute_extras(self, wid: int, items,
                        tried: dict[int, set] | None = None):
        """The dynamic sections of one compute batch for worker ``wid``:
        ``deps`` (ordered input tids per fn-task), ``hints`` (dep ->
        holder data-plane address, p2p) and ``data`` (dep -> value inlined
        from the server store — the relay path: everything when p2p is
        off, only holderless deps as a fallback when it is on).  Chosen
        holders are remembered in ``_hinted`` so a holder death can
        proactively rewrite the hints of still-queued tasks."""
        if not self._tasks_table:
            return None, None, None
        data: dict[int, dict] = {}
        deps: dict[int, list[int]] = {}
        hints: dict[int, dict] = {}
        for tid, _ in items:
            entry = self._tasks_table.get(tid)
            if entry is None or entry[1] != ():
                continue
            dlist = [int(d) for d in self.g.inputs_of(tid)]
            if not dlist:
                continue
            deps[tid] = dlist
            hmap: dict[int, int] = {}
            for d in dlist:
                if d not in self._tasks_table:
                    # duration-model dep: no value exists to ship or
                    # hint at (the worker passes None, as the thread
                    # runtime does)
                    continue
                if not self.p2p:
                    data.setdefault(tid, {})[d] = self.results.get(d)
                    continue
                holders = self._holders(d)
                if wid in holders:
                    continue    # already in the target worker's cache
                skip = tried.get(d, ()) if tried else ()
                cands = [h for h in holders
                         if h not in self.dead
                         and h in self._data_addrs
                         and h not in skip]
                # memory-aware hinting: a holder above the high-water
                # mark has likely spilled this value — fetching from it
                # pays an unspill; prefer a pressure-free replica
                h = next((c for c in cands
                          if c not in self.mem_pressured),
                         cands[0] if cands else None)
                if h is not None:
                    hints.setdefault(tid, {})[d] = self._data_addrs[h]
                    hmap[d] = h
                elif d in self.results:
                    # no live holder: relay the server's copy
                    data.setdefault(tid, {})[d] = self.results[d]
                # else: value is gone everywhere; the worker reports
                # fetch-failed and the task parks until lineage
                # re-execution materializes the dep again
            if hmap:
                self._hinted[tid] = (wid, hmap)
            else:
                self._hinted.pop(tid, None)
        return data or None, deps or None, hints or None

    def _send_compute(self, wid: int, items,
                      tried: dict[int, set] | None = None) -> None:
        data, deps, hints = self._compute_extras(wid, items, tried)
        ev = self.events
        if ev is not None:
            # published BEFORE the send so an inproc worker's
            # task-started always carries a later seq than its dispatch
            for tid, _ in items:
                ev.publish("task-dispatched", tid=int(tid), wid=wid)
        self.driver.send_compute(wid, items, data, deps, hints)

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

    def _on_fetch_failed(self, wid: int, tid: int, missing) -> None:
        """A worker could not fetch ``tid``'s dependencies from the
        hinted holder: park the task; it is re-dispatched (fresh hints or
        server relay) once the deps are materialized again."""
        if wid in self.dead or tid in self.results:
            return
        ev = self.events
        if ev is not None:
            ev.publish("fetch-failed", tid=int(tid), wid=wid,
                       n_missing=len(missing))
        st = self._parked.setdefault(
            int(tid), {"wid": wid, "missing": set(), "tried": {}})
        st["wid"] = wid
        st["missing"] = {int(d) for d in missing}
        self._park_dirty = True

    def _resolve_parked(self) -> None:
        """Re-dispatch parked tasks whose missing deps are available
        again — from a fresh holder (p2p) or the server store (relay
        fallback).  Runs only when placement state changed (a finish,
        a worker loss, a gather reply), so a dead hint cannot busy-loop."""
        if not self._park_dirty or not self._parked:
            self._park_dirty = False
            return
        self._park_dirty = False
        for tid, st in list(self._parked.items()):
            wid = st["wid"]
            if wid in self.dead \
                    or not self.driver.queue_contains(wid, tid):
                # the task was (or will be) re-routed by worker-lost or a
                # steal; whoever owns it now got fresh hints already
                self._parked.pop(tid)
                continue
            if not st["missing"]:
                continue    # re-dispatched; awaiting execute/fetch-failed
            ok = True
            for d in st["missing"]:
                skip = st["tried"].get(d, set())
                has_holder = any(
                    h not in self.dead and h in self._data_addrs
                    and h not in skip
                    for h in self._holders(d))
                if not has_holder and d not in self.results:
                    ok = False
                    break
            if not ok:
                continue
            items = [(tid, self.g.dur_of(tid))]
            self._send_compute(wid, items, tried=st["tried"])
            for d, h in self._hinted.get(tid, (wid, {}))[1].items():
                st["tried"].setdefault(d, set()).add(h)
            # keep the entry (with its tried-holder memory) until the
            # task finishes or fails its fetch again
            st["missing"] = set()

    def _rehint_after_loss(self, wid: int) -> None:
        """Proactive re-hint (ROADMAP refinement from the p2p PR): when a
        worker dies, tasks already queued toward *surviving* workers with
        who_has hints at it would each pay a failed-fetch round trip
        (dead connect + fetch-failed + park + re-dispatch).  Rewrite the
        hints immediately instead: retract the stale queued compute (the
        worker skips it) and re-send it pointing at surviving holders —
        or inlining the server's relayed copy."""
        if not self.p2p:
            return
        for tid, (ow, hmap) in list(self._hinted.items()):
            stale = {d for d, h in hmap.items() if h == wid}
            if not stale:
                continue
            self._hinted.pop(tid, None)
            if ow in self.dead or not self.driver.queue_contains(ow, tid):
                continue
            if tid in self._parked:
                continue    # a fetch already failed; the park path owns it
            if not all(d in self.results
                       or any(h not in self.dead and h in self._data_addrs
                              for h in self._holders(d))
                       for d in stale):
                continue    # gone everywhere: lineage recovery handles it
            self.driver.send_retract(ow, [tid])
            self._send_compute(ow, [(tid, self.g.dur_of(tid))])
            self.n_rehints += 1
            ev = self.events
            if ev is not None:
                ev.publish("task-rehint", tid=tid, wid=ow)

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
            self._data_addrs.pop(wid, None)
            self.worker_mem.pop(wid, None)
            self.mem_pressured.discard(wid)
            for reps in self._replicas.values():
                reps.discard(wid)
            if len(self.dead) >= self.n_workers \
                    and (self.driver.remote_results or self._run_to_done):
                # no capacity left to resubmit onto: a process pool
                # cannot regrow and a one-shot run cannot wait for one,
                # so the run cannot finish.  A *persistent* thread pool
                # CAN be scaled back up (ElasticController), so its loop
                # survives a momentarily-empty pool.
                self._timed_out = True
                return
            if lost is None:
                lost = self.driver.queue_pop(wid)
        elif lost is None:
            return
        out = self._charge(self.reactor.handle_worker_lost, wid,
                           sorted(int(t) for t in lost))
        self._dispatch(out)
        # a gather in flight against the dead worker would never be
        # answered: re-issue it against a surviving holder
        retry = [tid for tid, st in self._gather_state.items()
                 if st["wid"] == wid]
        if retry:
            self._do_gather(retry, fresh=False)
        self._park_dirty = True
        if first:
            self._rehint_after_loss(wid)

    def _apply_moves(self, moves) -> list[tuple[int, int]]:
        """Apply steal reassignments: retract each task from its source
        (driver semantics: definitive under the inproc lock, optimistic
        retract frames over a wire), report failed retractions back to
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
        plus the control plane (epoch/release/gather submissions, kill
        requests).  False exits the loop."""
        if self._stop_requested or self._timed_out:
            return False
        if self._run_to_done and self.reactor.done():
            if not self._collect_needed():
                return False
            if self._collect_satisfied():
                return False
        now = time.perf_counter()
        # once result collection has started the run itself is complete:
        # only the collection window bounds us — a finished run must not
        # be reported timed_out while its results are being gathered
        if not self._collect_req and self._t_deadline is not None \
                and now > self._t_deadline:
            self._timed_out = True
            return False
        if self._collect_deadline is not None \
                and now > self._collect_deadline:
            return False    # partial collection is not a run timeout
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
            elif kind == "gather":
                self._do_gather(item[1])
                item[2].set()   # fetch() may now trust failure markers
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
            elif kind == "gather-reply":
                self._on_gather_reply(ev[1], ev[2], ev[3])
            elif kind == "fetch-failed":
                for tid, missing in ev[2]:
                    self._on_fetch_failed(ev[1], int(tid), missing)
            elif kind == "data-addr":
                self._data_addrs[int(ev[1])] = tuple(ev[2])
            elif kind == "stats":
                for nbytes, nfetch in ev[1]:
                    self.p2p_bytes += int(nbytes)
                    self.n_p2p_fetches += int(nfetch)
            elif kind == "usage":
                self._note_usage(int(ev[1]), ev[2])
            elif kind == "wtiming":
                self._note_timing(int(ev[1]), ev[2])
        if finished:
            self._handle_finished(finished)
        # payload-byte accounting lives on the codec (it sees the blob
        # sizes); drain it into the runtime counters
        self.relay_bytes += self.driver.take_payload_bytes()
        self.gather_bytes += self.driver.take_gather_bytes()
        self._resolve_parked()
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
        if self.p2p and self.driver.remote_results:
            # a finished fn-task implies its worker now holds all of its
            # inputs (it fetched them): feed the replica placement back
            # so scheduling + gather see it
            for tid, wid in finished:
                if wid in self.dead:
                    continue
                entry = self._tasks_table.get(tid)
                if entry is None or entry[1] != ():
                    continue
                for d in self.g.inputs_of(tid):
                    d = int(d)
                    if d not in self._tasks_table:
                        continue    # duration dep: no value held
                    # register the replica even when this very completion
                    # refcount-GC'd the dep — the eviction pass below
                    # must reach the fetched copy, or it leaks in the
                    # worker cache
                    self._replicas.setdefault(d, set()).add(wid)
                    if not self.reactor.is_released(d):
                        self.reactor.handle_placed(d, wid)
        for tid, _ in finished:
            self._parked.pop(tid, None)
            self._hinted.pop(tid, None)
        # a pending gather whose task just (re-)finished has a live
        # holder again: re-issue it now (fresh=True — the re-finished
        # task's holder set is new)
        regather = [t for t, _ in finished if t in self._gather_state]
        if regather:
            self._do_gather(regather, fresh=True)
        self._dispatch(out)
        for tid in self.reactor.drain_purged():
            self.results.discard(tid)
        self._evict_workers(self.reactor.drain_reclaimed())
        self._note_finished(t for t, _ in finished)
        self._park_dirty = True
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
        for ledger in (self._tasks_table, self._replicas,
                       self._gather_state, self._hinted, self._parked):
            for tid in [t for t in ledger if t < new_base]:
                del ledger[tid]
        self._gather_failed = {t for t in self._gather_failed
                               if t >= new_base}
        self._completed = {t for t in self._completed if t >= new_base}
        # drop finished epoch ranges that sit entirely below the base
        # (the EpochStats objects stay reachable via epoch(eid))
        while self._range_epochs and self._range_epochs[0].hi <= new_base \
                and self._range_epochs[0].done_evt.is_set():
            self._range_los.pop(0)
            self._range_epochs.pop(0)
        # workers mirror the drop: their local task tables would
        # otherwise keep every (fn, args) ever shipped via update-graph
        self.driver.broadcast_compact(new_base)
        self.n_compactions += 1
        ev = self.events
        if ev is not None:
            ev.publish("compact", base=new_base)

    # -- one-shot result collection (p2p: results live worker-side) ----

    def _collect_needed(self) -> bool:
        if not (self.p2p and self.driver.remote_results):
            return False
        if not self._collect_req:
            self._collect_req = True
            self._collect_want = [
                int(t) for t in self._tasks_table
                if int(t) not in self.results
                and not self.reactor.is_released(int(t))]
            if self._collect_want:
                self._do_gather(self._collect_want)
                self._collect_deadline = time.perf_counter() + 15.0
        return bool(self._collect_want)

    def _collect_satisfied(self) -> bool:
        return all(t in self.results or t in self._gather_failed
                   for t in self._collect_want)

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
        the graceful drain; process drivers SIGKILL, threads are daemonic
        and park on their queues)."""
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
        # a timed-out run force-kills: no zombie worker processes
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
        """Reactor stats plus the driver's wire/codec meters plus the
        memory subsystem's meters plus the observability counters (see
        ``docs/meters.md`` for the authoritative key table)."""
        stats = self.reactor.stats.as_dict()
        stats.update(self.driver.stats_extra())
        stats.update(self.memory_stats())
        stats["n_steals"] = self.n_steals
        stats["n_rehints"] = self.n_rehints
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
            "n_rehints": self.n_rehints,
            "n_frames_sent": self.driver.n_frames_sent,
            "frames_coalesced": self.driver.frames_coalesced,
            "dispatch_ns_per_task": (self.dispatch_s * 1e9
                                     / max(self.n_dispatched, 1)),
            "worker_mem": dict(self.worker_mem),
            "mem_pressured": sorted(self.mem_pressured),
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
        """Aggregated object-store meters.  In-process drivers read the
        shared store directly; remote-result drivers aggregate the
        per-worker ledgers fed by piggybacked usage records."""
        if not self.driver.remote_results:
            st = self.results
            peak, spill_c, unspill_c = (st.peak_bytes, st.spill_count,
                                        st.unspill_count)
        else:
            peak = self.peak_worker_bytes
            spill_c = sum(self._w_spill_c.values())
            unspill_c = sum(self._w_unspill_c.values())
        spill_b, unspill_b = self._spill_totals()
        return {"memory_limit": self.memory_limit,
                "peak_worker_bytes": peak,
                "spill_bytes": spill_b,
                "unspill_bytes": unspill_b,
                "spill_count": spill_c,
                "unspill_count": unspill_c,
                "n_compactions": self.n_compactions,
                "tid_base": self.g.tid_base}
