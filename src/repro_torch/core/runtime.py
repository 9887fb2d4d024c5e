"""Real-time (wall-clock) execution engines: drivers + engine shells.

A copy of :mod:`repro.core.runtime` for the port.  One rule differs: a
parent that has imported torch spawns its worker processes instead of
forking them (see :meth:`_ProcessDriver.start_workers`).

The protocol state machine lives ONCE in
:class:`repro_torch.core.server.ServerCore`; this module supplies the execution
drivers that plug into it — how bytes move, how workers live, and which
event-loop architecture the server runs on (the axis the paper's
Dask-vs-rsds comparison is really about):

* :class:`InprocDriver` — worker *threads* over object queues
  (:class:`repro_torch.core.transport.InprocTransport`); no codec is paid on
  the channel (the Dask-style reactor keeps simulating it).
* :class:`SelectorDriver` — worker *processes* behind a byte transport
  (pipe or localhost socket) served by a blocking-selector loop; frames
  pay the real wire codec (:mod:`repro_torch.core.messages`).
* :class:`AsyncioDriver` — the same worker processes and wire codecs,
  served by an **asyncio** event loop with StreamReader/StreamWriter
  endpoints — the Dask-like-Python-server architecture, selectable as
  ``run_graph(..., server="asyncio")`` / ``Cluster(server="asyncio")`` or
  per-engine via ``ProcessRuntime(driver="asyncio")``, so
  selector-vs-asyncio becomes a measurable axis.
* :class:`UvloopDriver` — the asyncio server on uvloop's libuv loop
  (optional dependency), the fourth server-architecture point.

All four drivers publish into the same observability feed
(:mod:`repro_torch.core.events`, enabled via ``events=`` on either runtime or
on ``Cluster``) because the instrumentation lives in the shared
ServerCore; the inproc driver additionally publishes worker-side
``task-started`` events (thread workers share the server's process).

:class:`ThreadRuntime` and :class:`ProcessRuntime` are thin shells over
:class:`~repro_torch.core.server.ServerCore` preserving the original public
surface (``start``/``submit_tasks``/``wait_epoch``/``fetch``/
``fail_worker``/``run``/``shutdown``, plus the attributes the fault/
elasticity utilities poke).  The one-shot ``run()`` wraps the persistent
lifecycle; the user-facing surface lives in :mod:`repro_torch.core.client`.
"""
from __future__ import annotations

import asyncio
import collections
import multiprocessing as mp
import os
import queue
import sys
import threading
import time
from typing import Any

from repro_torch.core import messages as msg
from repro_torch.core import transport as tp
from repro_torch.core.graph import TaskGraph
from repro_torch.core.server import Driver, EpochStats, RunResult, ServerCore
from repro_torch.core.store import ObjectStore

__all__ = ["EpochStats", "RunResult", "ServerCore", "Driver",
           "InprocDriver", "SelectorDriver", "AsyncioDriver",
           "UvloopDriver", "has_uvloop",
           "ThreadRuntime", "ProcessRuntime", "run_graph"]


# ---------------------------------------------------------------------------
# In-process driver (thread workers)
# ---------------------------------------------------------------------------

class InprocDriver(Driver):
    """Thread workers over object queues.  No wire, no worker caches:
    results land directly in ``core.results``, so the remote half of the
    protocol (gather/update-graph/release frames) stays inert."""

    name = "inproc"
    remote_results = False
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

    def send_compute(self, wid: int, items, data=None, deps=None,
                     hints=None) -> None:
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
# Worker process body (shared by the selector and asyncio drivers)
# ---------------------------------------------------------------------------

def _close_fds(fds) -> None:
    for fd in fds:
        try:
            os.close(fd)
        except OSError:
            pass


_MISS = object()    # cache-lookup sentinel


def _worker_main(wid: int, endpoint_args, wire_name: str,
                 zero_worker: bool, simulate_durations: bool,
                 tasks_table, cleanup_fds, p2p: bool = False,
                 memory_limit: int | None = None,
                 spill_dir: str | None = None,
                 batching: bool = True, tracing: bool = False) -> None:
    """Single-threaded worker process: recv compute frames, execute, send
    finished frames.  Mirrors the paper's one-thread-per-worker setup —
    and is identical under every server driver (the architecture axis is
    a server-side variable only).

    Persistent-server protocol: ``update-graph`` frames extend the local
    task table mid-run (incremental epochs), ``release`` frames purge the
    local result store (explicit key lifetime), ``gather`` frames re-send
    cached results as explicit gather-reply frames (absent keys are
    marked, never silently dropped).

    Every result lives in a :class:`repro_torch.core.store.ObjectStore`: a
    byte-accounted LRU bounded by ``memory_limit`` that spills cold
    values to pickle files under ``spill_dir`` and unspills them
    transparently on any access (compute-dep reads, peer fetches,
    gathers).  The worker piggybacks its store usage record on
    finished/stats frames so the server's memory ledger tracks it.

    With ``p2p`` the worker is a node on the peer-to-peer data plane: a
    :class:`repro_torch.core.transport.DataPlaneListener` serves this worker's
    stored values to peers on a background thread, compute frames carry
    ``who_has`` placement hints instead of inlined payloads, and
    dependency values are dialed directly from the holder's store —
    finished frames carry no result data (the server fetches on demand
    over gather frames).  A dependency that cannot be fetched (holder
    died) is reported via a fetch-failed frame and the server re-routes
    or relays.

    With ``tracing`` the worker stamps each task with its own
    ``perf_counter_ns`` clock — frame receive, execution start/end, and
    cumulative p2p dep-fetch time — and piggybacks the records on the
    finished frames (both wire codecs), exactly like the usage records.
    The server converts them to ``task-timing`` events and
    :mod:`repro_torch.core.tracing` aligns the per-worker clocks offline."""
    _close_fds(cleanup_fds)
    ep = tp.make_worker_endpoint(endpoint_args)
    wire = msg.make_wire(wire_name)
    table: dict[int, tuple] = dict(tasks_table or {})
    store = ObjectStore(
        memory_limit=memory_limit,
        spill_dir=(os.path.join(spill_dir, f"worker-{wid}")
                   if spill_dir else None),
        name=f"w{wid}")
    pending: collections.deque = collections.deque()
    retracted: set[int] = set()
    out: list[tuple[int, Any]] = []
    peers: dict[tuple, tp.PeerChannel] = {}
    xfer = {"bytes": 0, "fetches": 0, "bytes_sent": 0, "fetches_sent": 0}
    sent_usage: list = [None]
    timing: list[tuple] = []        # (tid, recv, start, end, fetch) ns
    fetch_ns = [0]                  # p2p fetch time within current task
    alive = True

    listener = None
    if p2p:
        # the listener thread uses its OWN codec instance: the wire
        # objects keep per-instance byte counters and are not thread-safe
        # (the store has its own internal lock)
        dp_wire = msg.make_wire(wire_name)

        def serve_fetch(frame: bytes) -> bytes:
            op, recs, _ = dp_wire.decode(frame)
            present, absent = {}, []
            for t in recs:
                t = int(t)
                v = store.get(t, _MISS)     # unspills on demand
                if v is not _MISS:
                    present[t] = v
                else:
                    absent.append(t)
            (reply,) = dp_wire.encode_fetch_reply(present, absent)
            return reply

        listener = tp.DataPlaneListener(serve_fetch)
        for frame in wire.encode_data_addr(wid, listener.addr):
            ep.send(frame)

    def resolve_deps(deps, data, hints) -> tuple[list, list[int]]:
        """Dependency values for one task, in input order: inlined
        payloads first, then the local cache, then a direct fetch from
        the hinted holder.  Returns ``(values, missing_tids)`` —
        non-empty ``missing`` means the task cannot run here yet."""
        got: dict[int, Any] = {}
        to_fetch: dict[tuple, list[int]] = {}
        for d in deps:
            d = int(d)
            if d in got:
                continue
            if data is not None and d in data:
                got[d] = data[d]
                continue
            if d not in table:
                # duration-model dep (no callable): it produces no value
                # anywhere — same None the thread runtime passes
                got[d] = None
                continue
            v = store.get(d, _MISS)
            if v is not _MISS:
                got[d] = v
            elif hints is not None and d in hints:
                to_fetch.setdefault(tuple(hints[d]), []).append(d)
        for addr, ds in to_fetch.items():
            try:
                ch = peers.get(addr)
                if ch is None:
                    ch = peers[addr] = tp.PeerChannel(addr)
                (req,) = wire.encode_fetch(ds)
                if tracing:
                    f0 = time.perf_counter_ns()
                    raw = ch.request(req)
                    fetch_ns[0] += time.perf_counter_ns() - f0
                else:
                    raw = ch.request(req)
                xfer["bytes"] += len(req) + len(raw)
                xfer["fetches"] += 1
                _, _absent, payload = wire.decode(raw)
                if payload:
                    store.update(payload)
                    got.update(payload)
            except tp.TransportClosed:
                ch = peers.pop(addr, None)
                if ch is not None:
                    ch.close()
        missing = sorted({int(d) for d in deps if int(d) not in got})
        if missing:
            return [], missing
        return [got[int(d)] for d in deps], []

    def flush() -> None:
        # piggyback the store usage record on whichever frame goes out
        # (finished batch preferred; stats otherwise) when it changed
        usage = store.usage()
        new_u = usage if usage != sent_usage[0] else None
        frames: list[bytes] = []
        if out:
            frames.extend(wire.encode_finished_batch(
                wid, out, new_u, timing=timing or None))
            out.clear()
            timing.clear()
            if new_u is not None:
                sent_usage[0] = usage
                new_u = None
        if xfer["bytes"] > xfer["bytes_sent"] or new_u is not None:
            frames.extend(wire.encode_stats(
                xfer["bytes"] - xfer["bytes_sent"],
                xfer["fetches"] - xfer["fetches_sent"], new_u))
            if new_u is not None:
                sent_usage[0] = usage
            xfer["bytes_sent"] = xfer["bytes"]
            xfer["fetches_sent"] = xfer["fetches"]
        if batching and len(frames) > 1:
            # one transport send per flush: frame_event expands the
            # envelope server-side, the usage side channel still ends up
            # on the batch's LAST sub-frame (piggyback contract)
            frames = wire.encode_batch(frames)
        for frame in frames:
            ep.send(frame)

    def handle(op: int, recs, payloads) -> None:
        nonlocal alive
        if op == msg.OP_BATCH:
            # recs are the decoded sub-triples in send order: apply each
            # as if it had arrived as its own frame
            for sub_op, sub_recs, sub_payloads in recs:
                handle(sub_op, sub_recs, sub_payloads)
        elif op == msg.OP_COMPUTE:
            extra = payloads or {}
            data = extra.get("data") or {}
            deps = extra.get("deps") or {}
            hints = extra.get("hints") or {}
            recv = time.perf_counter_ns() if tracing else 0
            for tid, dur in recs:
                pending.append((tid, dur, data.get(tid),
                                deps.get(tid), hints.get(tid), recv))
        elif op == msg.OP_UPDATE_GRAPH:
            if payloads:
                table.update(payloads)
        elif op == msg.OP_RELEASE:
            for tid in recs:
                store.discard(int(tid))      # both tiers + spill file
        elif op == msg.OP_GATHER:
            present, absent = {}, []
            for t in recs:
                t = int(t)
                v = store.get(t, _MISS)      # unspills on demand
                if v is not _MISS:
                    present[t] = v
                else:
                    absent.append(t)
            for frame in wire.encode_gather_reply(present, absent):
                ep.send(frame)
        elif op == msg.OP_RETRACT:
            retracted.update(int(t) for t in recs)
        elif op == msg.OP_COMPACT:
            # the server compacted the tid prefix for good: shed the
            # local task table (fn/args pinned per tid), retraction
            # markers and any stray store rows below the base, so a
            # long-lived worker's footprint tracks the live window
            base = int(recs[0])
            for t in [t for t in table if t < base]:
                del table[t]
            retracted.difference_update(
                [t for t in retracted if t < base])
            for t in [t for t in store.keys() if t < base]:
                store.discard(t)
        elif op == msg.OP_SHUTDOWN:
            alive = False

    while alive or pending:
        block = alive and not pending
        if block:
            flush()
        timeout = None if block else 0
        while alive:
            try:
                raw = ep.recv(timeout)
            except tp.TransportClosed:
                alive = False
                break
            if raw is None:
                break
            op, recs, payloads = wire.decode(raw)
            handle(op, recs, payloads)
            timeout = 0
        if not pending:
            if not alive:
                break
            continue
        tid, dur, data, deps, hints, recv = pending.popleft()
        if tid in retracted:
            retracted.discard(tid)
            continue
        if tracing:
            fetch_ns[0] = 0
            start = time.perf_counter_ns()
        result = msg._NO_RESULT
        if not zero_worker:
            fn, fargs = table.get(tid, (None, ()))
            if fn is not None:
                if fargs == ():
                    vals, missing = resolve_deps(deps or (), data, hints)
                    if missing:
                        # holder unreachable: hand the task back instead
                        # of wedging — the server re-routes or relays
                        for frame in wire.encode_fetch_failed(tid,
                                                              missing):
                            ep.send(frame)
                        continue
                    result = fn(*vals)
                else:
                    result = fn(*fargs)
                store.put(tid, result)
            elif simulate_durations and dur > 0:
                time.sleep(dur)
        # p2p: results stay in the worker cache; the finished frame is a
        # pure completion event (the server gathers on demand)
        out.append((tid, msg._NO_RESULT if p2p else result))
        if tracing:
            # start->end brackets dep resolution + execution; fetch is
            # the p2p dep-fetch time nested inside it
            timing.append((tid, recv, start, time.perf_counter_ns(),
                           fetch_ns[0]))
        # accumulate completions while more work is queued: the static
        # wire batches natively (RSDS), the dask wire rides the batch
        # envelope when the batching knob is on (BatchedSend); with both
        # off the dask wire stays strictly per-message
        if (not wire.batched and not batching) or not pending \
                or len(out) >= 64:
            flush()
    flush()
    if listener is not None:
        listener.close()
    for ch in peers.values():
        ch.close()
    store.close()       # removes this worker's spill files
    ep.close()


# ---------------------------------------------------------------------------
# Process drivers (selector + asyncio share pool/wire mechanics)
# ---------------------------------------------------------------------------

class _ProcessDriver(Driver):
    """Shared mechanics of the OS-process drivers: pool spawn/kill/join,
    wire codec accounting, worker-queue sets, frame->event normalization
    (via :func:`repro_torch.core.messages.frame_event`)."""

    remote_results = True

    def __init__(self, *, transport: str = "pipe",
                 start_method: str | None = None,
                 zero_worker: bool = False,
                 simulate_durations: bool = True,
                 batching: bool = True):
        self.transport_kind = transport
        self.start_method = start_method
        self.zero_worker = zero_worker
        self.simulate_durations = simulate_durations
        # high-volume control plane: frames queued during one poll
        # iteration are coalesced into one batch envelope per worker at
        # flush_sends() (called by the core at iteration boundaries)
        self.batching = batching
        self._outbox: dict[int, list[bytes]] = {}
        self.n_frames_sent = 0
        self.frames_coalesced = 0
        self.wire = None
        self.procs: list = []
        self._tp = None
        self._kill_requests: queue.Queue = queue.Queue()
        self._tp_closed = False

    def bind(self, core) -> None:
        super().bind(core)
        self.wire = msg.make_wire(core.reactor.name)

    def _make_transport(self, n_workers: int):
        raise NotImplementedError

    # -- worker pool ----------------------------------------------------

    def start_workers(self) -> None:
        core = self.core
        ctx_name = (self.start_method
                    or os.environ.get("REPRO_START_METHOD"))
        if not ctx_name:
            # fork is fastest, but a forked child cannot use a CUDA
            # context its parent made, and the parent's CUDA and torch
            # threads may hold locks at the fork — prefer spawn once
            # torch is loaded; workers never need torch
            fork_ok = ("fork" in mp.get_all_start_methods()
                       and "torch" not in sys.modules)
            ctx_name = "fork" if fork_ok else "spawn"
        if ctx_name != "fork" and self.transport_kind == "pipe":
            self.transport_kind = "socket"  # raw fds need fork inheritance
        ctx = mp.get_context(ctx_name)
        core._tasks_table = {t.tid: (t.fn, t.args) for t in core.g.tasks
                             if t.fn is not None}
        self._tp = self._make_transport(core.n_workers)
        try:
            for wid in range(core.n_workers):
                p = ctx.Process(
                    target=_worker_main,
                    args=(wid, self._tp.worker_args(wid),
                          core.reactor.name, self.zero_worker,
                          self.simulate_durations,
                          core._tasks_table or None,
                          self._tp.child_cleanup(wid)
                          if ctx_name == "fork" else [],
                          core.p2p, core.memory_limit, core.spill_dir,
                          self.batching, core.tracing),
                    daemon=True)
                p.start()
                self.procs.append(p)
        except BaseException:
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                p.join(timeout=5.0)
            raise

    def fail_worker(self, wid: int) -> None:
        """SIGKILL the worker process — processed on the server loop
        (kill + worker-lost handling), so safe to call from any thread."""
        self._kill_requests.put(wid)

    def drain_kills(self) -> None:
        while True:
            try:
                wid = self._kill_requests.get_nowait()
            except queue.Empty:
                return
            if wid in self.core.dead:
                continue
            p = self.procs[wid]
            if p.is_alive():
                p.kill()
                p.join(timeout=2.0)
            self.core._worker_lost(wid)

    def sweep(self) -> list[int]:
        return [wid for wid, p in enumerate(self.procs)
                if wid not in self.core.dead and not p.is_alive()]

    def drop(self, wid: int) -> None:
        self._tp.drop(wid)

    # -- queue accounting: dict-of-sets, server-loop only ---------------

    def queue_push(self, wid: int, tid: int) -> bool:
        self.core.queued[wid].add(tid)
        return True

    def queue_discard(self, wid: int, tid: int) -> None:
        self.core.queued.get(wid, set()).discard(tid)

    def queue_pop(self, wid: int) -> list[int]:
        return sorted(self.core.queued.pop(wid, set()))

    def queue_snapshot(self) -> dict[int, list[int]]:
        return {w: sorted(s) for w, s in self.core.queued.items()
                if s and w not in self.core.dead}

    def queue_contains(self, wid: int, tid: int) -> bool:
        return tid in self.core.queued.get(wid, set())

    def retract_moves(self, moves):
        """Optimistic steal: the old worker drops the task if it has not
        started (retract frame); a duplicate completion is ignored by the
        reactor (same retraction semantics as the simulator)."""
        core = self.core
        real, failed = [], []
        retract_by_wid: dict[int, list[int]] = {}
        for tid, nw in moves:
            src = next((w for w, s in core.queued.items() if tid in s),
                       None)
            if src is None or src == nw:
                failed.append(tid)
                continue
            core.queued[src].discard(tid)
            retract_by_wid.setdefault(src, []).append(tid)
            real.append((tid, nw))
        for wid, tids in retract_by_wid.items():
            self.send_retract(wid, tids)
        return real, failed

    # -- sends ----------------------------------------------------------

    def _send_frames(self, wid: int, frames) -> None:
        if self.batching:
            # defer: the outbox is flushed once per loop iteration so
            # every frame queued toward one worker shares one send
            self._outbox.setdefault(wid, []).extend(frames)
            return
        core = self.core
        for frame in frames:
            core.wire_bytes += len(frame)
            core.wire_frames += 1
            self.n_frames_sent += 1
            self._tp.send(wid, frame)

    def flush_sends(self) -> None:
        if not self._outbox:
            return
        core = self.core
        dead = core.dead
        for wid, frames in self._outbox.items():
            # a worker declared dead between queueing and flush gets
            # nothing (its tasks were already rerouted)
            if not frames or wid in dead:
                continue
            if len(frames) > 1:
                self.frames_coalesced += len(frames)
                frames = core._charge_codec(self.wire.encode_batch,
                                            frames)
            for frame in frames:
                core.wire_bytes += len(frame)
                core.wire_frames += 1
                self.n_frames_sent += 1
                self._tp.send(wid, frame)
        self._outbox.clear()

    def send_compute(self, wid: int, items, data=None, deps=None,
                     hints=None) -> None:
        frames = self.core._charge_codec(
            self.wire.encode_compute_batch, items, data,
            self.core.g.inputs_of, hints, deps)
        self._send_frames(wid, frames)

    def send_retract(self, wid: int, tids) -> None:
        self._send_frames(wid, self.core._charge_codec(
            self.wire.encode_retract, tids))

    def send_release(self, wid: int, tids) -> None:
        self._send_frames(wid, self.core._charge_codec(
            self.wire.encode_release, tids))

    def send_gather(self, wid: int, tids) -> None:
        self._send_frames(wid, self.core._charge_codec(
            self.wire.encode_gather, tids))

    def broadcast_compact(self, base: int) -> None:
        frames = self.core._charge_codec(self.wire.encode_compact, base)
        for wid in range(self.core.n_workers):
            if wid not in self.core.dead:
                self._send_frames(wid, frames)

    def prepare_epoch(self, tasks):
        """Encode the epoch for the live workers: the Dask wire pays one
        update-graph message per key, the static wire one frame per epoch
        (the paper's codec asymmetry on the submission path)."""
        defs = [(t.tid, float(t.duration)) for t in tasks]
        fns = {t.tid: (t.fn, t.args) for t in tasks if t.fn is not None}
        frames = self.core._charge_codec(self.wire.encode_update_graph,
                                         defs, fns or None)
        return frames, fns

    def broadcast_epoch(self, prepared) -> None:
        frames, fns = prepared
        self.core._tasks_table.update(fns)
        for wid in range(self.core.n_workers):
            if wid not in self.core.dead:
                self._send_frames(wid, frames)

    # -- events ---------------------------------------------------------

    def _events_from(self, raw_events) -> list[tuple]:
        core = self.core
        out: list[tuple] = []
        for wid, raw in raw_events:
            if raw is None:           # EOF: unexpected death
                out.append(("lost", wid, None))
                continue
            core.wire_bytes += len(raw)
            core.wire_frames += 1
            op, recs, payloads = core._charge_codec(self.wire.decode, raw)
            if wid in core.dead:
                self.wire.take_usage()      # drop the stale side-channels
                self.wire.take_timing()
                continue      # stale frame from a failed worker
            ev = msg.frame_event(op, wid, recs, payloads)
            if ev is not None:
                if ev[0] == "batch":
                    # expand the worker's coalesced envelope: the core
                    # only ever sees ordinary protocol events
                    out.extend(ev[1])
                else:
                    out.append(ev)
            usage = self.wire.take_usage()
            if usage is not None:
                out.append(("usage", wid, usage))
            timing = self.wire.take_timing()
            if timing:
                out.append(("wtiming", wid, timing))
        return out

    # -- lifecycle ------------------------------------------------------

    def finalize(self, force: bool) -> None:
        if force or self._tp is None:
            return
        self.flush_sends()      # nothing queued may outlive the loop
        bye = self.wire.encode_shutdown()
        for wid in range(self.core.n_workers):
            if wid not in self.core.dead:
                self._tp.send(wid, bye)
        # give the non-blocking writers a chance to flush
        for _ in range(50):
            self._tp.poll(0.01)
            if all(not p.is_alive() for p in self.procs):
                break

    def teardown(self, force: bool) -> None:
        try:
            if force:
                for p in self.procs:
                    if p.is_alive():
                        p.kill()
        finally:
            if self._tp is not None and not self._tp_closed:
                self._tp_closed = True
                self._tp.close()
            for p in self.procs:
                p.join(timeout=1.0)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5.0)

    # -- meters ---------------------------------------------------------

    def take_payload_bytes(self) -> int:
        return self.wire.take_payload_bytes()

    def take_gather_bytes(self) -> int:
        return self.wire.take_gather_bytes()

    def stats_extra(self) -> dict:
        core = self.core
        return dict(wire_bytes=core.wire_bytes,
                    wire_frames=core.wire_frames,
                    codec_s=round(core.codec_s, 6),
                    transport=self.transport_kind,
                    p2p=core.p2p,
                    relay_bytes=core.relay_bytes,
                    p2p_bytes=core.p2p_bytes,
                    gather_bytes=core.gather_bytes,
                    p2p_fetches=core.n_p2p_fetches,
                    batching=self.batching,
                    n_frames_sent=self.n_frames_sent,
                    frames_coalesced=self.frames_coalesced,
                    server_driver=self.name)


class SelectorDriver(_ProcessDriver):
    """Blocking-selector server loop over the existing pipe/socket
    transports — today's tight-loop server architecture."""

    name = "selector"

    def _make_transport(self, n_workers: int):
        return tp.make_server_transport(self.transport_kind, n_workers)

    def connect(self) -> None:
        self._tp.after_start(self.procs)

    def poll(self, timeout: float) -> list[tuple]:
        return self._events_from(self._tp.poll(timeout))


class AsyncioDriver(_ProcessDriver):
    """The same ServerCore on an asyncio event loop: per-worker
    StreamReader tasks feed a queue, sends ride StreamWriters with
    batched drains — the Dask-like Python-server architecture, making
    the paper's server-loop comparison measurable in-repo.  Workers are
    byte-identical to the selector driver's (blocking endpoints)."""

    name = "asyncio"

    def _make_transport(self, n_workers: int):
        return tp.AsyncioTransport(self.transport_kind, n_workers)

    def serve(self) -> None:
        asyncio.run(self._serve())

    async def _serve(self) -> None:
        core = self.core
        try:
            self._raw_q = await self._tp.a_start()
            core._bootstrap()
            while core._loop_tick():
                raws = await self._a_poll(0.01)
                core._process_events(self._events_from(raws))
                await self._tp.a_flush()
        finally:
            try:
                await self._a_finalize(core._timed_out
                                       or core._force_shutdown)
            finally:
                await self._tp.a_close()

    async def _a_poll(self, timeout: float) -> list:
        q = self._raw_q
        raws = []
        try:
            raws.append(await asyncio.wait_for(q.get(), timeout))
        except asyncio.TimeoutError:
            return raws
        while True:
            try:
                raws.append(q.get_nowait())
            except asyncio.QueueEmpty:
                break
        return raws

    async def _a_finalize(self, force: bool) -> None:
        if force:
            return
        self.flush_sends()      # nothing queued may outlive the loop
        bye = self.wire.encode_shutdown()
        for wid in range(self.core.n_workers):
            if wid not in self.core.dead:
                self._tp.send(wid, bye)
        await self._tp.a_flush()
        for _ in range(50):
            if all(not p.is_alive() for p in self.procs):
                break
            await asyncio.sleep(0.01)

    def finalize(self, force: bool) -> None:
        pass    # handled inside _serve (the writers live on the loop)


def has_uvloop() -> bool:
    """True when the optional uvloop dependency is importable."""
    import importlib.util
    return importlib.util.find_spec("uvloop") is not None


class UvloopDriver(AsyncioDriver):
    """The asyncio server on uvloop's libuv event loop — the fourth
    server-architecture point (C-accelerated loop, same Python protocol
    handlers), available opportunistically when the optional ``uvloop``
    dependency is installed (``pip install rsds-repro[uvloop]``)."""

    name = "uvloop"

    def __init__(self, **kw):
        if not has_uvloop():
            raise RuntimeError(
                "driver='uvloop' requested but uvloop is not installed "
                "(pip install rsds-repro[uvloop])")
        super().__init__(**kw)

    def serve(self) -> None:
        import uvloop
        loop = uvloop.new_event_loop()
        try:
            loop.run_until_complete(self._serve())
        finally:
            try:
                loop.run_until_complete(loop.shutdown_asyncgens())
            finally:
                loop.close()


_PROCESS_DRIVERS = {"selector": SelectorDriver, "asyncio": AsyncioDriver,
                    "uvloop": UvloopDriver}


# ---------------------------------------------------------------------------
# Engine shells
# ---------------------------------------------------------------------------

class ThreadRuntime(ServerCore):
    """Server thread + worker threads connected by an
    :class:`repro_torch.core.transport.InprocTransport`.  Tasks are real Python
    callables (or calibrated sleeps, or zero-worker instant completions);
    workers are threads — the GIL is released during sleeps and
    numpy/torch work, matching the paper's single-threaded-worker setup.
    Also the substrate for the framework integration: the trainer and
    serving engine submit task graphs here."""

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


class ProcessRuntime(ServerCore):
    """Drop-in sibling of :class:`ThreadRuntime` with OS-process workers
    behind a byte transport.  Task payloads and completions cross the
    transport as real bytes: the Dask-style server pays msgpack
    encode/decode *per message*, the RSDS-style server packs a static
    frame layout *once per batch*, so the paper's codec asymmetry is
    measured instead of simulated.  ``driver`` picks the server
    event-loop architecture: ``"selector"`` (blocking selector, default)
    or ``"asyncio"`` (asyncio streams)."""

    def __init__(self, graph: TaskGraph, reactor, n_workers: int,
                 *, transport: str = "pipe", zero_worker: bool = False,
                 simulate_durations: bool = True,
                 balance_interval: float = 0.05, timeout: float = 300.0,
                 start_method: str | None = None, p2p: bool = True,
                 driver: str = "selector", batching: bool = True,
                 memory_limit: int | None = None,
                 spill_dir: str | None = None, high_water: float = 0.8,
                 compact_threshold: int | None = 8192, events=None,
                 tracing: bool = False):
        if getattr(reactor, "simulate_codec", False):
            raise ValueError(
                "ProcessRuntime needs a reactor with simulate_codec=False: "
                "the wire pays the real codec cost")
        if driver not in _PROCESS_DRIVERS:
            raise ValueError(f"unknown driver {driver!r} "
                             f"(want selector|asyncio|uvloop)")
        self.zero_worker = zero_worker
        self.simulate_durations = simulate_durations
        drv = _PROCESS_DRIVERS[driver](
            transport=transport, start_method=start_method,
            zero_worker=zero_worker,
            simulate_durations=simulate_durations,
            batching=batching)
        # memory_limit bounds each worker PROCESS's store; spilling and
        # unspilling happen worker-side and are reported back on
        # finished/stats frames (the server's ledger + meters)
        super().__init__(graph, reactor, n_workers, drv, p2p=p2p,
                         balance_interval=balance_interval,
                         timeout=timeout, memory_limit=memory_limit,
                         spill_dir=spill_dir, high_water=high_water,
                         compact_threshold=compact_threshold,
                         events=events, tracing=tracing)
        # p2p: dependency values move worker-to-worker over who_has hints
        # + direct fetch (Dask/RSDS-faithful data plane); off = every
        # payload rides compute/finished frames through the server
        self.queued: dict[int, set[int]] = {w: set()
                                            for w in range(n_workers)}

    @property
    def wire(self):
        return self.driver.wire

    @property
    def procs(self) -> list:
        return self.driver.procs

    @property
    def transport_kind(self) -> str:
        return self.driver.transport_kind

    @property
    def start_method(self) -> str | None:
        return self.driver.start_method


# ---------------------------------------------------------------------------

def run_graph(graph: TaskGraph, server: str = "rsds",
              scheduler: str = "ws", n_workers: int = 8,
              runtime: str = "thread", seed: int = 0, **kw) -> RunResult:
    """Run a graph on a wall-clock engine.

    runtime="thread": in-process worker threads (codec simulated for the
    Dask-style server).  runtime="process": OS-process workers behind a
    real byte transport (codec paid on the wire); extra kwargs:
    ``transport="pipe"|"socket"``, ``start_method``, ``p2p`` (default
    True: dependency values move worker-to-worker over who_has hints +
    direct fetch; False: every payload is relayed through the server),
    ``driver="selector"|"asyncio"|"uvloop"`` (the server's
    event-loop architecture; uvloop needs the optional dependency),
    and ``batching`` (default True: control frames queued toward one
    worker within a poll iteration coalesce into one batch envelope —
    the high-volume control plane; False restores strictly per-frame
    sends, the pre-batching cost profile).
    ``server="selector"|"asyncio"|"uvloop"`` is accepted as shorthand
    for the RSDS wire on that driver (forces the process runtime) — the
    paper's server-architecture axis in one kwarg.

    Memory subsystem kwargs (both runtimes): ``memory_limit`` bounds
    each worker's :class:`repro_torch.core.store.ObjectStore` in bytes (the
    whole shared pool for thread workers); overflow spills to
    ``spill_dir`` (private temp dirs by default) and unspills on
    access; ``high_water`` (fraction of the limit) marks workers as
    under memory pressure for hinting/stealing decisions.

    Observability (both runtimes): ``events=True`` turns on the
    structured event feed (:mod:`repro_torch.core.events`), ``events=<path>``
    additionally records it to a rotating JSONL log
    (:func:`repro_torch.core.events.load_jsonl` reads it back);
    ``RunResult.stats["n_events"]`` reports the
    publish count.  Off (the default) costs nothing.  ``tracing=True``
    (with ``events=`` set) additionally captures per-task worker-side
    timestamps as ``task-timing`` events so :mod:`repro_torch.core.tracing`
    can decompose every task's latency into segments.

    Back-compat wrapper over the persistent Cluster/Client API: spins a
    one-shot :class:`repro_torch.core.client.Cluster` up, submits ``graph`` as a
    single epoch, waits, and tears the pool down — equivalent to::

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
