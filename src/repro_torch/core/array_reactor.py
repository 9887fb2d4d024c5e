"""RSDS-style array runtime (paper §IV).

A copy of :mod:`repro.core.array_reactor` for the port.

Structure-of-arrays bookkeeping: int32 state vectors, CSR dependency
walks, batched event processing, no per-task Python objects and no
per-message serialization (the paper's protocol change makes message
structure static).  This is the honest Python analogue of "rewrite the
server in Rust": eliminate per-task allocation, indirection and codec work
from the hot path (DESIGN.md §2).
"""
from __future__ import annotations

from typing import Iterable

import numpy as np

from repro_torch.core.graph import TaskGraph, csr_gather, grow_to
from repro_torch.core.reactor import (MEMORY, READY, RELEASED, WAITING,
                                ReactorStats)
from repro_torch.core.schedulers import SchedulerBase

# back-compat alias (the CSR gather moved next to the CSR owner)
_csr_gather = csr_gather


class ArrayReactor:
    name = "rsds"

    def __init__(self, graph: TaskGraph, scheduler: SchedulerBase,
                 n_workers: int, workers_per_node: int = 24, seed: int = 0,
                 simulate_codec: bool = True):
        self.graph = graph
        self.scheduler = scheduler
        self.n_workers = n_workers
        # Accepted for signature parity with ObjectReactor; the RSDS-style
        # reactor never simulates a codec (static structures in-process),
        # so the flag changes nothing here.
        self.simulate_codec = simulate_codec
        self.stats = ReactorStats()
        scheduler.attach(graph, n_workers, workers_per_node, seed)
        n = graph.n_tasks
        # compaction mirror of the graph: row index = tid - tid_base
        # (constructed on a fresh graph, so the bases start equal)
        self.tid_base = graph.tid_base
        self._rel_frontier = self.tid_base
        # doubling-capacity buffers: the public arrays are views of the
        # used prefix, so a warm epoch grows in amortized O(new)
        self._state_buf = np.full(n, WAITING, dtype=np.int8)
        self._waiting_buf = graph.in_degree.astype(np.int32)  # astype copies
        self._waiter_buf = np.diff(
            graph.consumers_indptr).astype(np.int32)
        self._primary_buf = np.full(n, -1, dtype=np.int32)
        self._assigned_buf = np.full(n, -1, dtype=np.int32)
        self._n = n
        self._refresh_views()
        self.n_done = 0
        # keys whose client hold was explicitly dropped (Client.release);
        # reclaimed values are logged in ``purged`` for the runtime
        self._dropped: set[int] = set()
        self.purged: list[int] = []
        # every reclaimed key (refcount GC included): drained by the
        # process runtime to evict worker-side caches
        self.reclaimed: list[int] = []

    def _refresh_views(self) -> None:
        n = self._n
        self.state = self._state_buf[:n]
        self.waiting_count = self._waiting_buf[:n]
        self.waiter_count = self._waiter_buf[:n]
        self.primary = self._primary_buf[:n]
        self.assigned = self._assigned_buf[:n]

    def _grow(self, n_new: int, state_fill: int = WAITING) -> None:
        """Append ``n_new`` task slots (amortized-doubling buffers)."""
        n_old, n = self._n, self._n + n_new
        self._state_buf = grow_to(self._state_buf, n_old, n)
        self._state_buf[n_old:n] = state_fill
        self._waiting_buf = grow_to(self._waiting_buf, n_old, n)
        self._waiting_buf[n_old:n] = 0
        self._waiter_buf = grow_to(self._waiter_buf, n_old, n)
        self._waiter_buf[n_old:n] = 0
        self._primary_buf = grow_to(self._primary_buf, n_old, n)
        self._primary_buf[n_old:n] = -1
        self._assigned_buf = grow_to(self._assigned_buf, n_old, n)
        self._assigned_buf[n_old:n] = -1
        self._n = n
        self._refresh_views()

    # ------------------------------------------------------------------
    def _assign(self, ready: np.ndarray) -> list[tuple[int, int]]:
        """``ready`` carries GLOBAL tids (rows are internal only)."""
        if len(ready) == 0:
            return []
        wids = self.scheduler.assign(ready)
        rows = ready - self.tid_base
        self.state[rows] = READY
        self.assigned[rows] = wids
        self.stats.msgs_out += len(ready)
        for tid, wid in zip(ready, wids):
            self.scheduler.on_assigned(int(tid), int(wid))
        return list(zip(ready.tolist(), wids.tolist()))

    def start(self) -> list[tuple[int, int]]:
        ready = np.flatnonzero(self.waiting_count == 0) + self.tid_base
        return self._assign(ready)

    # incremental ingestion (persistent Cluster/Client path) -----------
    def add_tasks(self, lo: int, hi: int, retain: bool = False
                  ) -> list[tuple[int, int]]:
        """Ingest the graph epoch ``[lo, hi)`` just appended to
        ``self.graph``: grow the state arrays, wire up cross-epoch
        refcounts, and assign the immediately-ready tasks.  With
        ``retain=True`` each new task carries one client-hold waiter
        (released via :meth:`release_keys`)."""
        self.scheduler.on_graph_extended()
        g = self.graph
        b = self.tid_base
        self._grow(hi - lo, WAITING)
        ready = []
        for tid in range(lo, hi):
            missing = 0
            for d in g.inputs_of(tid):
                d = int(d)
                if d < b or self.state[d - b] == RELEASED:
                    raise ValueError(
                        f"task {tid} depends on released key {d}")
                self.waiter_count[d - b] += 1
                if self.state[d - b] != MEMORY:
                    missing += 1
            self.waiting_count[tid - b] = missing
            if retain:
                self.waiter_count[tid - b] += 1
            if missing == 0:
                ready.append(tid)
        return self._assign(np.asarray(ready, dtype=np.int64))

    def add_poisoned(self, lo: int, hi: int) -> None:
        """Register an inert, already-RELEASED tid range: placeholders
        for a failed epoch, keeping reactor and graph tid spaces
        aligned so later epochs stay submittable."""
        self.scheduler.on_graph_extended()
        self._grow(hi - lo, RELEASED)
        self.n_done += hi - lo   # they never run; keep done() consistent

    def release_keys(self, tids) -> list[int]:
        """Drop the client hold on ``tids``; returns the tids whose data
        transitioned to RELEASED (safe to purge from runtime results).
        A released key that is still WAITING/RUNNING, or still has
        consumer waiters, is reclaimed later — when it completes or its
        last consumer finishes — and then surfaces via ``drain_purged``."""
        released = []
        b = self.tid_base
        for tid in tids:
            tid = int(tid)
            if tid < b:
                continue    # compacted: long gone
            self._dropped.add(tid)
            self.waiter_count[tid - b] -= 1
            if self.waiter_count[tid - b] <= 0 \
                    and self.state[tid - b] == MEMORY:
                self.state[tid - b] = RELEASED
                self.stats.releases += 1
                released.append(tid)
                self.reclaimed.append(tid)
        return released

    def drain_purged(self) -> list[int]:
        """Tids of client-dropped keys reclaimed since the last drain
        (the runtime purges their values)."""
        out, self.purged = self.purged, []
        return out

    def drain_reclaimed(self) -> list[int]:
        """Tids of ALL keys reclaimed since the last drain — superset of
        :meth:`drain_purged` covering plain refcount GC too (worker-cache
        eviction signal for the process runtime)."""
        out, self.reclaimed = self.reclaimed, []
        return out

    def all_done_in(self, lo: int, hi: int) -> bool:
        b = self.tid_base   # compacted tids were RELEASED, hence done
        if hi <= b:
            return True     # guard: hi-b would be a negative slice stop
        lo = max(lo, b)
        return bool(np.all(self.state[lo - b:hi - b] >= MEMORY))

    def is_released(self, tid: int) -> bool:
        tid = int(tid)
        if tid < self.tid_base:
            return True     # compacted: released and rows dropped
        return self.state[tid - self.tid_base] == RELEASED

    def holders_of(self, tid: int) -> list[int]:
        tid = int(tid)
        if tid < self.tid_base:
            return []
        w = int(self.primary[tid - self.tid_base])
        return [w] if w >= 0 else []

    def handle_finished(self, events: Iterable[tuple[int, int]]
                        ) -> list[tuple[int, int]]:
        """Batched completion processing — one vectorized pass per batch."""
        ev = list(events)
        if not ev:
            return []
        self.stats.msgs_in += len(ev)
        b = self.tid_base
        # drop duplicate completions (failed steal retractions / re-sends)
        # and stale events for compacted tids
        seen: set[int] = set()
        ev = [e for e in ev
              if int(e[0]) >= b and self.state[int(e[0]) - b] < MEMORY
              and not (int(e[0]) in seen or seen.add(int(e[0])))]
        if not ev:
            return []
        if len(ev) < 4:
            return self._handle_finished_scalar(ev)
        tids = np.fromiter((e[0] for e in ev), dtype=np.int64, count=len(ev))
        wids = np.fromiter((e[1] for e in ev), dtype=np.int64, count=len(ev))
        rows = tids - b
        self.state[rows] = MEMORY
        self.primary[rows] = wids
        self.n_done += len(ev)
        for tid, wid in zip(tids, wids):
            self.scheduler.on_finished(int(tid), int(wid))
        self._reclaim_dropped(tids)

        g = self.graph
        # consumers of all finished tasks (CSR gather, vectorized;
        # overflow-tolerant so it never forces an O(total) compaction).
        # Consumer/dep VALUES are global tids; rows translate by base
        # (deps of a finishing task hold waiter refs, so none can sit
        # below the compaction base)
        cons = g.consumers_of_many(tids)
        if len(cons):
            crows = cons - b
            np.subtract.at(self.waiting_count, crows, 1)
            cand = np.unique(crows)
            ready = cand[(self.waiting_count[cand] == 0)
                         & (self.state[cand] == WAITING)] + b
        else:
            ready = np.zeros(0, dtype=np.int64)
        # refcount GC on the inputs of finished tasks
        deps = csr_gather(g.inputs_indptr, g.inputs_flat, rows)
        if len(deps):
            drows = deps - b
            np.subtract.at(self.waiter_count, drows, 1)
            dead = np.unique(drows)
            dead = dead[(self.waiter_count[dead] == 0)
                        & (self.state[dead] == MEMORY)]
            self.state[dead] = RELEASED
            self.stats.releases += len(dead)
            self.reclaimed.extend(int(d) + b for d in dead)
            if self._dropped:
                self.purged.extend(int(d) + b for d in dead
                                   if int(d) + b in self._dropped)
        return self._assign(ready)

    def _reclaim_dropped(self, tids) -> None:
        """Keys released by the client before they finished: reclaim as
        they reach MEMORY (no consumer waits on them any more)."""
        if not self._dropped:
            return
        b = self.tid_base
        for tid in tids:
            tid = int(tid)
            if tid in self._dropped and self.waiter_count[tid - b] <= 0 \
                    and self.state[tid - b] == MEMORY:
                self.state[tid - b] = RELEASED
                self.stats.releases += 1
                self.purged.append(tid)
                self.reclaimed.append(tid)

    def _handle_finished_scalar(self, ev) -> list[tuple[int, int]]:
        """Small-batch fast path: plain int/array indexing without the
        numpy batch-op constant costs (a Rust runtime has no such
        penalty; this keeps the Python analogue honest at low event
        rates)."""
        g = self.graph
        b = self.tid_base
        ready_ids: list[int] = []
        for tid, wid in ev:
            tid = int(tid)
            if self.state[tid - b] >= MEMORY:
                continue
            self.state[tid - b] = MEMORY
            self.primary[tid - b] = wid
            self.n_done += 1
            self.scheduler.on_finished(tid, int(wid))
            self._reclaim_dropped((tid,))
            for c in g.consumers_of(tid):
                c = int(c)
                self.waiting_count[c - b] -= 1
                if self.waiting_count[c - b] == 0 \
                        and self.state[c - b] == WAITING:
                    ready_ids.append(c)
            for d in g.inputs_of(tid):
                d = int(d)
                self.waiter_count[d - b] -= 1
                if self.waiter_count[d - b] == 0 \
                        and self.state[d - b] == MEMORY:
                    self.state[d - b] = RELEASED
                    self.stats.releases += 1
                    self.reclaimed.append(d)
                    if d in self._dropped:
                        self.purged.append(d)
        return self._assign(np.asarray(ready_ids, dtype=np.int64))

    def handle_placed(self, tid: int, wid: int) -> None:
        self.scheduler.on_placed(tid, wid)

    def handle_memory_pressure(self, wid: int, pressured: bool) -> None:
        """Runtime feedback: worker ``wid`` crossed the memory
        high-water mark (or dropped back under it)."""
        self.scheduler.on_memory_pressure(wid, pressured)

    def rebalance(self, queued_by_worker) -> list[tuple[int, int]]:
        moves = self.scheduler.balance(queued_by_worker)
        b = self.tid_base
        for tid, wid in moves:
            self.assigned[tid - b] = wid
        self.stats.msgs_out += 2 * len(moves)
        return moves

    def steal_failed(self, tid: int) -> None:
        """Runtime feedback: the steal of ``tid`` could not be applied."""
        self.scheduler.on_steal_failed(int(tid))

    def handle_worker_lost(self, wid: int, lost_tasks: Iterable[int]
                           ) -> list[tuple[int, int]]:
        self.scheduler.on_worker_removed(wid)
        g = self.graph
        b = self.tid_base
        lost_data = np.flatnonzero((self.primary == wid)
                                   & (self.state == MEMORY)
                                   & (self.waiter_count > 0)) + b
        # the dead worker holds nothing any more: clear its primary slots
        # so holders_of never hints a fetch at a lost holder
        self.primary[self.primary == wid] = -1
        to_rerun = set(int(t) for t in lost_tasks) | set(lost_data.tolist())
        # closure: re-run any RELEASED input of a re-run task (lineage)
        frontier = list(to_rerun)
        while frontier:
            tid = frontier.pop()
            for d in g.inputs_of(tid):
                d = int(d)
                if d < b:
                    # compaction dropped this released input's row (and
                    # its callable): the lineage cannot be replayed
                    raise RuntimeError(
                        f"task {tid} needs compacted dependency {d}: "
                        "released lineage below the compaction base is "
                        "unrecoverable")
                if d not in to_rerun and self.state[d - b] == RELEASED:
                    to_rerun.add(d)
                    frontier.append(d)
        was_done = {t for t in to_rerun if self.state[t - b] >= MEMORY}
        ready = []
        for tid in sorted(to_rerun):
            self.state[tid - b] = WAITING
            deps = g.inputs_of(tid)
            missing = [int(d) for d in deps
                       if self.state[int(d) - b] != MEMORY
                       or int(d) in to_rerun]
            self.waiting_count[tid - b] = len(missing)
            if tid in was_done:  # its completion had decremented waiters
                self.waiter_count[deps - b] += 1
            if not missing:
                ready.append(tid)
        self.n_done -= len(was_done)
        # re-run tasks may un-release prefix tids: rescan from the base
        self._rel_frontier = self.tid_base
        return self._assign(np.asarray(ready, dtype=np.int64))

    # -- released-prefix compaction ------------------------------------

    def released_prefix(self) -> int:
        """Largest ``n`` such that every tid < n is RELEASED (and may
        therefore be compacted away).  Monotone scan from the last
        frontier; worker-loss lineage re-runs reset it."""
        b = self.tid_base
        i = self._rel_frontier - b
        st = self.state
        n = self._n
        while i < n and st[i] == RELEASED:
            i += 1
        self._rel_frontier = b + i
        return self._rel_frontier

    def compact_prefix(self, new_base: int) -> None:
        """Drop state rows below ``new_base`` (all RELEASED) in lockstep
        with :meth:`TaskGraph.compact_prefix`."""
        k = new_base - self.tid_base
        if k <= 0:
            return
        n = self._n
        self._state_buf = self._state_buf[k:n].copy()
        self._waiting_buf = self._waiting_buf[k:n].copy()
        self._waiter_buf = self._waiter_buf[k:n].copy()
        self._primary_buf = self._primary_buf[k:n].copy()
        self._assigned_buf = self._assigned_buf[k:n].copy()
        self._n = n - k
        self.tid_base = new_base
        self._rel_frontier = max(self._rel_frontier, new_base)
        self._refresh_views()
        self._dropped = {t for t in self._dropped if t >= new_base}
        self.scheduler.on_prefix_compacted(new_base)

    def done(self) -> bool:
        return self.n_done >= self.graph.n_tasks
