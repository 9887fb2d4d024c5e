"""Reactors: the runtime half of the server (paper Fig. 1).

A copy of :mod:`repro.core.reactor` for the port.

The reactor owns connections/bookkeeping/protocol and translates scheduler
assignments into worker messages; the scheduler never sees any of it.

:class:`ObjectReactor` is the Dask-style implementation: one Python object
per task with set-based dependency bookkeeping, per-message msgpack
encode/decode at the server boundary, and message-at-a-time processing —
the per-task constant cost profile the paper attributes to Dask's server.

:class:`repro_torch.core.array_reactor.ArrayReactor` is the RSDS-style runtime.
Engines (simulator / thread runtime) time every reactor call; that measured
wall time *is* the server overhead in both the virtual-time scaling studies
and the real-time experiments.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np

from repro_torch.core import messages as msg
from repro_torch.core.graph import TaskGraph
from repro_torch.core.schedulers import SchedulerBase

# task states
WAITING, READY, RUNNING, MEMORY, RELEASED = range(5)

# Synthetic waiter marking a client-held key (a live Future): while present
# in a task's refcount, its result is retained even after every consumer
# task has finished — explicit key lifetime, released by Client.release().
CLIENT_HOLD = "<client-hold>"


class ReactorStats:
    def __init__(self):
        self.msgs_in = 0
        self.msgs_out = 0
        self.bytes_coded = 0
        self.releases = 0

    def as_dict(self):
        return {"msgs_in": self.msgs_in, "msgs_out": self.msgs_out,
                "bytes_coded": self.bytes_coded, "releases": self.releases}


class ObjectReactor:
    """Dask-style object-per-task server runtime."""
    name = "dask"

    def __init__(self, graph: TaskGraph, scheduler: SchedulerBase,
                 n_workers: int, workers_per_node: int = 24, seed: int = 0,
                 simulate_codec: bool = True):
        self.graph = graph
        self.scheduler = scheduler
        self.n_workers = n_workers
        self.stats = ReactorStats()
        # When the runtime moves real bytes over a transport (process
        # runtime), the wire pays the codec cost and the simulation here
        # must be off, or Dask-style overhead would be charged twice.
        self.simulate_codec = simulate_codec
        scheduler.attach(graph, n_workers, workers_per_node, seed)
        # per-task dict objects keyed by Dask-style STRING keys — Dask
        # addresses every task by a string key throughout its server; the
        # hashing/allocation cost of that choice is part of what RSDS's
        # integer ids eliminate (paper §IV).
        # compaction mirror of the graph: ``key`` stores live rows only,
        # row index = tid - tid_base (constructed on a fresh graph)
        self.tid_base = graph.tid_base
        self._rel_frontier = self.tid_base
        self.key = [f"{graph.name}-task-{i}" for i in range(graph.n_tasks)]
        # keys whose client hold was explicitly dropped (Client.release);
        # when such a task's data is reclaimed the runtime must purge its
        # value too, so the tids are logged in ``purged``
        self._dropped: set[int] = set()
        self.purged: list[int] = []
        # EVERY key whose data was reclaimed (refcount GC included, not
        # just client-dropped ones): the process runtime drains this to
        # evict worker-side caches, or values that are neither client-held
        # nor consumed downstream pin worker memory forever
        self.reclaimed: list[int] = []
        self.tasks = {}
        for t in graph.tasks:
            self.tasks[self._key(t.tid)] = {
                "state": WAITING,
                "tid": t.tid,
                "waiting_on": set(self._key(int(d)) for d in t.inputs),
                "waiters": set(self._key(int(c))
                               for c in graph.consumers_of(t.tid)),
                "who_has": set(),
                "nbytes": float(t.output_size),
                "worker": -1,
            }
        self.n_done = 0

    def _key(self, tid: int) -> str:
        """Dask-style string key for a global tid (row = tid - base)."""
        return self.key[tid - self.tid_base]

    # ------------------------------------------------------------------
    def _assign(self, ready: list[int]) -> list[tuple[int, int]]:
        if not ready:
            return []
        wids = self.scheduler.assign(np.asarray(ready, dtype=np.int64))
        out = []
        for tid, wid in zip(ready, wids):
            ts = self.tasks[self._key(tid)]
            ts["state"] = READY
            ts["worker"] = int(wid)
            if self.simulate_codec:
                who_has = {int(d):
                           list(self.tasks[self._key(int(d))]["who_has"])
                           for d in self.graph.inputs_of(tid)}
                m = msg.compute_task(tid, int(wid),
                                     self.graph.inputs_of(tid), who_has)
                self.stats.bytes_coded += len(msg.pack(m))
            self.stats.msgs_out += 1
            self.scheduler.on_assigned(tid, int(wid))
            out.append((int(tid), int(wid)))
        return out

    def start(self) -> list[tuple[int, int]]:
        ready = [t.tid for t in self.graph.tasks if not t.inputs]
        return self._assign(ready)

    # incremental ingestion (persistent Cluster/Client path) -----------
    def add_tasks(self, lo: int, hi: int, retain: bool = False
                  ) -> list[tuple[int, int]]:
        """Ingest the graph epoch ``[lo, hi)`` that was just appended to
        ``self.graph`` and assign its immediately-ready tasks.  With
        ``retain=True`` every new task gets a client-hold waiter so its
        result survives refcount GC until :meth:`release_keys`."""
        self.scheduler.on_graph_extended()
        g = self.graph
        self.key.extend(f"{g.name}-task-{i}" for i in range(lo, hi))
        for tid in range(lo, hi):
            t = g.task(tid)
            self.tasks[self._key(tid)] = {
                "state": WAITING,
                "tid": tid,
                "waiting_on": set(),
                "waiters": {CLIENT_HOLD} if retain else set(),
                "who_has": set(),
                "nbytes": float(t.output_size),
                "worker": -1,
            }
        ready = []
        for tid in range(lo, hi):
            ts = self.tasks[self._key(tid)]
            for d in g.inputs_of(tid):
                d = int(d)
                if d < self.tid_base:
                    raise ValueError(
                        f"task {tid} depends on released key {d}")
                dts = self.tasks[self._key(d)]
                if dts["state"] == RELEASED:
                    raise ValueError(
                        f"task {tid} depends on released key {d}")
                dts["waiters"].add(self._key(tid))
                if dts["state"] != MEMORY:
                    ts["waiting_on"].add(self._key(d))
            if not ts["waiting_on"]:
                ready.append(tid)
        return self._assign(ready)

    def add_poisoned(self, lo: int, hi: int) -> None:
        """Register an inert, already-RELEASED tid range: placeholders
        for a failed epoch, keeping reactor and graph tid spaces
        aligned so later epochs stay submittable."""
        self.scheduler.on_graph_extended()
        g = self.graph
        self.key.extend(f"{g.name}-task-{i}" for i in range(lo, hi))
        for tid in range(lo, hi):
            self.tasks[self._key(tid)] = {
                "state": RELEASED, "tid": tid, "waiting_on": set(),
                "waiters": set(), "who_has": set(), "nbytes": 0.0,
                "worker": -1}
        self.n_done += hi - lo   # they never run; keep done() consistent

    def release_keys(self, tids: Iterable[int]) -> list[int]:
        """Drop the client hold on ``tids``; returns the tids whose data
        transitioned to RELEASED (safe to purge from runtime results).
        A released key that is still WAITING/RUNNING, or still has
        consumer waiters, is reclaimed later — when it completes or its
        last consumer finishes — and then surfaces via ``drain_purged``."""
        released = []
        for tid in tids:
            tid = int(tid)
            if tid < self.tid_base:
                continue    # compacted: long gone
            self._dropped.add(tid)
            ts = self.tasks[self._key(tid)]
            ts["waiters"].discard(CLIENT_HOLD)
            if not ts["waiters"] and ts["state"] == MEMORY:
                ts["state"] = RELEASED
                self.stats.releases += 1
                self.stats.msgs_out += len(ts["who_has"])
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
        :meth:`drain_purged` that also covers plain refcount GC.  The
        process runtime sends release frames for these so worker caches
        shed values nobody can ever ask for again."""
        out, self.reclaimed = self.reclaimed, []
        return out

    def all_done_in(self, lo: int, hi: int) -> bool:
        lo = max(lo, self.tid_base)   # compacted tids were done
        return all(self.tasks[self._key(t)]["state"] >= MEMORY
                   for t in range(lo, hi))

    def is_released(self, tid: int) -> bool:
        if int(tid) < self.tid_base:
            return True     # compacted: released and rows dropped
        return self.tasks[self._key(int(tid))]["state"] == RELEASED

    def holders_of(self, tid: int) -> list[int]:
        if int(tid) < self.tid_base:
            return []
        return sorted(self.tasks[self._key(int(tid))]["who_has"])

    def handle_finished(self, events: Iterable[tuple[int, int]]
                        ) -> list[tuple[int, int]]:
        """events: (tid, wid) completions.  Dask-style: process one message
        at a time, each round-tripped through msgpack."""
        assignments: list[tuple[int, int]] = []
        for tid, wid in events:
            if self.simulate_codec:
                raw = msg.pack(msg.task_finished(tid, wid,
                                                 self.graph.size_of(tid)))
                m = msg.unpack(raw)
                self.stats.bytes_coded += len(raw)
                tid = int(m["key"])
                wid = int(m["worker"])
            self.stats.msgs_in += 1
            tid = int(tid)
            wid = int(wid)
            if tid < self.tid_base:
                continue  # stale completion for a compacted tid
            key = self._key(tid)
            ts = self.tasks[key]
            if ts["state"] in (MEMORY, RELEASED):
                continue  # duplicate completion (failed steal retraction)
            ts["state"] = MEMORY
            ts["who_has"].add(wid)
            self.n_done += 1
            self.scheduler.on_finished(tid, wid)
            # a key released by the client before it finished: reclaim
            # now that it reached MEMORY (no consumer waits on it)
            if tid in self._dropped and not ts["waiters"]:
                ts["state"] = RELEASED
                self.stats.releases += 1
                self.purged.append(tid)
                self.reclaimed.append(tid)
            # refcount GC: inputs of tid lose a waiter
            ready = []
            for d in self.graph.inputs_of(tid):
                d = int(d)
                dts = self.tasks[self._key(d)]
                dts["waiters"].discard(key)
                if not dts["waiters"] and dts["state"] == MEMORY:
                    dts["state"] = RELEASED
                    self.stats.releases += 1
                    self.stats.msgs_out += len(dts["who_has"])
                    self.reclaimed.append(d)
                    if d in self._dropped:
                        self.purged.append(d)
            woken: set[int] = set()
            for c in self.graph.consumers_of(tid):
                c = int(c)
                cts = self.tasks[self._key(c)]
                cts["waiting_on"].discard(key)
                # duplicate inputs (e.g. submit(fn, f, f)) produce the
                # same consumer edge twice; waiting_on is a set, so the
                # second edge sees it already empty — dedupe or the task
                # is assigned and executed twice
                if not cts["waiting_on"] and cts["state"] == WAITING \
                        and c not in woken:
                    woken.add(c)
                    ready.append(c)
            assignments.extend(self._assign(ready))
        return assignments

    def handle_placed(self, tid: int, wid: int) -> None:
        self.tasks[self._key(tid)]["who_has"].add(wid)
        self.scheduler.on_placed(tid, wid)

    def handle_memory_pressure(self, wid: int, pressured: bool) -> None:
        """Runtime feedback: worker ``wid`` crossed the memory
        high-water mark (or dropped back under it)."""
        self.scheduler.on_memory_pressure(wid, pressured)

    def rebalance(self, queued_by_worker) -> list[tuple[int, int]]:
        moves = self.scheduler.balance(queued_by_worker)
        for tid, wid in moves:
            self.tasks[self._key(tid)]["worker"] = wid
            self.stats.msgs_out += 2  # steal request + new compute-task
        return moves

    def steal_failed(self, tid: int) -> None:
        """Runtime feedback: the steal of ``tid`` could not be applied."""
        self.scheduler.on_steal_failed(int(tid))

    # failure handling -------------------------------------------------
    def handle_worker_lost(self, wid: int, running: Iterable[int]
                           ) -> list[tuple[int, int]]:
        """Resubmit tasks that were running on a lost worker and recompute
        lost-but-needed outputs (lineage re-execution)."""
        self.scheduler.on_worker_removed(wid)
        to_rerun: set[int] = set(int(t) for t in running)
        for key, ts in self.tasks.items():
            ts["who_has"].discard(wid)
            if ts["state"] == MEMORY and not ts["who_has"] and ts["waiters"]:
                to_rerun.add(ts["tid"])
        # closure: re-run any RELEASED input of a re-run task (lineage)
        frontier = list(to_rerun)
        while frontier:
            tid = frontier.pop()
            for d in self.graph.inputs_of(tid):
                d = int(d)
                if d < self.tid_base:
                    # compaction dropped this released input's row (and
                    # its callable): the lineage cannot be replayed
                    raise RuntimeError(
                        f"task {tid} needs compacted dependency {d}: "
                        "released lineage below the compaction base is "
                        "unrecoverable")
                if d not in to_rerun \
                        and self.tasks[self._key(d)]["state"] == RELEASED:
                    to_rerun.add(d)
                    frontier.append(d)
        was_done = [t for t in to_rerun
                    if self.tasks[self._key(t)]["state"]
                    in (MEMORY, RELEASED)]
        ready = []
        for tid in sorted(to_rerun):
            ts = self.tasks[self._key(tid)]
            ts["state"] = WAITING
            ts["waiting_on"] = {
                self._key(int(d)) for d in self.graph.inputs_of(tid)
                if self.tasks[self._key(int(d))]["state"] != MEMORY
                or int(d) in to_rerun}
            for d in self.graph.inputs_of(tid):
                self.tasks[self._key(int(d))]["waiters"].add(self._key(tid))
            if not ts["waiting_on"]:
                ready.append(tid)
        self.n_done -= len(was_done)
        # re-run tasks may un-release prefix tids: rescan from the base
        self._rel_frontier = self.tid_base
        return self._assign(ready)

    # -- released-prefix compaction ------------------------------------

    def released_prefix(self) -> int:
        """Largest ``n`` such that every tid < n is RELEASED (and may
        therefore be compacted away).  Monotone scan from the last
        frontier; worker-loss lineage re-runs reset it."""
        i = self._rel_frontier
        hi = self.graph.n_tasks
        while i < hi and self.tasks[self._key(i)]["state"] == RELEASED:
            i += 1
        self._rel_frontier = i
        return i

    def compact_prefix(self, new_base: int) -> None:
        """Drop task records and key strings below ``new_base`` (all
        RELEASED) in lockstep with :meth:`TaskGraph.compact_prefix`."""
        k = new_base - self.tid_base
        if k <= 0:
            return
        for key in self.key[:k]:
            self.tasks.pop(key, None)
        del self.key[:k]
        self.tid_base = new_base
        self._rel_frontier = max(self._rel_frontier, new_base)
        self._dropped = {t for t in self._dropped if t >= new_base}
        self.scheduler.on_prefix_compacted(new_base)

    def done(self) -> bool:
        return self.n_done >= self.graph.n_tasks
