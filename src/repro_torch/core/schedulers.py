"""Schedulers (paper §III-D, §III-E, §IV-C).

A copy of :mod:`repro.core.schedulers` for the port.

All schedulers are strictly isolated from the reactor (RSDS architecture,
Fig. 1): they see only the task graph and the event stream, and return
worker assignments.  This makes them swappable across both reactor
implementations.

Event hooks (``on_finished``/``on_worker_removed``/``on_graph_extended``/
``on_steal_failed``/``on_placed``) are driven from exactly one place —
the reactor calls invoked by :class:`repro_torch.core.server.ServerCore`'s
loop — regardless of which execution driver (inproc thread pool,
selector process pool, asyncio process pool) is serving the run, so a
scheduler never needs to know or care which server architecture it is
running under.

* :class:`RandomScheduler`   — paper §III-E: uniform random, stateless.
* :class:`DaskWorkStealing`  — Dask-style: minimise estimated start time
  (occupancy + transfer estimate), steal from overloaded workers.
* :class:`RsdsWorkStealing`  — paper §IV-C: placement-only choice (load
  deliberately ignored), balancing pass when workers go under-loaded.
* :class:`HeftScheduler`     — beyond-paper baseline: classic HEFT list
  scheduling using known durations (simulator only).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import TaskGraph


class SchedulerBase:
    name = "base"
    needs_durations = False
    #: False for schedulers whose precomputed plans index from tid 0
    #: (the server skips released-prefix compaction for them)
    supports_compaction = True

    def attach(self, graph: TaskGraph, n_workers: int,
               workers_per_node: int = 24, seed: int = 0) -> None:
        self.graph = graph
        self.n_workers = n_workers
        self.workers_per_node = workers_per_node
        self.rng = np.random.default_rng(seed)
        # scheduler builds its OWN state (paper: reactor/scheduler each own
        # a task-graph copy)
        self.loads = np.zeros(n_workers, dtype=np.int64)
        self.placement: dict[int, set[int]] = {}
        self.dead: set[int] = set()
        # workers above the memory high-water mark (fed by the runtime's
        # per-worker ledgers): stealing must not pile work onto them
        self.mem_pressured: set[int] = set()
        self.alive = np.arange(n_workers)
        self._steals: dict[int, tuple[int, int]] = {}  # tid -> (src, tgt)

    # -- event feed -----------------------------------------------------
    def on_assigned(self, tid: int, wid: int) -> None:
        self.loads[wid] += 1

    def on_finished(self, tid: int, wid: int) -> None:
        self.loads[wid] -= 1
        self.placement.setdefault(tid, set()).add(wid)
        self._steals.pop(tid, None)

    def on_steal_failed(self, tid: int) -> None:
        """The runtime could not retract ``tid`` (it was already running):
        revert the load bookkeeping :meth:`balance` did for the move, or a
        long-lived scheduler accumulates phantom load and stops seeing
        idle workers."""
        mv = self._steals.pop(tid, None)
        if mv is not None:
            src, tgt = mv
            self.loads[src] += 1
            self.loads[tgt] -= 1

    def on_placed(self, tid: int, wid: int) -> None:
        self.placement.setdefault(tid, set()).add(wid)

    def on_worker_change(self, n_workers: int) -> None:
        old = self.loads
        self.loads = np.zeros(n_workers, dtype=np.int64)
        self.loads[:min(len(old), n_workers)] = old[:n_workers]
        self.n_workers = n_workers
        self.alive = np.array([w for w in range(n_workers)
                               if w not in self.dead])

    def on_worker_removed(self, wid: int) -> None:
        self.dead.add(wid)
        self.mem_pressured.discard(wid)
        self.alive = np.array([w for w in range(self.n_workers)
                               if w not in self.dead])
        for holders in self.placement.values():
            holders.discard(wid)

    def on_memory_pressure(self, wid: int, pressured: bool) -> None:
        """Worker ``wid`` crossed (or dropped back under) its object
        store's high-water mark.  Stealing onto a pressured worker
        would force more spill, so :meth:`balance` skips it as a
        target; assignment itself stays placement-driven (moving a task
        AWAY from its inputs to avoid spill trades a disk read for a
        network transfer — the wrong trade at these sizes)."""
        if pressured:
            self.mem_pressured.add(wid)
        else:
            self.mem_pressured.discard(wid)

    def on_prefix_compacted(self, base: int) -> None:
        """Tids below ``base`` were compacted away: shed their
        bookkeeping so a long-lived scheduler's state stays bounded."""
        for t in [t for t in self.placement if t < base]:
            del self.placement[t]
        for t in [t for t in self._steals if t < base]:
            del self._steals[t]

    def on_graph_extended(self) -> None:
        """Tasks were appended to ``self.graph`` (incremental submission).
        Schedulers that read the graph live need no action; precomputing
        schedulers (HEFT) override to refresh their plan."""

    def _random_alive(self, n: int) -> np.ndarray:
        return self.alive[self.rng.integers(0, len(self.alive), size=n)]

    # -- decisions ------------------------------------------------------
    def assign(self, ready: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def balance(self, queued_by_worker) -> list[tuple[int, int]]:
        """queued_by_worker: wid -> iterable of not-yet-started tids.
        Returns [(tid, new_wid)] reassignments."""
        return []


class RandomScheduler(SchedulerBase):
    """Uniform random assignment; no graph state at all (paper §IV-C)."""
    name = "random"

    def assign(self, ready: np.ndarray) -> np.ndarray:
        return self._random_alive(len(ready))

    def on_assigned(self, tid, wid):  # stateless: skip bookkeeping
        pass

    def on_finished(self, tid, wid):
        pass

    def on_placed(self, tid, wid):
        pass


class DaskWorkStealing(SchedulerBase):
    """Dask-style: minimise estimated start time = occupancy + transfers.

    Duration estimates use the running mean of observed durations (Dask
    uses per-key-prefix means; our synthetic graphs have one prefix).
    Implemented object/loop-style on purpose — this is the scheduler whose
    cost profile mirrors Dask's pure-Python server.
    """
    name = "ws"
    bandwidth = 6.8e9  # InfiniBand FDR56-ish, matches simulator default

    def attach(self, graph, n_workers, workers_per_node=24, seed=0):
        super().attach(graph, n_workers, workers_per_node, seed)
        self.occupancy = [0.0] * n_workers
        self.dur_mean = 1e-3
        self.n_obs = 0

    MAX_CANDIDATES = 20  # Dask's decide_worker caps its candidate pool

    def assign(self, ready: np.ndarray) -> np.ndarray:
        out = np.zeros(len(ready), dtype=np.int64)
        for i, tid in enumerate(ready):
            inputs = self.graph.inputs_of(int(tid))
            cands: set[int] = set()
            for d in inputs:
                for w in self.placement.get(int(d), ()):
                    cands.add(w)
                    if len(cands) >= self.MAX_CANDIDATES:
                        break
                if len(cands) >= self.MAX_CANDIDATES:
                    break
            cands -= self.dead
            occ = np.asarray(self.occupancy)
            if self.dead:
                occ = occ.copy()
                occ[list(self.dead)] = np.inf
            cands.add(int(np.argmin(occ)))
            best, best_est = -1, float("inf")
            for w in cands:
                transfer = 0.0
                for d in inputs:
                    if w not in self.placement.get(int(d), ()):
                        transfer += self.graph.size_of(d) / self.bandwidth
                est = self.occupancy[w] + transfer
                if est < best_est:
                    best, best_est = w, est
            out[i] = best
            self.occupancy[best] += self.dur_mean
            self.loads[best] += 1
        return out

    def on_assigned(self, tid, wid):
        pass  # handled in assign()

    def on_finished(self, tid, wid):
        super().on_finished(tid, wid)
        d = self.graph.dur_of(tid)
        self.n_obs += 1
        self.dur_mean += (d - self.dur_mean) / self.n_obs
        self.occupancy[wid] = max(0.0, self.occupancy[wid] - self.dur_mean)

    def balance(self, queued_by_worker):
        """Steal: move queued tasks from the most occupied workers to idle
        ones (paper §III-D: stealing on imbalance)."""
        moves = []
        # never steal ONTO a worker above its memory high-water mark:
        # new inputs would land on its store and force more spill
        idle = [w for w in range(self.n_workers)
                if self.loads[w] == 0 and w not in self.dead
                and w not in self.mem_pressured]
        if not idle:
            return moves
        order = np.argsort(self.loads)[::-1]
        it = iter(idle)
        target = next(it)
        for w in order:
            if self.loads[w] <= 1:
                break
            queue = list(queued_by_worker.get(int(w), ()))
            take = queue[: max(len(queue) // 2, 0)]
            for tid in take:
                moves.append((int(tid), int(target)))
                self._steals[int(tid)] = (int(w), int(target))
                self.loads[w] -= 1
                self.loads[target] += 1
                try:
                    target = next(it)
                except StopIteration:
                    return moves
        return moves


class RsdsWorkStealing(SchedulerBase):
    """RSDS work-stealing (paper §IV-C): choose the worker with minimal
    transfer cost, deliberately ignoring load; balance under-loaded workers
    afterwards.  No duration or network-speed estimates."""
    name = "ws"

    def assign(self, ready: np.ndarray) -> np.ndarray:
        # vectorized fast path: source tasks (no inputs) go to random
        # workers in one draw — the common case for wide graph frontiers
        g = self.graph
        gb = g.tid_base
        sizes = g.sizes
        nin = g.in_degree[np.asarray(ready, dtype=np.int64) - gb]
        out = self._random_alive(len(ready))
        for i in np.flatnonzero(nin > 0):
            tid = int(ready[i])
            local: dict[int, float] = {}
            for d in g.inputs_of(tid):
                for w in self.placement.get(int(d), ()):
                    local[w] = local.get(w, 0.0) + sizes[int(d) - gb]
            if local:
                out[i] = max(local.items(), key=lambda kv: kv[1])[0]
        np.add.at(self.loads, out, 1)
        return out

    def on_assigned(self, tid, wid):
        pass

    def balance(self, queued_by_worker):
        """Move tasks from loaded workers to under-loaded ones (<1 task).

        Target choice is locality-aware: among the idle workers, prefer
        the one already holding the most input bytes for the stolen task
        (completion holders + fetch replicas reported via ``on_placed``),
        so a steal does not create a transfer the p2p data plane then has
        to pay for.  The queue snapshot is consumed task by task — the
        old per-iteration rebuild could nominate the same tid for several
        targets, corrupting load bookkeeping when the duplicate steal
        failed."""
        moves = []
        # pressured workers are not steal targets (paper's balance pass
        # + the memory subsystem's high-water rule)
        under = [int(w) for w in np.flatnonzero(self.loads == 0)
                 if w not in self.dead and w not in self.mem_pressured]
        if not under:
            return moves
        g = self.graph
        gb = g.tid_base
        order = np.argsort(self.loads)[::-1]
        for w in order:
            if self.loads[w] <= 1:
                break
            queue = list(queued_by_worker.get(int(w), ()))
            while self.loads[w] > 1 and under and queue:
                tid = int(queue.pop())
                best_i, best_local = 0, -1.0
                for i, u in enumerate(under):
                    local = sum(float(g.sizes[int(d) - gb])
                                for d in g.inputs_of(tid)
                                if u in self.placement.get(int(d), ()))
                    if local > best_local:
                        best_i, best_local = i, local
                tgt = under.pop(best_i)
                moves.append((tid, tgt))
                self._steals[tid] = (int(w), tgt)
                self.loads[w] -= 1
                self.loads[tgt] += 1
            if not under:
                break
        return moves


class HeftScheduler(SchedulerBase):
    """HEFT (beyond-paper baseline): static upward-rank list scheduling
    with known durations — an oracle-ish comparison point for the
    simulator experiments."""
    name = "heft"
    needs_durations = True
    supports_compaction = False     # the plan indexes from tid 0
    bandwidth = 6.8e9

    def attach(self, graph, n_workers, workers_per_node=24, seed=0):
        super().attach(graph, n_workers, workers_per_node, seed)
        self._recompute()

    def on_graph_extended(self):
        self._recompute()

    def _recompute(self) -> None:
        g = self.graph
        n_workers = self.n_workers
        n = g.n_tasks
        rank = np.zeros(n)
        for tid in range(n - 1, -1, -1):
            cons = g.consumers_of(tid)
            comm = g.sizes[tid] / self.bandwidth
            rank[tid] = g.durations[tid] + (
                max(rank[c] + comm for c in cons) if len(cons) else 0.0)
        order = np.argsort(-rank)
        finish = np.zeros(n)
        wfree = np.zeros(n_workers)
        place = np.zeros(n, dtype=np.int64)
        for tid in order:
            inputs = g.inputs_of(int(tid))
            best_w, best_f = 0, float("inf")
            for w in range(n_workers):
                ready = wfree[w]
                for d in inputs:
                    arr = finish[d] + (0.0 if place[d] == w
                                       else g.sizes[d] / self.bandwidth)
                    ready = max(ready, arr)
                f = ready + g.durations[tid]
                if f < best_f:
                    best_w, best_f = w, f
            place[tid] = best_w
            finish[tid] = best_f
            wfree[best_w] = best_f
        self._place = place

    def assign(self, ready: np.ndarray) -> np.ndarray:
        return self._place[np.asarray(ready, dtype=np.int64)]


def make_scheduler(name: str) -> SchedulerBase:
    return {"random": RandomScheduler, "dask_ws": DaskWorkStealing,
            "rsds_ws": RsdsWorkStealing, "heft": HeftScheduler}[name]()
