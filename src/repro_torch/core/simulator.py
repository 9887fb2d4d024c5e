"""Virtual-time cluster simulator (paper §VI experimental rig).

A copy of :mod:`repro.core.simulator` for the port.

The cluster (workers, network, task execution) runs in virtual time; the
SERVER cost is *real*: every reactor call is timed with perf_counter and
the measured wall time is charged to the virtual clock as server busy time.
The paper's central claim — runtime overhead dominates scheduler quality —
therefore emerges from the true cost of the two reactor implementations on
this machine, while worker counts scale to 1512 without needing 63 nodes.

Cluster model (paper §VI): N nodes x 24 single-threaded workers; transfers
at ``bandwidth`` with ``latency`` per message; same-node transfers pay only
latency.  Zero-worker mode (paper §IV-D) completes tasks instantly with
free transfers, isolating the server exactly like the paper's Rust zero
worker.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from collections import deque
from typing import Iterable

import numpy as np

from repro_torch.core.events import EventBus, make_bus
from repro_torch.core.graph import TaskGraph


@dataclasses.dataclass
class SimConfig:
    n_workers: int = 24
    workers_per_node: int = 24
    bandwidth: float = 6.8e9          # B/s (InfiniBand FDR56-ish)
    latency: float = 100e-6           # per message
    zero_worker: bool = False         # paper §IV-D
    server_scale: float = 1.0         # scale measured server cost
    balance_interval: float = 0.005   # min virtual time between balances
                                      # (balance runs after server batches —
                                      # paper §IV-C: on schedule/finish)
    timeout: float = 300.0            # paper: 300 s benchmark timeout
    seed: int = 0
    failures: tuple = ()              # ((virtual_time, wid), ...)
    events: object = None             # same knob as run_graph(events=...)
    controller: object = None         # schedule explorer hook: an object
                                      # with .width and .choose(n) that
                                      # picks among the n earliest pending
                                      # events (repro.analysis.explore)
    fixed_server_cost: float = None   # charge this instead of measured
                                      # wall time -> fully deterministic
                                      # event order for the explorer


@dataclasses.dataclass
class SimResult:
    makespan: float
    server_busy: float
    n_tasks: int
    timed_out: bool = False
    stats: dict = dataclasses.field(default_factory=dict)
    moves: int = 0
    failures_handled: int = 0

    @property
    def aot(self) -> float:
        """Average overhead+time per task (paper Fig. 7/8 metric)."""
        return self.makespan / max(self.n_tasks, 1)


class _Worker:
    __slots__ = ("wid", "queue", "busy", "data_at", "running")

    def __init__(self, wid: int):
        self.wid = wid
        self.queue: deque[int] = deque()   # assigned, not started
        self.busy = False                  # single slot (1 thread/worker)
        self.data_at: dict[int, float] = {}
        self.running: int = -1


class Simulator:
    def __init__(self, graph: TaskGraph, reactor, cfg: SimConfig):
        self.g = graph
        self.reactor = reactor
        self.cfg = cfg
        self.workers = [_Worker(w) for w in range(cfg.n_workers)]
        self.events: list = []  # heap of (time, seq, kind, payload)
        self._seq = 0
        self.server_free = 0.0
        self.server_busy_total = 0.0
        self.inbox: list = []
        self.finish_time = np.zeros(graph.n_tasks)
        self.started = np.zeros(graph.n_tasks, dtype=bool)
        self.moves = 0
        self.failures_handled = 0
        self.dead: set[int] = set()
        self.bus = make_bus(cfg.events)
        self._own_bus = not isinstance(cfg.events, EventBus)

    # ------------------------------------------------------------------
    def _push(self, t: float, kind: str, payload) -> None:
        self._seq += 1
        heapq.heappush(self.events, (t, self._seq, kind, payload))

    def _pop(self):
        """Next event — or, under an explorer controller, one of the
        ``width`` earliest events, chosen by the controller.  Causality
        is safe by construction: an event only exists in the heap once
        its cause ran, so any pop order the controller picks is a
        schedule the real cluster could have produced."""
        ctl = self.cfg.controller
        if ctl is None or len(self.events) <= 1:
            return heapq.heappop(self.events)
        k = min(len(self.events), ctl.width)
        cands = [heapq.heappop(self.events) for _ in range(k)]
        ev = cands.pop(ctl.choose(len(cands)))
        for c in cands:
            heapq.heappush(self.events, c)
        return ev

    def _to_server(self, item, now: float) -> None:
        self.inbox.append(item)
        self._push(max(now + self.cfg.latency, self.server_free),
                   "server", None)

    def _node(self, wid: int) -> int:
        return wid // self.cfg.workers_per_node

    def _charge_server(self, now: float, fn, *args):
        """Run a reactor call, measure real wall time, charge virtual
        time; returns (result, completion_time).  With
        ``fixed_server_cost`` set the charge is constant instead of
        measured, making the virtual timeline deterministic (the
        schedule explorer needs replayable heaps)."""
        t0 = time.perf_counter()
        result = fn(*args)
        if self.cfg.fixed_server_cost is not None:
            dt = self.cfg.fixed_server_cost
        else:
            dt = (time.perf_counter() - t0) * self.cfg.server_scale
        start = max(now, self.server_free)
        self.server_free = start + dt
        self.server_busy_total += dt
        return result, self.server_free

    def _dispatch(self, assignments, t: float) -> None:
        ev = self.bus
        for tid, wid in assignments:
            if ev is not None:
                # published at send time, like ServerCore: the server
                # decided before the message reaches the (maybe dying)
                # worker, and never targets a worker it knows is dead
                ev.publish("task-queued", tid=int(tid), wid=int(wid))
                ev.publish("task-dispatched", tid=int(tid), wid=int(wid))
            self._push(t + self.cfg.latency, "assign", (tid, wid))

    # ------------------------------------------------------------------
    def run(self) -> SimResult:
        cfg = self.cfg
        ev = self.bus
        if ev is not None:
            for w in self.workers:
                ev.publish("worker-join", wid=w.wid)
            ev.publish("epoch-open", eid=0, n_tasks=self.g.n_tasks,
                       lo=0, hi=self.g.n_tasks)
        self._last_balance = 0.0
        assignments, t_done = self._charge_server(0.0, self.reactor.start)
        self._dispatch(assignments, t_done)
        for ft, fw in cfg.failures:
            self._push(ft, "fail", fw)
        now = 0.0
        while self.events and not self.reactor.done():
            t, _, kind, payload = self._pop()
            # under a controller events can pop out of time order;
            # virtual time stays monotonic
            now = max(now, t)
            if now > cfg.timeout:
                return self._result(now, timed_out=True)
            if kind == "assign":
                tid, wid = payload
                if wid in self.dead:
                    # message to a dead worker: server notices and reroutes
                    out, td = self._charge_server(
                        now, self.reactor.handle_worker_lost, wid, [tid])
                    self._dispatch(out, td)
                    continue
                w = self.workers[wid]
                w.queue.append(tid)
                if cfg.zero_worker:
                    self._complete_zero(w, now)
                else:
                    self._start_transfers(w, tid, now)
                    self._try_start(w, now)
            elif kind == "xfer":
                tid, wid = payload
                if wid in self.dead:
                    continue
                w = self.workers[wid]
                w.data_at[tid] = now
                self._try_start(w, now)
            elif kind == "done":
                tid, wid = payload
                if wid in self.dead:
                    continue
                w = self.workers[wid]
                w.busy = False
                w.running = -1
                w.data_at[tid] = now
                self.finish_time[tid] = now
                self._to_server((tid, wid), now)
                self._try_start(w, now)
            elif kind == "server":
                # server drains its inbox as ONE batch once it is free —
                # completions that arrive while the server is busy batch up
                # naturally (this is where RSDS's batched array processing
                # pays off and Dask's per-message path does not)
                if not self.inbox:
                    continue
                if self.server_free > now + 1e-12:
                    self._push(self.server_free, "server", None)
                    continue
                batch, self.inbox = self.inbox, []
                if self.bus is not None:
                    for tid, wid in batch:
                        self.bus.publish("task-finished", tid=int(tid),
                                         wid=int(wid))
                out, td = self._charge_server(
                    now, self.reactor.handle_finished, batch)
                self._dispatch(out, td)
                # balance on schedule/finish events (paper §IV-C),
                # rate-limited by balance_interval of virtual time
                if not cfg.zero_worker \
                        and td - self._last_balance >= cfg.balance_interval:
                    self._last_balance = td
                    self._do_balance(td)
            elif kind == "balance":
                pass  # superseded: balancing is event-driven (see above)
            elif kind == "fail":
                self._fail_worker(payload, now)
        return self._result(now)

    # ------------------------------------------------------------------
    def _complete_zero(self, w: _Worker, now: float) -> None:
        """Zero worker: infinite speed, instant transfers (paper §IV-D)."""
        while w.queue:
            tid = w.queue.popleft()
            self.started[tid] = True
            self.finish_time[tid] = now
            self._to_server((tid, w.wid), now)

    def _start_transfers(self, w: _Worker, tid: int, now: float) -> None:
        for d in self.g.inputs_of(tid):
            d = int(d)
            if d in w.data_at:
                continue
            src = int(self.reactor_primary(d))
            if src == w.wid:
                w.data_at[d] = now
                continue
            lat = self.cfg.latency
            bw_time = (0.0 if self._node(src) == self._node(w.wid)
                       else float(self.g.sizes[d]) / self.cfg.bandwidth)
            avail = max(now, self.finish_time[d])
            w.data_at[d] = -1.0  # in flight
            self._push(avail + lat + bw_time, "xfer", (d, w.wid))
            # data now also lives on w (server learns placement)
            self.reactor.handle_placed(d, w.wid)

    def reactor_primary(self, tid: int) -> int:
        prim = getattr(self.reactor, "primary", None)
        if prim is not None:
            p = int(prim[tid])
            return p if p >= 0 else 0
        ts = self.reactor.tasks[self.reactor.key[tid]]
        return next(iter(ts["who_has"]), 0)

    def _try_start(self, w: _Worker, now: float) -> None:
        if w.busy:
            return
        for i, tid in enumerate(w.queue):
            ok = all(w.data_at.get(int(d), -1.0) >= 0.0
                     and w.data_at.get(int(d), now) <= now
                     for d in self.g.inputs_of(tid))
            if ok:
                del w.queue[i]
                w.busy = True
                w.running = tid
                self.started[tid] = True
                if self.bus is not None:
                    self.bus.publish("task-started", tid=int(tid),
                                     wid=w.wid)
                self._push(now + float(self.g.durations[tid]), "done",
                           (tid, w.wid))
                return

    def _do_balance(self, now: float) -> None:
        queued = {w.wid: list(w.queue) for w in self.workers
                  if w.queue and w.wid not in self.dead}
        if not queued:
            return
        moves, td = self._charge_server(now, self.reactor.rebalance, queued)
        for tid, new_wid in moves:
            old = None
            for w in self.workers:
                if tid in w.queue:
                    old = w
                    break
            if old is None:
                # retraction failed: already started (paper §IV-C)
                self.reactor.steal_failed(tid)
                if self.bus is not None:
                    self.bus.publish("steal-failed", tid=int(tid))
                continue
            old.queue.remove(tid)
            self.moves += 1
            if self.bus is not None:
                self.bus.publish("task-steal", tid=int(tid),
                                 wid=int(new_wid))
            self._dispatch([(tid, new_wid)], td)

    def _fail_worker(self, wid: int, now: float) -> None:
        """Node failure: running+queued tasks lost, data lost; the reactor
        resubmits (fault tolerance, DESIGN.md §2)."""
        w = self.workers[wid]
        self.dead.add(wid)
        lost = list(w.queue) + ([w.running] if w.running >= 0 else [])
        w.queue.clear()
        w.busy = False
        w.running = -1
        w.data_at.clear()
        self.failures_handled += 1
        if self.bus is not None:
            self.bus.publish("worker-lost", wid=wid, n_lost=len(lost))
        out, td = self._charge_server(
            now, self.reactor.handle_worker_lost, wid, lost)
        self._dispatch(out, td)

    def _result(self, now: float, timed_out: bool = False) -> SimResult:
        if self.bus is not None:
            self.bus.publish("epoch-close", eid=0,
                             error="timeout" if timed_out else None)
            if self._own_bus:
                self.bus.close()
        return SimResult(makespan=now, server_busy=self.server_busy_total,
                         n_tasks=self.g.n_tasks, timed_out=timed_out,
                         stats=self.reactor.stats.as_dict(),
                         moves=self.moves,
                         failures_handled=self.failures_handled)


def simulate(graph: TaskGraph, server: str = "rsds", scheduler: str = "ws",
             **kw) -> SimResult:
    """Convenience entry: server in {dask, rsds}, scheduler in
    {ws, random, heft}."""
    from repro_torch.core.array_reactor import ArrayReactor
    from repro_torch.core.reactor import ObjectReactor
    from repro_torch.core.schedulers import make_scheduler

    cfg = SimConfig(**kw)
    sched_name = {"ws": "dask_ws" if server == "dask" else "rsds_ws",
                  "random": "random", "heft": "heft"}[scheduler]
    sched = make_scheduler(sched_name)
    cls = ObjectReactor if server == "dask" else ArrayReactor
    reactor = cls(graph, sched, cfg.n_workers, cfg.workers_per_node,
                  cfg.seed)
    return Simulator(graph, reactor, cfg).run()
