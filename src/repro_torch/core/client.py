"""Persistent Cluster/Client futures API (the paper's drop-in-server shape).

The paper's RSDS is a *server* that Dask clients connect to and feed work
incrementally; a one-shot ``run_graph`` cannot express that (every run
pays worker startup, and multi-graph scenarios — training loops, serving —
restart the pool between graphs).  This module is the missing surface:

* :class:`Cluster` — owns a persistent server loop + worker pool on the
  wall-clock thread engine (``runtime="thread"``; ``"process"`` raises
  ``NotImplementedError``: the port has no process runtime yet).
  Workers start once; any number of graph epochs are submitted against
  the warm pool.
* :class:`Client` — ``submit(fn, *args)`` / ``map`` / ``submit_graph`` /
  ``submit_update`` (incremental :class:`repro_torch.core.graph.GraphBuilder`
  chunks), plus ``gather`` and ``release``.
* :class:`Future` — a handle on one task's result with explicit key
  lifetime: ``result()`` blocks on the owning epoch, ``release()`` drops
  the client hold so the reactor's refcount GC can reclaim the value.

``run_graph`` stays as a thin back-compat wrapper::

    with Cluster(server="rsds", runtime="thread", n_workers=8) as c:
        futs = c.client.submit_graph(graph)     # epoch 1
        print(futs.result())                    # {tid: value}
        more = c.client.submit_graph(graph2)    # epoch 2, warm pool
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Iterable, Sequence

from repro_torch.core.graph import GraphBuilder, Task, TaskGraph
from repro_torch.core.runtime import RunResult, ThreadRuntime


class ClusterClosed(RuntimeError):
    """Operation on a cluster after ``close()``."""


class ReleasedKeyError(KeyError):
    """The future's key was explicitly released; its value is gone."""


class _BoundCall:
    """Picklable closure substitute: literal arguments bound at submit
    time, dependency results spliced into ``positions`` at call time.
    (A real closure would not survive the process runtime's pickled
    ``update-graph`` frames.)"""

    def __init__(self, fn: Callable, literals: Sequence[Any],
                 positions: Sequence[int]):
        self.fn = fn
        self.literals = list(literals)
        self.positions = list(positions)

    def __call__(self, *dep_vals):
        merged = list(self.literals)
        for pos, val in zip(self.positions, dep_vals):
            merged[pos] = val
        return self.fn(*merged)


class Future:
    """Handle on one submitted task, addressed by a namespaced key."""

    __slots__ = ("_cluster", "key", "tid", "eid")

    def __init__(self, cluster: "Cluster", key: Any, tid: int, eid: int):
        self._cluster = cluster
        self.key = key
        self.tid = tid
        self.eid = eid

    def done(self) -> bool:
        return self._cluster.runtime.epoch(self.eid).done_evt.is_set()

    def result(self, timeout: float | None = None) -> Any:
        """Block until the owning epoch completes; returns the task's
        value (None for duration-model tasks, which produce no value)."""
        c = self._cluster
        rt = c.runtime
        # a tid below the compaction base was released long ago and its
        # rows are gone (the _released set is pruned as the base moves)
        if self.tid in c._released or self.tid < rt.g.tid_base:
            raise ReleasedKeyError(self.key)
        e = rt.epoch(self.eid)
        if not e.done_evt.wait(timeout):
            raise TimeoutError(
                f"future {self.key!r} not done within {timeout}s")
        if e.error is not None:
            raise e.error
        if self.tid < rt.g.tid_base:    # released elsewhere, compacted
            raise ReleasedKeyError(self.key)
        # thread workers put every result into the server's own store
        return rt.results.get(self.tid)

    def release(self) -> None:
        """Drop the client hold on this key: the reactor may GC the value
        (and the process runtime purges worker caches over the wire)."""
        c = self._cluster
        with c._lock:
            if self.tid in c._released:
                return
            c._released.add(self.tid)
            c._prune_released()
        c.runtime.release_tasks([self.tid])

    def __repr__(self) -> str:
        state = "done" if self.done() else "pending"
        return f"<Future {self.key!r} tid={self.tid} {state}>"


class GraphFutures:
    """Futures over one ``submit_graph`` epoch.  Indexable by the
    submitted graph's original tids; ``result()`` returns the same
    ``{tid: value}`` mapping a one-shot ``run_graph`` reports."""

    def __init__(self, cluster: "Cluster", base: int, n_tasks: int,
                 eid: int, namespace: str):
        self._cluster = cluster
        self._base = base
        self._n = n_tasks
        self.eid = eid
        self.namespace = namespace

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, orig_tid: int) -> Future:
        if not 0 <= orig_tid < self._n:
            raise IndexError(orig_tid)
        return Future(self._cluster, f"{self.namespace}:{orig_tid}",
                      self._base + orig_tid, self.eid)

    def wait(self, timeout: float | None = None) -> bool:
        return self._cluster.runtime.wait_epoch(self.eid, timeout)

    def result(self, timeout: float | None = None) -> dict[int, Any]:
        if not self.wait(timeout):
            raise TimeoutError(
                f"graph epoch {self.eid} not done within {timeout}s")
        e = self._cluster.runtime.epoch(self.eid)
        if e.error is not None:
            raise e.error
        return self.raw_results()

    def raw_results(self) -> dict[int, Any]:
        """{original tid: value} for every task that produced a value
        (duration-model tasks produce none), without waiting."""
        res = self._cluster.runtime.results
        return {i: res[self._base + i] for i in range(self._n)
                if self._base + i in res}

    def release(self) -> None:
        c = self._cluster
        with c._lock:
            tids = [t for t in range(self._base, self._base + self._n)
                    if t not in c._released]
            c._released.update(tids)
            c._prune_released()
        if tids:
            c.runtime.release_tasks(tids)

    @property
    def epoch(self):
        return self._cluster.runtime.epoch(self.eid)


class Client:
    """Submission surface over a :class:`Cluster`."""

    def __init__(self, cluster: "Cluster"):
        self.cluster = cluster

    # ------------------------------------------------------------------
    def submit(self, fn: Callable, *args, key: Any = None,
               duration: float = 0.0, output_size: float = 1024.0
               ) -> Future:
        """Submit one call; ``Future`` arguments become dependencies and
        their results are spliced into the call in place."""
        c = self.cluster
        with c._lock:
            c._check_open()
            tid = c._next_tid
            dep_pos = [i for i, a in enumerate(args)
                       if isinstance(a, Future)]
            deps = tuple(args[i].tid for i in dep_pos)
            for d in deps:
                if d in c._released or d < c.runtime.g.tid_base:
                    raise ReleasedKeyError(
                        f"dependency tid {d} was released")
            if dep_pos:
                literals = [None if isinstance(a, Future) else a
                            for a in args]
                task = Task(tid, deps, duration, output_size,
                            fn=_BoundCall(fn, literals, dep_pos), args=())
            elif args:
                task = Task(tid, (), duration, output_size,
                            fn=fn, args=tuple(args))
            else:
                task = Task(tid, (), duration, output_size, fn=fn, args=())
            key = key if key is not None else f"submit-{tid}"
            eid = c.runtime.submit_tasks([task], retain=True)
            c._next_tid += 1
        return Future(c, key, tid, eid)

    def map(self, fn: Callable, seq: Iterable[Any]) -> list[Future]:
        """One task per item, submitted together as a single epoch."""
        c = self.cluster
        with c._lock:
            c._check_open()
            base = c._next_tid
            items = list(seq)
            tasks = [Task(base + i, (), fn=fn, args=(x,))
                     for i, x in enumerate(items)]
            if not tasks:
                return []
            eid = c.runtime.submit_tasks(tasks, retain=True)
            c._next_tid += len(tasks)
        return [Future(c, f"map-{base + i}", base + i, eid)
                for i in range(len(items))]

    def submit_graph(self, graph: TaskGraph) -> GraphFutures:
        """Submit a whole :class:`TaskGraph` as one epoch on the warm
        pool; tids are namespaced into the cluster's global tid space."""
        c = self.cluster
        with c._lock:
            c._check_open()
            base = c._next_tid
            ns = f"{graph.name}#{c._n_graphs}"
            c._n_graphs += 1
            tasks = [Task(base + t.tid,
                          tuple(base + int(d) for d in t.inputs),
                          t.duration, t.output_size, t.fn, t.args,
                          name=f"{ns}:{t.tid}")
                     for t in graph.tasks]
            eid = c.runtime.submit_tasks(tasks, retain=True)
            c._next_tid += len(tasks)
        return GraphFutures(c, base, graph.n_tasks, eid, ns)

    def submit_update(self, builder: GraphBuilder) -> dict[Any, Future]:
        """Flush a :class:`GraphBuilder`'s resolvable tasks as a new
        epoch (tasks whose dependencies are still unknown stay buffered
        for a later call) and return a future per flushed key."""
        c = self.cluster
        with c._lock:
            c._check_open()
            for d in builder._pending.values():
                for k in d.inputs:
                    tid = builder.key_to_tid.get(k)
                    if tid is not None and (tid in c._released
                                            or tid < c.runtime.g.tid_base):
                        raise ReleasedKeyError(
                            f"dependency {k!r} was released")
            tasks, flushed = builder.flush(base=c._next_tid)
            if not tasks:
                return {}
            eid = c.runtime.submit_tasks(tasks, retain=True)
            c._next_tid += len(tasks)
        return {k: Future(c, k, tid, eid) for k, tid in flushed.items()}

    # ------------------------------------------------------------------
    def gather(self, futures: Sequence[Future],
               timeout: float | None = None) -> list[Any]:
        return [f.result(timeout) for f in futures]

    def release(self, *futures: Future) -> None:
        for f in futures:
            f.release()


class Cluster:
    """Persistent server loop + worker pool on the wall-clock thread
    engine.

    The pool starts on construction and survives any number of graph
    epochs — back-to-back graphs reuse warm workers, so per-run startup
    cost stops polluting overhead measurements (the reason the paper's
    RSDS is a long-lived server in the first place).

    ``Cluster(events=True)`` turns on the structured observability feed
    (:mod:`repro_torch.core.events`); ``events=<path>`` also records it to a
    rotating JSONL log.  :attr:`events` exposes the live bus and
    :meth:`observe` snapshots the server state for dashboards.
    """

    def __init__(self, server: str = "rsds", scheduler: str = "ws",
                 n_workers: int = 8, runtime: str = "thread",
                 seed: int = 0, name: str = "cluster",
                 autostart: bool = True, **kw):
        from repro_torch.core.array_reactor import ArrayReactor
        from repro_torch.core.reactor import ObjectReactor
        from repro_torch.core.schedulers import make_scheduler

        # server-architecture axis: server="selector"|"asyncio"|"uvloop"
        # is shorthand for the RSDS wire on that event-loop driver
        # (forces the process runtime); driver= composes with any wire
        driver = kw.pop("driver", None)
        if server in ("selector", "asyncio", "uvloop"):
            driver = driver or server
            server = "rsds"
        if driver is not None and driver != "inproc":
            runtime = "process"
        sched_name = {"ws": "dask_ws" if server == "dask" else "rsds_ws",
                      "random": "random", "heft": "heft"}[scheduler]
        sched = make_scheduler(sched_name)
        cls = ObjectReactor if server == "dask" else ArrayReactor
        self.graph = TaskGraph([], name=name)
        self.server = server
        self.runtime_kind = runtime
        self.n_workers = n_workers
        if runtime == "thread":
            self.reactor = cls(self.graph, sched, n_workers, seed=seed)
            self.runtime = ThreadRuntime(self.graph, self.reactor,
                                         n_workers, **kw)
        elif runtime == "process":
            raise NotImplementedError(
                "Cluster(runtime='process'): not ported yet")
        else:
            raise ValueError(
                f"unknown runtime {runtime!r} (want thread|process)")
        self.server_driver = self.runtime.driver.name
        self._lock = threading.RLock()
        self._next_tid = 0
        self._released: set[int] = set()
        self._pruned_base = 0
        self._n_graphs = 0
        self._closed = False
        self.client = Client(self)
        if autostart:
            self.start()

    def start(self) -> "Cluster":
        """Bring the pool up (no-op when already started; only needed
        with ``autostart=False``, e.g. to instrument the runtime before
        workers spawn)."""
        self._check_open()
        self.runtime.start()
        return self

    # ------------------------------------------------------------------
    def _check_open(self) -> None:
        if self._closed:
            raise ClusterClosed("cluster is closed")

    def _prune_released(self) -> None:
        """Shed released tids that fell below the compaction base (held
        lock required).  The base only grows, so pruning against a
        momentarily-stale read of it is safe; rescanning is skipped
        while the base has not advanced (a stuck base must not make
        every release O(len(_released)))."""
        if len(self._released) > 4096:
            base = self.runtime.g.tid_base
            if base > self._pruned_base:
                self._released = {t for t in self._released if t >= base}
                self._pruned_base = base

    @property
    def n_tasks(self) -> int:
        return self._next_tid

    @property
    def events(self):
        """The live :class:`repro_torch.core.events.EventBus` (None unless the
        cluster was built with ``events=``)."""
        return self.runtime.events

    def observe(self) -> dict:
        """Best-effort live snapshot of the server state (see
        :meth:`repro_torch.core.server.ServerCore.observe`)."""
        return self.runtime.observe()

    def trace_analysis(self):
        """Build a :class:`repro_torch.core.tracing.TraceAnalysis` from the
        live event ring.  Requires the cluster to have been built with
        ``events=`` (and ``tracing=True`` for worker-side segments —
        without it the spans carry server-side boundaries only)."""
        from .tracing import TraceAnalysis
        bus = self.events
        if bus is None:
            raise RuntimeError(
                "trace_analysis() needs events= (and tracing=True)")
        return TraceAnalysis.from_events(bus.since(-1))

    def run_result(self, gf: GraphFutures,
                   timed_out: bool = False) -> RunResult:
        """Derive a back-compat :class:`RunResult` for one graph epoch
        from the cluster's per-epoch stats (the ``run_graph`` path)."""
        rt = self.runtime
        e = rt.epoch(gf.eid)
        if e.done_evt.is_set() and not timed_out and e.error is None:
            makespan = e.makespan
        else:
            makespan = time.perf_counter() - (e.t_submit or e.t_ingest)
        stats = rt.run_stats()     # reactor + driver wire/codec meters
        return RunResult(makespan=makespan, n_tasks=len(gf),
                         server_busy=rt.server_busy, stats=stats,
                         results=gf.raw_results(),
                         timed_out=timed_out or e.error is not None,
                         epochs=rt.epoch_dicts())

    def close(self, force: bool = False) -> None:
        """Tear the pool down: stops the server loop and terminates/joins
        every worker (``force`` skips the graceful drain)."""
        if self._closed:
            return
        self._closed = True
        self.runtime.shutdown(force=force)

    def __enter__(self) -> "Cluster":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(force=exc_type is not None)

    def __repr__(self) -> str:
        state = "closed" if self._closed else "open"
        return (f"<Cluster {self.server}/{self.runtime_kind} "
                f"workers={self.n_workers} tasks={self._next_tid} {state}>")
