"""The port's copy of the task runtime (``repro_torch.core``,
``repro_torch.ft``) against ``repro.core`` on ``runtime="thread"``.

The same graphs, built in both packages from one spec (a chain, a fan-in
merge and a reduction tree of numpy payloads), run on both servers
(``rsds``, ``dask``) under three schedulers and must give equal results,
with every task finished and the copy's event stream free of protocol
findings (``repro.analysis.trace.ConformanceSink``; the reference's runs
get the same sink from ``tests/conftest.py``).  The Client surface,
spilling under a tiny ``memory_limit``, lineage recompute after
``fail_worker`` and ``ElasticController.scale_up`` are held against the
reference the same way.  No assertion reads the host clock."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.analysis.trace import ConformanceSink  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import client as tclient  # noqa: E402
from repro_torch.core.events import EventBus  # noqa: E402
from repro_torch.ft import faults as tfaults  # noqa: E402

SERVERS = ["rsds", "dask"]
SCHEDS = ["ws", "random", "heft"]
GRAPHS = ["chain", "merge", "tree"]


def _leaf(seed):
    return np.arange(8, dtype=np.float64) * (seed + 1) - seed


def _combine(*xs):
    out = np.zeros(8)
    for k, x in enumerate(xs):
        out = out + (k + 1) * x
    return out * 0.5 + 1.0


def _spec(kind: str) -> list[tuple[int, ...]]:
    """Each task's inputs, in tid order: a chain of 50, a merge of 49
    sources into one sink, a binary reduction tree over 32 leaves."""
    if kind == "chain":
        return [()] + [(i - 1,) for i in range(1, 50)]
    if kind == "merge":
        return [()] * 49 + [tuple(range(49))]
    spec: list[tuple[int, ...]] = [()] * 32
    level = list(range(32))
    while len(level) > 1:
        nxt = []
        for a, b in zip(level[::2], level[1::2]):
            spec.append((a, b))
            nxt.append(len(spec) - 1)
        level = nxt
    return spec


def _graph(pkg, kind: str):
    """The spec's graph as ``pkg``'s TaskGraph (pkg: repro.core or
    repro_torch.core)."""
    tasks = [pkg.Task(i, ins, duration=1e-3, output_size=96.0,
                      fn=_combine if ins else _leaf,
                      args=() if ins else (i,))
             for i, ins in enumerate(_spec(kind))]
    return pkg.TaskGraph(tasks, name=kind)


def _sink():
    bus = EventBus()
    sink = ConformanceSink(path="<repro_torch.core>")
    bus.add_sink(sink)
    return bus, sink


def _assert_conforms(sink):
    assert sink.n_events > 0
    assert not sink.findings, [f"{f.key}: {f.message}"
                               for f in sink.findings[:10]]
    assert sink.n_internal_errors == 0


def _same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("sched", SCHEDS)
@pytest.mark.parametrize("server", SERVERS)
@pytest.mark.parametrize("kind", GRAPHS)
def test_copy_runs_graphs_as_the_reference(kind, server, sched):
    want = jcore.run_graph(_graph(jcore, kind), server=server,
                           scheduler=sched, n_workers=3, timeout=60.0)
    bus, sink = _sink()
    got = tcore.run_graph(_graph(tcore, kind), server=server,
                          scheduler=sched, n_workers=3, timeout=60.0,
                          events=bus)
    n = len(_spec(kind))
    for res in (want, got):
        assert not res.timed_out and res.n_tasks == n
        assert len(res.results) == n
        assert sum(res.stats["tasks_per_worker"].values()) == n
    _same(got.results, want.results)
    assert bus.counts["task-finished"] == n
    _assert_conforms(sink)


def _client_script(pkg, client_mod, server):
    """Submit, map, gather, release and GraphBuilder forward references;
    returns what a user would observe."""
    out = {}
    with pkg.Cluster(server=server, n_workers=2) as c:
        cl = c.client
        a = cl.submit(np.add, np.arange(4.0), 1.0)
        b = cl.submit(np.multiply, a, 3.0)
        d = cl.submit(np.subtract, b, a, key="diff")
        out["gather"] = [x.tolist() for x in cl.gather([a, b, d])]
        out["key"] = d.key
        fs = cl.map(np.square, [np.arange(3.0) + i for i in range(4)])
        out["map"] = [x.tolist() for x in cl.gather(fs)]
        cl.release(b)
        try:
            b.result(timeout=10)
            out["released"] = "value"
        except client_mod.ReleasedKeyError:
            out["released"] = "ReleasedKeyError"
        try:
            cl.submit(np.negative, b)
            out["dep_on_released"] = "submitted"
        except client_mod.ReleasedKeyError:
            out["dep_on_released"] = "ReleasedKeyError"
        gb = pkg.GraphBuilder()
        gb.add("sum", ["x", "y"], fn=np.add)     # forward references
        gb.add("x", fn=np.ones, args=(3,))
        first = cl.submit_update(gb)              # "sum" waits for "y"
        out["first_flush"] = sorted(first)
        out["pending"] = gb.n_pending
        gb.add("y", fn=np.arange, args=(3.0,))
        second = cl.submit_update(gb)
        out["second_flush"] = sorted(second)
        out["sum"] = second["sum"].result(timeout=10).tolist()
        out["n_tasks"] = c.n_tasks
    try:
        cl.submit(np.ones, 1)
        out["closed"] = "submitted"
    except client_mod.ClusterClosed:
        out["closed"] = "ClusterClosed"
    cyc = pkg.GraphBuilder()
    cyc.add("p", ["q"])
    cyc.add("q", ["p"])
    with pytest.raises(ValueError, match="unresolved dependencies"):
        cyc.build()
    return out


@pytest.mark.parametrize("server", SERVERS)
def test_client_surface_matches_reference(server):
    from repro.core import client as jclient
    want = _client_script(jcore, jclient, server)
    got = _client_script(tcore, tclient, server)
    assert got == want
    assert got["released"] == "ReleasedKeyError"
    assert got["first_flush"] == ["x"] and got["second_flush"] == ["sum", "y"]


def test_process_runtime_is_not_ported():
    """The process runtime was the part of ``repro.core`` this copy
    lacked; it is copied now, so ``Cluster(runtime="process")`` and the
    ``server="asyncio"`` shorthand run (forked here: the graph's task
    functions live in this module, which a spawned worker would import
    with torch) and give the reference's results."""
    with tcore.Cluster(runtime="process", n_workers=1,
                       start_method="fork", timeout=60.0) as c:
        assert c.client.submit(np.add, 2.0, 3.0).result(30.0) == 5.0
    want = jcore.run_graph(_graph(jcore, "chain"), n_workers=2, timeout=60.0)
    got = tcore.run_graph(_graph(tcore, "chain"), server="asyncio",
                          n_workers=2, start_method="fork", timeout=60.0)
    assert not got.timed_out and got.stats["server_driver"] == "asyncio"
    _same(got.results, want.results)


@pytest.mark.parametrize("server", SERVERS)
def test_tiny_memory_limit_spills_and_gives_the_same_results(server):
    """A 2 KiB limit holds a few of the tree's 64-byte arrays: the shared
    store spills the rest to disk and unspills them on access.  Results
    equal the reference's under the same limit and an unlimited run."""
    runs = {}
    for name, pkg in (("ref", jcore), ("copy", tcore)):
        for limit in (2048, None):
            with pkg.Cluster(server=server, n_workers=1,
                             memory_limit=limit) as c:
                res = c.client.submit_graph(_graph(pkg, "tree")).result(
                    timeout=60)
                runs[name, limit] = (res, c.runtime.memory_stats())
    for key, (res, mem) in runs.items():
        _same(res, runs["ref", None][0])
        assert (mem["spill_count"] > 0) == (key[1] is not None), key
    assert runs["copy", 2048][1]["unspill_count"] > 0


def _lineage_run(pkg):
    """A chain whose 11th task fails the worker running it: that worker's
    queue and running task are resubmitted, and the chain's released
    prefix is recomputed by lineage (the failed worker held its head)."""
    runs = [0] * 50
    box = {}

    def step(i):
        def fn(*xs):
            runs[i] += 1
            if i == 10 and runs[i] == 1:
                rt = box["rt"]
                wid = next(w for w, t in list(rt.running.items()) if t == 10)
                rt.fail_worker(wid)
            return _combine(*xs) if xs else _leaf(i)
        return fn

    g = pkg.TaskGraph([pkg.Task(i, ins, fn=step(i))
                       for i, ins in enumerate(_spec("chain"))])
    reactor = pkg.ArrayReactor(g, pkg.make_scheduler("rsds_ws"), 2)
    rt = box["rt"] = pkg.ThreadRuntime(g, reactor, 2)
    res = rt.run()
    return res, runs, rt


def test_fail_worker_recomputes_by_lineage():
    want, jruns, _ = _lineage_run(jcore)
    got, truns, rt = _lineage_run(tcore)
    assert not got.timed_out and not want.timed_out
    _same(got.results, want.results)
    assert len(rt.dead) == 1
    # the head of the chain ran again, as in the reference
    assert truns[0] >= 2 and jruns[0] >= 2
    assert all(r >= 1 for r in truns)


def test_kill_worker_after_and_elastic_scale_up():
    """``kill_worker_after`` arms a timer on ``fail_worker``;
    ``ElasticController.scale_up`` adds workers mid-run (called from the
    first task, so work remains) and they take stolen tasks."""
    g = tcore.TaskGraph(
        [tcore.Task(0, (), fn=lambda: _grow(box))]
        + [tcore.Task(i, (), fn=_slow_leaf, args=(i,)) for i in range(1, 120)]
        + [tcore.Task(120, tuple(range(120)), fn=_combine)])
    reactor = tcore.ArrayReactor(g, tcore.make_scheduler("rsds_ws"), 2)
    rt = tcore.ThreadRuntime(g, reactor, 2, balance_interval=0.005)
    box = {"ec": tfaults.ElasticController(rt)}
    res = rt.run()
    assert not res.timed_out and rt.n_workers == 5
    assert box["new"] == [2, 3, 4]
    per_worker = res.stats["tasks_per_worker"]
    assert sum(per_worker.values()) == 121
    assert sum(per_worker.get(w, 0) for w in box["new"]) > 0
    want = jcore.run_graph(jcore.TaskGraph(
        [jcore.Task(0, (), fn=_leaf, args=(0,))]
        + [jcore.Task(i, (), fn=_slow_leaf, args=(i,)) for i in range(1, 120)]
        + [jcore.Task(120, tuple(range(120)), fn=_combine)]), n_workers=2)
    np.testing.assert_array_equal(res.results[120], want.results[120])
    with pytest.raises(NotImplementedError, match="thread runtimes only"):
        tfaults.ElasticController(object())
    timer = tfaults.kill_worker_after(rt, 0, 0.0)
    timer.join(timeout=10)
    assert not timer.is_alive() and 0 in rt.dead


def _grow(box):
    box["new"] = box["ec"].scale_up(3)
    return _leaf(0)


def _slow_leaf(i):
    import time
    time.sleep(0.002)
    return _leaf(i)
