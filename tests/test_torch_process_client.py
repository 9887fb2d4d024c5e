"""The port's Cluster/Client and memory subsystem on OS-process workers,
against ``repro.core``.

The process cases of ``tests/test_client.py`` and ``tests/test_store.py``,
run on the copy: ``run_graph`` equals ``Cluster`` + ``Client`` on every
server and scheduler; submit/map/gather, release, incremental
GraphBuilder chunks and epoch stats work through worker caches
(``GraphFutures.fetch_missing`` gathers what lives only there); a timed
out run leaves no worker process behind; a reduction whose live set
exceeds ``memory_limit`` spills in the workers and gives the reference's
value; the usage ledger feeds the scheduler; the released prefix compacts.
Every port ServerCore's event stream goes through
``repro.analysis.trace.ConformanceSink``.  No assertion reads the host
clock."""
import multiprocessing as mp
import time

import pytest

pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.core import benchgraphs as jbg  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import benchgraphs as tbg  # noqa: E402
from repro_torch.core.client import ReleasedKeyError  # noqa: E402
from torch_core_tasks import (_add, _agg, _leaf, _sq,  # noqa: E402
                              assert_conforms, attach_conformance,
                              fn_graph, fn_graph_want)

SERVERS = ["dask", "rsds"]
SCHEDS = ["ws", "random"]


@pytest.fixture(autouse=True)
def _conformance(monkeypatch):
    sinks = attach_conformance(monkeypatch)
    yield
    assert_conforms(sinks)


@pytest.mark.parametrize("sched", SCHEDS)
@pytest.mark.parametrize("server", SERVERS)
def test_run_graph_equals_cluster_client(server, sched):
    want = jcore.run_graph(fn_graph(jcore, 10), server=server,
                           scheduler=sched, runtime="thread", n_workers=3,
                           timeout=60.0)
    legacy = tcore.run_graph(fn_graph(tcore, 10), server=server,
                             scheduler=sched, runtime="process",
                             n_workers=3, timeout=60.0)
    assert not legacy.timed_out
    assert legacy.results == want.results == fn_graph_want(10)
    assert legacy.n_tasks == 11
    with tcore.Cluster(server=server, scheduler=sched, runtime="process",
                       n_workers=3, timeout=60.0) as c:
        futs = c.client.submit_graph(fn_graph(tcore, 10))
        assert futs.result(60.0) == legacy.results
    assert len(futs) == legacy.n_tasks


def test_submit_map_gather_release_and_builder_chunks():
    with tcore.Cluster(server="rsds", runtime="process", n_workers=3,
                       timeout=60.0) as c:
        f = c.client.submit(_agg, 2, 3)
        assert f.result(30.0) == 5
        fs = c.client.map(_sq, range(6))
        assert c.client.gather(fs, 30.0) == [0, 1, 4, 9, 16, 25]
        g = c.client.submit(_agg, f, 10, fs[3])
        assert g.result(30.0) == 5 + 10 + 9 and g.done()

        h = c.client.submit(_sq, 7)
        assert h.result(30.0) == 49
        h.release()
        with pytest.raises(ReleasedKeyError):
            h.result(1.0)
        deadline = time.perf_counter() + 5.0
        while time.perf_counter() < deadline and h.tid in c.runtime.results:
            time.sleep(0.01)
        assert h.tid not in c.runtime.results
        assert c.client.submit(_sq, 8).result(30.0) == 64

        gb = tcore.GraphBuilder("inc")
        futs = {}
        gb.add("sum", inputs=("a", "b", "c"), fn=_agg)
        gb.add("a", fn=_leaf, args=(1,))
        gb.add("b", fn=_leaf, args=(2,))
        futs.update(c.client.submit_update(gb))
        assert set(futs) == {"a", "b"} and gb.n_pending == 1
        gb.add("c", fn=_leaf, args=(4,))
        futs.update(c.client.submit_update(gb))
        assert futs["sum"].result(30.0) == 7
        gb.add("double", inputs=("sum",), fn=_sq)
        futs.update(c.client.submit_update(gb))
        assert futs["double"].result(30.0) == 49


def test_results_living_only_in_worker_caches_are_fetched():
    """p2p: a finished frame carries no value; ``fetch_missing`` gathers
    the values that live only in the workers' caches."""
    with tcore.Cluster(server="dask", runtime="process", n_workers=3,
                       timeout=60.0) as c:
        gf = c.client.submit_graph(tbg.value_reduction(12, fan=3))
        assert gf.wait(30.0)
        for t in range(gf._base, gf._base + len(gf)):
            c.runtime.results.pop(t, None)
        assert gf.fetch_missing(30.0)
        want = jcore.run_graph(jbg.value_reduction(12, fan=3),
                               server="dask", n_workers=3, timeout=60.0)
        assert gf.raw_results() == want.results


def test_epoch_stats_recorded():
    with tcore.Cluster(server="rsds", runtime="process", n_workers=2,
                       timeout=60.0) as c:
        g1 = c.client.submit_graph(tbg.merge(40, dur_ms=0.0))
        g2 = c.client.submit_graph(tbg.merge(40, dur_ms=0.0))
        assert g1.wait(30.0) and g2.wait(30.0)
        e1, e2 = g1.epoch, g2.epoch
    assert e1.n_tasks == e2.n_tasks == 41
    assert e1.makespan > 0 and e2.makespan > 0
    assert e1.error is None and e2.error is None


def test_timeout_terminates_all_worker_processes():
    children_before = set(mp.active_children())
    g = tbg.merge_slow(30, 2.0)
    reactor = tcore.ArrayReactor(g, tcore.make_scheduler("rsds_ws"), 2,
                                 simulate_codec=False)
    rt = tcore.ProcessRuntime(g, reactor, 2, timeout=0.5)
    r = rt.run()
    assert r.timed_out
    for p in rt.procs:
        assert not p.is_alive() and p.exitcode is not None
    assert set(mp.active_children()) <= children_before
    r = tcore.run_graph(g, server="rsds", runtime="process", n_workers=2,
                        timeout=0.5)
    assert r.timed_out
    assert set(mp.active_children()) <= children_before


# ---------------------------------------------------------------------------
# the process cases of tests/test_store.py
# ---------------------------------------------------------------------------

N_LEAVES, ELEMS = 12, 2048
LIMIT = 40_000
SLACK = ELEMS * 8 + 200


@pytest.mark.parametrize("server", SERVERS)
def test_memory_pressure_parity_matrix(server):
    want = jcore.run_graph(jbg.array_reduction(N_LEAVES, elems=ELEMS, fan=4),
                           server=server, n_workers=3, timeout=60.0)
    g = tbg.array_reduction(N_LEAVES, elems=ELEMS, fan=4)
    sink = g.n_tasks - 1
    assert want.results[sink] == float(ELEMS * N_LEAVES * (N_LEAVES + 1) / 2)
    for driver in ("selector", "asyncio"):
        r = tcore.run_graph(g, server=server, runtime="process",
                            n_workers=3, driver=driver, memory_limit=LIMIT,
                            timeout=60.0)
        assert not r.timed_out, driver
        assert r.results[sink] == want.results[sink], driver
        assert r.stats["spill_bytes"] > 0, driver
        assert r.stats["unspill_count"] > 0, driver
        assert r.stats["memory_limit"] == LIMIT, driver
        assert r.stats["peak_worker_bytes"] <= LIMIT + SLACK, driver
        assert r.epochs[0]["spill_bytes"] > 0, driver


def test_pressure_ledger_feeds_scheduler_and_hinting():
    with tcore.Cluster(server="rsds", runtime="process", n_workers=2,
                       memory_limit=10_000, high_water=0.5,
                       timeout=60.0) as c:
        rt = c.runtime
        rt._note_usage(0, (9_000, 9_000, 0, 0, 0, 0))
        assert 0 in rt.mem_pressured
        assert 0 in rt.reactor.scheduler.mem_pressured
        assert rt.peak_worker_bytes == 9_000
        rt._note_usage(0, (1_000, 9_000, 0, 0, 0, 0))
        assert 0 not in rt.mem_pressured
        assert 0 not in rt.reactor.scheduler.mem_pressured
        assert rt.peak_worker_bytes == 9_000


def test_compaction_on_process_runtime():
    with tcore.Cluster(server="rsds", runtime="process", n_workers=2,
                       compact_threshold=30, timeout=60.0) as c:
        for i in range(100):
            f = c.client.submit(_add, i, i)
            assert f.result(15.0) == 2 * i
            f.release()
        assert c.runtime.n_compactions >= 1
        assert c.runtime.g.tid_base >= 30
        assert c.runtime.run_stats()["n_compactions"] >= 1
