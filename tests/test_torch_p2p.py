"""The port's worker-to-worker data plane and batched control plane
against ``repro.core``.

The cases of ``tests/test_p2p.py`` and ``tests/test_batching.py``, run on
the copy: p2p and server-relay runs give the reference's values with no
payload byte through the server when p2p is on; a killed holder's
consumer parks on fetch-failed and completes by lineage; gathers of
never-cached keys fail, gathers whose holder died are retried, gather
replies never re-enter completion accounting, and unheld keys leave the
worker caches; the batch envelope changes frame counts, never results.
Every port ServerCore's event stream goes through
``repro.analysis.trace.ConformanceSink``.  No assertion reads the host
clock: the waits below poll the server's state until a deadline, and
assert on that state."""
import asyncio
import pickle
import threading
import time

import pytest

pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.core import benchgraphs as jbg  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import benchgraphs as tbg  # noqa: E402
from repro_torch.core import messages as tmsg  # noqa: E402
from repro_torch.core import transport as tp  # noqa: E402
from torch_core_tasks import (_leaf, _maybe, _plus1, _sq,  # noqa: E402
                              assert_conforms, attach_conformance,
                              fn_graph, fn_graph_want)

SERVERS = ["dask", "rsds"]
DRIVERS = ["selector", "asyncio"]


@pytest.fixture(autouse=True)
def _conformance(monkeypatch):
    sinks = attach_conformance(monkeypatch)
    yield
    assert_conforms(sinks)


def _poll(pred, seconds=5.0):
    deadline = time.perf_counter() + seconds
    while time.perf_counter() < deadline and not pred():
        time.sleep(0.01)


# ---------------------------------------------------------------------------
# the p2p parity matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transport", ["pipe", "socket"])
@pytest.mark.parametrize("server", SERVERS)
def test_p2p_parity_and_relay_bytes(server, transport):
    """p2p and relay give the reference's values on both codecs and both
    transports; with p2p on, no payload byte rides through the server."""
    want = jcore.run_graph(jbg.value_reduction(12, fan=3), server=server,
                           n_workers=3, timeout=60.0)
    assert not want.timed_out
    g = tbg.value_reduction(12, fan=3)
    kw = dict(server=server, runtime="process", n_workers=3,
              transport=transport, start_method="fork", timeout=60.0)
    relay = tcore.run_graph(g, p2p=False, **kw)
    p2p = tcore.run_graph(g, p2p=True, **kw)
    assert not relay.timed_out and not p2p.timed_out
    assert relay.results == p2p.results == want.results
    assert relay.stats["relay_bytes"] > 0 and relay.stats["p2p_bytes"] == 0
    assert p2p.stats["relay_bytes"] == 0
    assert p2p.stats["p2p_bytes"] > 0 and p2p.stats["p2p_fetches"] > 0
    assert p2p.epochs[0]["p2p_bytes"] > 0
    assert p2p.epochs[0]["relay_bytes"] == 0


@pytest.mark.parametrize("server", SERVERS)
def test_p2p_fn_task_with_duration_dep_completes(server):
    """A callable fed by a duration-model task runs with None for it."""
    graphs = {pkg: pkg.TaskGraph([pkg.Task(0, (), duration=0.001),
                                  pkg.Task(1, (0,), fn=_maybe)],
                                 name="mixed") for pkg in (jcore, tcore)}
    want = jcore.run_graph(graphs[jcore], server=server, n_workers=2,
                           timeout=30.0)
    got = tcore.run_graph(graphs[tcore], server=server, runtime="process",
                          n_workers=2, p2p=True, timeout=30.0)
    assert not want.timed_out and not got.timed_out
    assert got.results == want.results == {1: 0}


# ---------------------------------------------------------------------------
# holder death, gathers, caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("driver", DRIVERS)
@pytest.mark.parametrize("server", SERVERS)
def test_fetch_fallback_on_holder_death(server, driver):
    with tcore.Cluster(server=server, runtime="process", n_workers=3,
                       driver=driver, transport="socket",
                       timeout=60.0) as c:
        f = c.client.submit(_leaf, 123)
        assert f.result(30.0) == 123
        holders = c.runtime._holders(f.tid)
        assert holders
        c.runtime.results.pop(f.tid, None)
        c.runtime.fail_worker(holders[0])
        g = c.client.submit(_plus1, f)
        assert g.result(30.0) == 124
        assert any(w != holders[0] for w in c.runtime._holders(f.tid))


@pytest.mark.parametrize("driver", DRIVERS)
def test_gather_never_cached_key_fails(driver):
    """Duration-model tasks cache no value: a gather for one comes back
    absent and the fetch fails (instead of spinning its timeout)."""
    with tcore.Cluster(server="rsds", runtime="process", n_workers=2,
                       driver=driver, transport="socket",
                       simulate_durations=False, timeout=60.0) as c:
        futs = c.client.submit_graph(tbg.merge(20, dur_ms=0.0))
        assert futs.wait(30.0)
        assert not c.runtime.fetch([futs[0].tid], timeout=10.0)
        assert futs[0].tid in c.runtime._gather_failed


def test_p2p_gather_refetches_from_worker_cache():
    with tcore.Cluster(server="rsds", runtime="process", n_workers=2,
                       transport="socket", timeout=60.0) as c:
        f = c.client.submit(_sq, 6)
        assert f.result(30.0) == 36
        c.runtime.results.pop(f.tid)
        assert f.result(30.0) == 36
        assert c.runtime.gather_bytes > 0


@pytest.mark.parametrize("server", SERVERS)
def test_gather_retries_after_holder_death(server):
    with tcore.Cluster(server=server, runtime="process", n_workers=2,
                       transport="socket", timeout=60.0) as c:
        f = c.client.submit(_sq, 7)
        assert f.result(30.0) == 49
        holders = c.runtime._holders(f.tid)
        c.runtime.results.pop(f.tid, None)
        c.runtime.fail_worker(holders[0])
        assert f.result(30.0) == 49


@pytest.mark.parametrize("server", SERVERS)
def test_gather_reply_no_double_completion(server):
    with tcore.Cluster(server=server, runtime="process", n_workers=2,
                       transport="socket", timeout=60.0) as c:
        f = c.client.submit(_sq, 5)
        assert f.result(30.0) == 25
        for _ in range(3):
            c.runtime.results.pop(f.tid)
            assert f.result(30.0) == 25
        assert c.runtime.epoch(f.eid).remaining == 0
        assert f.tid in c.runtime._completed
        sched = c.reactor.scheduler
        _poll(lambda: not any(sched.loads))
        assert not any(sched.loads), sched.loads


def test_worker_cache_evicts_unheld_keys():
    with tcore.Cluster(server="rsds", runtime="process", n_workers=2,
                       transport="socket", timeout=60.0) as c:
        rt = c.runtime
        with c._lock:
            base = c._next_tid
            eid = rt.submit_tasks(
                [tcore.Task(base, (), fn=_leaf, args=(11,)),
                 tcore.Task(base + 1, (base,), fn=_plus1)], retain=False)
            c._next_tid += 2
        assert rt.wait_epoch(eid, 30.0)
        _poll(lambda: rt.reactor.is_released(base))
        assert rt.reactor.is_released(base)
        rt.results.pop(base, None)
        assert not rt.fetch([base], timeout=5.0)
        rt.results.pop(base + 1, None)
        assert rt.fetch([base + 1], timeout=10.0)
        assert rt.results[base + 1] == 12


# ---------------------------------------------------------------------------
# batching: the envelope changes sends, never results
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("server", SERVERS)
@pytest.mark.parametrize("driver", DRIVERS)
def test_parity_matrix_batching_on(driver, server):
    r = tcore.run_graph(fn_graph(tcore, 10), server=server,
                        runtime="process", driver=driver, n_workers=3,
                        timeout=60.0)
    assert not r.timed_out
    assert r.results == fn_graph_want(10)
    assert r.stats["batching"] is True
    assert r.stats["relay_bytes"] == 0
    assert r.stats["server_driver"] == driver


@pytest.mark.parametrize("server", SERVERS)
def test_batching_off_bit_identical_results(server):
    g = tbg.merge(150)
    on = tcore.run_graph(g, server=server, runtime="process", n_workers=3,
                         zero_worker=True, batching=True, timeout=60.0)
    off = tcore.run_graph(g, server=server, runtime="process", n_workers=3,
                          zero_worker=True, batching=False, timeout=60.0)
    assert not on.timed_out and not off.timed_out
    assert pickle.dumps(on.results) == pickle.dumps(off.results)
    assert on.stats["frames_coalesced"] > 0
    assert off.stats["frames_coalesced"] == 0
    assert on.stats["n_frames_sent"] < off.stats["n_frames_sent"]
    if server == "dask":
        assert on.stats["n_frames_sent"] * 10 <= off.stats["n_frames_sent"]


def test_batching_meters_on_every_surface():
    with tcore.Cluster(server="rsds", runtime="process", n_workers=2,
                       simulate_durations=False, timeout=60.0) as c:
        c.client.submit_graph(tbg.merge(100)).result(60.0)
        obs = c.runtime.observe()
        for k in ("n_frames_sent", "frames_coalesced",
                  "dispatch_ns_per_task"):
            assert k in obs, k
        assert obs["n_frames_sent"] > 0
        st = c.runtime.run_stats()
        assert st["batching"] is True and st["n_frames_sent"] > 0
        assert st["dispatch_ns_per_task"] > 0
        e = c.runtime.epoch(0).as_dict()
        for k in ("frames_sent", "frames_coalesced",
                  "dispatch_ns_per_task"):
            assert k in e, k
        assert e["frames_sent"] >= 1


@pytest.mark.parametrize("wire_name", SERVERS)
def test_batch_usage_piggyback_and_frame_event(wire_name):
    w = tmsg.make_wire(wire_name)
    usage = (100, 200, 10, 5, 2, 1)
    frames = (w.encode_finished_batch(3, [(8, tmsg._NO_RESULT),
                                          (9, tmsg._NO_RESULT)])
              + w.encode_stats(4096, 2, usage))
    (env,) = w.encode_batch(frames)
    ev = tmsg.frame_event(*_op_wid(w.decode(env), 3))
    assert ev[0] == "batch" and ev[1][-1][0] == "stats"
    assert [(t, rw) for e in ev[1] if e[0] == "finished"
            for t, rw in e[1]] == [(8, 3), (9, 3)]
    assert w.take_usage() == usage and w.take_usage() is None
    release = w.encode_release([1]) + w.encode_retract([2])
    (env,) = w.encode_batch(release)
    assert tmsg.frame_event(*_op_wid(w.decode(env), 0)) is None


def _op_wid(decoded, wid):
    op, recs, payloads = decoded
    return op, wid, recs, payloads


_FLOOD = 32     # MB of frames queued toward the non-reading worker


def test_selector_slow_reader_does_not_stall_dispatch():
    """One worker that never reads: sends to it buffer server-side and a
    frame to a healthy worker still arrives."""
    tpx = tp.SocketTransport(2)
    stop = threading.Event()
    got = {}

    def slow_worker():
        ep = tp.make_worker_endpoint(tpx.worker_args(0))
        stop.wait(30.0)
        ep.close()

    def live_worker():
        ep = tp.make_worker_endpoint(tpx.worker_args(1))
        got[1] = ep.recv(timeout=20.0)
        ep.close()

    threads = [threading.Thread(target=slow_worker, daemon=True),
               threading.Thread(target=live_worker, daemon=True)]
    for t in threads:
        t.start()
    try:
        tpx.after_start()
        big = b"x" * (1 << 20)
        for _ in range(_FLOOD):
            tpx.send(0, big)
        tpx.send(1, b"hello-live")
        deadline = time.perf_counter() + 10.0
        while 1 not in got and time.perf_counter() < deadline:
            tpx.poll(0.01)
        assert got.get(1) == b"hello-live"
    finally:
        stop.set()
        tpx.close()
        for t in threads:
            t.join(timeout=5.0)


def test_asyncio_slow_reader_does_not_stall_dispatch():
    tpx = tp.AsyncioTransport("socket", 2)
    stop = threading.Event()
    got = {}

    def slow_worker():
        ep = tp.make_worker_endpoint(tpx.worker_args(0))
        stop.wait(30.0)
        ep.close()

    def live_worker():
        ep = tp.make_worker_endpoint(tpx.worker_args(1))
        got[1] = ep.recv(timeout=20.0)
        ep.close()

    threads = [threading.Thread(target=slow_worker, daemon=True),
               threading.Thread(target=live_worker, daemon=True)]
    for t in threads:
        t.start()

    async def main():
        await tpx.a_start()
        big = b"x" * (1 << 20)
        for _ in range(_FLOOD):
            tpx.send(0, big)
        await tpx.a_flush()
        tpx.send(1, b"hello-live")
        await tpx.a_flush()
        deadline = time.perf_counter() + 10.0
        while 1 not in got and time.perf_counter() < deadline:
            await asyncio.sleep(0.01)
        stop.set()
        await tpx.a_close()

    try:
        asyncio.run(main())
        assert got.get(1) == b"hello-live"
    finally:
        stop.set()
        tpx.close()
        for t in threads:
            t.join(timeout=5.0)
