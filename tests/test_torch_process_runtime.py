"""The port's process runtime (``repro_torch.core``, ``runtime="process"``)
against ``repro.core``.

The cases of ``tests/test_process_runtime.py``, run on the copy (those
of ``tests/test_server_core.py`` are ``tests/test_torch_process_server.py``'s):
the benchmark suite at
``scale=0.05`` and value graphs, built in both packages, give the
reference's result sets, values and task counts on OS-process workers,
under both servers, the selector and asyncio drivers and both transports;
a SIGKILLed worker leaves the same results; the Dask wire moves at least
two frames a task with batching off.  With torch loaded the port spawns
its workers, so a ``pipe`` request runs on ``socket``; no worker imports
torch.  Every port ServerCore's event stream goes through
``repro.analysis.trace.ConformanceSink``.  No assertion reads the host
clock."""
import inspect
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.core import benchgraphs as jbg  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import benchgraphs as tbg  # noqa: E402
from repro_torch.core import runtime as truntime  # noqa: E402
from repro_torch.ft import faults as tfaults  # noqa: E402
from torch_core_tasks import (_slow_plus, _sq,  # noqa: E402
                              assert_conforms, attach_conformance,
                              fn_graph, fn_graph_want, torch_state)

ROOT = Path(__file__).resolve().parents[1]
SERVERS = ["dask", "rsds"]
DRIVERS = ["selector", "asyncio"]
SUITE_T = tbg.suite(scale=0.05)


@pytest.fixture(autouse=True)
def _conformance(monkeypatch):
    sinks = attach_conformance(monkeypatch)
    yield
    assert_conforms(sinks)


def _run(pkg, graph, runtime, server, **kw):
    return pkg.run_graph(graph, server=server, runtime=runtime, n_workers=4,
                         simulate_durations=False, timeout=120.0, **kw)


def test_exports_and_signatures_match_the_reference():
    """``repro_torch.core`` exports every name of ``repro.core``, and each
    public class and function takes the same parameters."""
    import repro.core.runtime as jrt
    import repro.core.server as jsrv
    import repro.core.transport as jtp
    from repro.core import messages as jmsg
    from repro.core import simulator as jsim
    from repro.ft import faults as jfaults
    from repro_torch.core import messages as tmsg
    from repro_torch.core import server as tsrv
    from repro_torch.core import simulator as tsim
    from repro_torch.core import transport as ttp

    names = {n for n in dir(jcore) if not n.startswith("_")
             and n not in ("annotations",)}
    assert names <= set(dir(tcore)), sorted(names - set(dir(tcore)))
    pairs = [(jrt, truntime), (jsrv, tsrv), (jtp, ttp), (jmsg, tmsg),
             (jsim, tsim), (jbg, tbg), (jfaults, tfaults)]
    for jm, tm in pairs:
        public = [n for n, v in vars(jm).items()
                  if not n.startswith("__") and callable(v)
                  and getattr(v, "__module__", None) == jm.__name__]
        assert public, jm.__name__
        for n in public:
            jv, tv = getattr(jm, n), getattr(tm, n)
            if inspect.isclass(jv):
                jmeth = {k: v for k, v in vars(jv).items() if callable(v)}
                assert sorted(jmeth) == sorted(
                    k for k, v in vars(tv).items() if callable(v)), n
                for k in jmeth:
                    _same_signature(jmeth[k], getattr(tv, k), f"{n}.{k}")
            else:
                _same_signature(jv, tv, n)
    # the stubs' "not ported yet" raises are gone
    for path in sorted((ROOT / "src" / "repro_torch" / "core").glob("*.py")) \
            + [ROOT / "src" / "repro_torch" / "ft" / "faults.py"]:
        assert "not ported yet" not in path.read_text(), path.name


def _same_signature(jv, tv, name):
    try:
        js = inspect.signature(jv)
    except (TypeError, ValueError):
        return
    ts = str(inspect.signature(tv)).replace("repro_torch.", "repro.")
    assert ts == str(js), name


@pytest.mark.parametrize("server", SERVERS)
@pytest.mark.parametrize("gi", range(len(SUITE_T)),
                         ids=[g.name for g in SUITE_T])
def test_runtime_parity_suite(gi, server):
    """Every structural family of the suite: the port's process runtime
    completes the graph with the reference's result set and task count."""
    gt, gj = SUITE_T[gi], jbg.suite(scale=0.05)[gi]
    assert (gt.name, gt.n_tasks) == (gj.name, gj.n_tasks)
    want = _run(jcore, gj, "thread", server)
    got = _run(tcore, gt, "process", server)
    assert not want.timed_out and not got.timed_out
    assert got.n_tasks == want.n_tasks == gt.n_tasks
    assert set(got.results) == set(want.results)
    assert got.stats["msgs_in"] >= gt.n_tasks
    assert sum(got.stats["tasks_per_worker"].values()) >= gt.n_tasks


@pytest.mark.parametrize("driver", DRIVERS)
@pytest.mark.parametrize("server", SERVERS)
def test_runtime_parity_fn_results(server, driver):
    """Real callables with data dependencies: the values equal the
    reference's, on both drivers."""
    want = jcore.run_graph(fn_graph(jcore), server=server, n_workers=3,
                           timeout=60.0)
    got = tcore.run_graph(fn_graph(tcore), server=server, runtime="process",
                          driver=driver, n_workers=3, timeout=60.0)
    assert not want.timed_out and not got.timed_out
    assert got.results == want.results == fn_graph_want()
    assert got.stats["server_driver"] == driver


def test_spawn_under_torch_turns_pipe_into_socket():
    """torch is loaded here, so the process runtime spawns its workers:
    a ``pipe`` request runs on ``socket`` (raw fds need fork), and no
    worker process ever imports torch."""
    assert "torch" in sys.modules
    g = tcore.TaskGraph([tcore.Task(i, (), fn=torch_state)
                         for i in range(6)], name="probe")
    r = tcore.run_graph(g, server="rsds", runtime="process", n_workers=3,
                        transport="pipe", timeout=60.0)
    assert not r.timed_out
    assert r.stats["transport"] == "socket"
    assert set(r.results.values()) == {"absent"}


@pytest.mark.parametrize("transport", ["pipe", "socket"])
def test_process_runtime_transports_under_fork(transport):
    """An explicit ``start_method="fork"`` keeps the pipe transport."""
    r = tcore.run_graph(tbg.tree(6), server="rsds", runtime="process",
                        n_workers=3, transport=transport,
                        simulate_durations=False, timeout=60.0,
                        start_method="fork")
    assert not r.timed_out
    assert r.stats["transport"] == transport
    assert r.stats["wire_frames"] > 0 and r.stats["wire_bytes"] > 0


def test_start_method_env_override(monkeypatch):
    monkeypatch.setenv("REPRO_START_METHOD", "fork")
    r = tcore.run_graph(tbg.tree(5), server="dask", runtime="process",
                        n_workers=2, simulate_durations=False, timeout=60.0)
    assert not r.timed_out and r.stats["transport"] == "pipe"


@pytest.mark.parametrize("server", SERVERS)
def test_runtime_parity_with_worker_failure(server):
    """``kill_worker_after`` SIGKILLs one process worker of a warm pool
    mid-graph: the reactor resubmits and lineage recomputes, and the
    values equal the reference's."""
    want = jcore.run_graph(jbg.value_reduction(24, fan=4), server=server,
                           n_workers=3, timeout=60.0)
    with tcore.Cluster(server=server, runtime="process", n_workers=3,
                       timeout=60.0) as c:
        assert c.client.submit(_sq, 3).result(30.0) == 9   # pool is up
        # slow leaves keep every worker busy when the kill lands
        futs = c.client.map(_slow_plus, list(range(9)))
        timer = tfaults.kill_worker_after(c.runtime, 1, 0.05)
        gf = c.client.submit_graph(tbg.value_reduction(24, fan=4))
        got = gf.result(60.0)
        assert [f.result(30.0) for f in futs] == list(range(1, 10))
        timer.join(10.0)
        assert 1 in c.runtime.dead
        assert not c.runtime.procs[1].is_alive()
    assert got == want.results


@pytest.mark.parametrize("server", SERVERS)
def test_one_shot_run_survives_a_kill(server):
    g = tbg.merge(300, dur_ms=1.0)
    cls = tcore.ObjectReactor if server == "dask" else tcore.ArrayReactor
    sched = tcore.make_scheduler("dask_ws" if server == "dask"
                                 else "rsds_ws")
    reactor = cls(g, sched, 4, simulate_codec=False)
    rt = tcore.ProcessRuntime(g, reactor, 4, timeout=120.0)
    tfaults.kill_worker_after(rt, 1, 0.05)
    r = rt.run()
    assert not r.timed_out and reactor.done()
    assert r.n_tasks == g.n_tasks


def test_process_dask_pays_per_message_codec():
    """The paper's codec asymmetry on a real transport, batching off: the
    Dask wire moves at least one frame each way a task, the static wire
    far fewer frames and bytes."""
    g = tbg.merge(500)
    rd = tcore.run_graph(g, server="dask", runtime="process", n_workers=4,
                         zero_worker=True, batching=False, timeout=60.0)
    rr = tcore.run_graph(g, server="rsds", runtime="process", n_workers=4,
                         zero_worker=True, batching=False, timeout=60.0)
    assert not rd.timed_out and not rr.timed_out
    assert rd.stats["wire_frames"] >= 2 * g.n_tasks
    assert rr.stats["wire_frames"] < rd.stats["wire_frames"]
    assert rr.stats["wire_bytes"] < rd.stats["wire_bytes"]
    assert rd.stats["codec_s"] > 0
