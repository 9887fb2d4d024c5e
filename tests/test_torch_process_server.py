"""The port's server drivers on OS-process workers against
``repro.core``: the process cases of ``tests/test_server_core.py``, run on
the copy.  The asyncio driver gives the selector driver's and the thread
runtime's values on both transports; ``server="selector"|"asyncio"``
picks the driver; an unknown driver is refused (and uvloop where it is
not installed); queued consumers are re-hinted when their holder dies;
``ElasticController`` refuses a process runtime.  Every port
ServerCore's event stream goes through
``repro.analysis.trace.ConformanceSink``.  No assertion reads the host
clock."""
import pytest

pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.core import benchgraphs as jbg  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import benchgraphs as tbg  # noqa: E402
from repro_torch.core import runtime as truntime  # noqa: E402
from repro_torch.ft import faults as tfaults  # noqa: E402
from torch_core_tasks import (_block, _leaf, _plus1, _slow_plus,  # noqa: E402
                              _sq, assert_conforms, attach_conformance)

SERVERS = ["dask", "rsds"]
DRIVERS = ["selector", "asyncio"]


@pytest.fixture(autouse=True)
def _conformance(monkeypatch):
    sinks = attach_conformance(monkeypatch)
    yield
    assert_conforms(sinks)


@pytest.mark.parametrize("transport", ["pipe", "socket"])
@pytest.mark.parametrize("server", SERVERS)
def test_asyncio_driver_parity(server, transport):
    base = jcore.run_graph(jbg.value_reduction(12, fan=3), server=server,
                           runtime="thread", n_workers=3, timeout=60.0)
    g = tbg.value_reduction(12, fan=3)
    runs = {d: tcore.run_graph(g, server=server, runtime="process",
                               n_workers=3, transport=transport,
                               start_method="fork", driver=d, timeout=60.0)
            for d in DRIVERS}
    for d, r in runs.items():
        assert not r.timed_out
        assert r.results == base.results
        assert r.stats["server_driver"] == d
        assert r.stats["transport"] == transport
        assert r.stats["relay_bytes"] == 0
        assert r.stats["p2p_bytes"] > 0


def test_server_kwarg_selects_driver():
    g = tbg.merge(40, dur_ms=0.0)
    for driver in DRIVERS:
        r = tcore.run_graph(g, server=driver, n_workers=3,
                            simulate_durations=False, timeout=60.0)
        assert not r.timed_out and r.stats["server_driver"] == driver
    with tcore.Cluster(server="asyncio", n_workers=2, timeout=30.0) as c:
        assert (c.server, c.server_driver) == ("rsds", "asyncio")
        assert c.client.submit(_sq, 4).result(30.0) == 16
    with tcore.Cluster(server="rsds", runtime="thread", n_workers=2) as c:
        assert c.server_driver == "inproc"


def test_unknown_and_missing_drivers_rejected():
    g = tcore.TaskGraph([], name="x")
    reactor = tcore.ArrayReactor(g, tcore.make_scheduler("rsds_ws"), 2,
                                 simulate_codec=False)
    with pytest.raises(ValueError, match="driver"):
        tcore.ProcessRuntime(g, reactor, 2, driver="twisted")
    if truntime.has_uvloop():
        r = tcore.run_graph(tbg.merge(30, dur_ms=0.0), server="uvloop",
                            n_workers=2, simulate_durations=False,
                            timeout=60.0)
        assert not r.timed_out and r.stats["server_driver"] == "uvloop"
    else:
        with pytest.raises(RuntimeError, match="uvloop"):
            tcore.ProcessRuntime(g, reactor, 2, driver="uvloop")


@pytest.mark.parametrize("driver", DRIVERS)
def test_proactive_rehint_on_worker_loss(driver):
    with tcore.Cluster(server="rsds", runtime="process", n_workers=2,
                       scheduler="random", driver=driver,
                       transport="socket", timeout=60.0) as c:
        f = c.client.submit(_leaf, 5)
        assert f.result(30.0) == 5
        holder = c.runtime._holders(f.tid)[0]
        c.client.map(_block, [0.6] * 4)
        futs = [c.client.submit(_slow_plus, f) for _ in range(6)]
        c.runtime.fail_worker(holder)
        assert [fu.result(30.0) for fu in futs] == [6] * 6
        assert c.runtime.n_rehints >= 1


def test_elastic_controller_refuses_process_runtimes():
    with tcore.Cluster(server="rsds", runtime="process", n_workers=2) as c:
        with pytest.raises(NotImplementedError, match="thread runtimes"):
            tfaults.ElasticController(c)
        assert c.client.submit(_plus1, 1).result(30.0) == 2

