"""The port's virtual-time simulator and benchmark graphs
(``repro_torch.core.simulator``, ``repro_torch.core.benchgraphs``)
against ``repro.core``'s.

The generators give the reference's graphs for the same seed.  With
``fixed_server_cost`` the simulation is fully deterministic, and the
port's run of every suite graph at ``scale=0.01`` (both servers, work
stealing and random, with and without zero workers and a failure) gives
the reference's makespan, server time, steal count, reactor counters,
per-task finish times and event stream (the events' types, tasks and
workers in publish order; the envelope's host timestamps dropped), all
exactly.  Then the four claims of ``tests/test_system.py`` are stated on
the port's simulator with that file's bounds.  The first holds under the
fixed cost.  The other three are claims about what the server's calls
cost, which a fixed charge hides, so they run on a work clock instead of
the host clock: the simulator's clock advances by the Python and C
calls that each reactor call makes (``sys.setprofile``), which charges
the work deterministically."""
import contextlib
import sys
import types

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.core import benchgraphs as jbg  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import benchgraphs as tbg  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402

COST = 5e-5
SUITE = [g.name for g in tbg.suite(scale=0.01)]


def _graph_rows(g):
    return [(t.tid, tuple(int(i) for i in t.inputs), t.duration,
             t.output_size, None if t.fn is None else t.fn.__name__,
             t.args) for t in g.tasks]


@pytest.mark.parametrize("scale,seed", [(0.01, 0), (0.05, 1), (0.1, 0)])
def test_generators_give_the_reference_graphs(scale, seed):
    for gt, gj in zip(tbg.suite(scale=scale, seed=seed),
                      jbg.suite(scale=scale, seed=seed)):
        assert gt.name == gj.name
        assert _graph_rows(gt) == _graph_rows(gj)
    for name in ("value_reduction", "array_reduction"):
        assert _graph_rows(getattr(tbg, name)()) == \
            _graph_rows(getattr(jbg, name)())
    assert sorted(tbg.GENERATORS) == sorted(jbg.GENERATORS)


def _sim(core, sim, graph, server, scheduler, **kw):
    """``simulate``'s body, keeping the Simulator for its per-task finish
    times; the events go to a recording sink."""
    events = []
    bus = core.EventBus()
    bus.add_sink(events.append)
    cfg = sim.SimConfig(events=bus, fixed_server_cost=COST, **kw)
    name = {"ws": "dask_ws" if server == "dask" else "rsds_ws",
            "random": "random"}[scheduler]
    cls = core.ObjectReactor if server == "dask" else core.ArrayReactor
    reactor = cls(graph, core.make_scheduler(name), cfg.n_workers,
                  cfg.workers_per_node, cfg.seed)
    s = sim.Simulator(graph, reactor, cfg)
    res = s.run()
    stream = [{k: v for k, v in e.items()
               if k not in ("t", "seq", "wall", "pid")} for e in events]
    return res, s.finish_time.copy(), stream


CASES = [("dask", "ws", {}), ("rsds", "ws", {}), ("rsds", "random", {}),
         ("dask", "random", {"zero_worker": True}),
         ("rsds", "ws", {"failures": ((0.005, 3),)})]


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{s}-{c}-{'-'.join(k) or 'plain'}"
                              for s, c, k in CASES])
@pytest.mark.parametrize("gi", range(len(SUITE)), ids=SUITE)
def test_simulator_is_exact_against_the_reference(gi, case):
    server, sched, kw = CASES[case]
    gt = tbg.suite(scale=0.01)[gi]
    gj = jbg.suite(scale=0.01)[gi]
    rt, ft, et = _sim(tcore, tsim, gt, server, sched, n_workers=24, **kw)
    rj, fj, ej = _sim(jcore, jsim, gj, server, sched, n_workers=24, **kw)
    assert not rt.timed_out and rt.n_tasks == gt.n_tasks
    assert rt.makespan == rj.makespan
    assert rt.server_busy == rj.server_busy
    assert (rt.moves, rt.failures_handled) == (rj.moves, rj.failures_handled)
    assert rt.stats == rj.stats
    np.testing.assert_array_equal(ft, fj)
    assert et == ej
    assert sum(e["type"] == "task-finished" for e in et) >= gt.n_tasks


def test_simulate_entry_matches_the_reference():
    g_t, g_j = tbg.merge(2000), jbg.merge(2000)
    for server in ("dask", "rsds"):
        for sched in ("ws", "random", "heft"):
            a = tcore.simulate(g_t, server=server, scheduler=sched,
                               n_workers=48, fixed_server_cost=COST)
            b = jcore.simulate(g_j, server=server, scheduler=sched,
                               n_workers=48, fixed_server_cost=COST)
            assert (a.makespan, a.server_busy, a.moves, a.stats) == \
                (b.makespan, b.server_busy, b.moves, b.stats)
            assert a.aot == b.aot


# ---------------------------------------------------------------------------
# the paper's claims (tests/test_system.py) on the port's simulator
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _work_clock(unit: float = 1e-7):
    """Charge each server call ``unit`` seconds of virtual time for every
    Python or C function it calls: the simulator reads its charge from
    ``time.perf_counter``, which here counts calls."""
    n = [0]

    def count(frame, event, arg):
        if event in ("call", "c_call"):
            n[0] += 1

    clock = types.SimpleNamespace(perf_counter=lambda: n[0] * unit)
    real = tsim.time
    tsim.time = clock
    sys.setprofile(count)
    try:
        yield
    finally:
        sys.setprofile(None)
        tsim.time = real


def _geomean(xs):
    return float(np.exp(np.mean(np.log(xs))))


def test_random_scheduler_is_competitive():
    """Paper Fig. 2 / Table II: random within ~2x of work stealing."""
    speedups = []
    for g in tbg.suite(scale=0.01, seed=1):
        if g.n_tasks > 4000:
            continue
        ws = tcore.simulate(g, server="dask", scheduler="ws", n_workers=24,
                            fixed_server_cost=COST)
        rnd = tcore.simulate(g, server="dask", scheduler="random",
                             n_workers=24, fixed_server_cost=COST)
        assert not ws.timed_out and not rnd.timed_out
        speedups.append(ws.makespan / rnd.makespan)
    assert 0.3 < _geomean(speedups) < 2.0, speedups


def test_rsds_server_outperforms_dask_server():
    """Paper Fig. 3: same scheduler family, the lower-overhead runtime
    wins on the scheduler-stress graph."""
    g = tbg.merge(8000)
    with _work_clock():
        dask = tcore.simulate(g, server="dask", scheduler="ws",
                              n_workers=168, zero_worker=True)
        rsds = tcore.simulate(g, server="rsds", scheduler="ws",
                              n_workers=168, zero_worker=True)
    assert rsds.makespan < dask.makespan
    assert rsds.aot < 1e-3
    # what separates them: the Dask server codes every message
    assert dask.stats["bytes_coded"] > 0 == rsds.stats["bytes_coded"]


def test_overhead_grows_with_tasks_not_scheduler():
    """Paper Fig. 8 (top): AOT keeps up with task count for the Dask-style
    runtime under either scheduler."""
    aots = {}
    with _work_clock():
        for n in (1000, 8000):
            for sched in ("ws", "random"):
                aots[n, sched] = tcore.simulate(
                    tbg.merge(n), server="dask", scheduler=sched,
                    n_workers=24, zero_worker=True).aot
    assert aots[8000, "ws"] > 0.5 * aots[1000, "ws"]
    assert aots[8000, "random"] > 0.5 * aots[1000, "random"]


def test_workstealing_overhead_grows_with_workers():
    """Paper Fig. 8 (bottom): ws server cost rises with workers at least
    as fast as random's.  The work clock is deterministic, so one run of
    each stands for the reference's best of four."""
    g = tbg.merge(4000)
    busy = {}
    with _work_clock():
        for w in (24, 336):
            for sched in ("ws", "random"):
                busy[w, sched] = tcore.simulate(
                    g, server="dask", scheduler=sched, n_workers=w,
                    zero_worker=True).server_busy
    grow_ws = busy[336, "ws"] / busy[24, "ws"]
    grow_rnd = busy[336, "random"] / busy[24, "random"]
    assert grow_ws > grow_rnd * 0.9
