"""The port's ``MicrobatchCoordinator`` (a training step as one graph
epoch on the copied task runtime) against the JAX package's, on the CPU
with the smoke configs of llama3.2-1b and zamba2-2.7b (mamba2 layers on
the SSD's plain versions, forward and backward, and a weight-shared
attention slot): one step from the same (bridged) params on the
same numpy batch agrees with JAX's coordinator and with the port's own
full-batch step (tests/test_train_serve_ft.py:121-146, 5e-3); the step
does not depend on the executor count or on an executor failing mid-step
(bit-equal); a straggling executor loses microbatches to work stealing,
counted from the runtime's events, not timed; the step graph keeps no
gradient once the step is reduced."""
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data.pipeline import SyntheticDataset  # noqa: E402
from repro.train.trainer import MicrobatchCoordinator as JaxCoordinator  # noqa: E402,E501
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.train.optimizer import make_optimizer  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from repro_torch.train.trainer import MicrobatchCoordinator  # noqa: E402

ARCHS = ("llama3.2-1b", "zamba2-2.7b")
STEP_TOL = dict(rtol=5e-3, atol=5e-3)   # tests/test_train_serve_ft.py:143-146
# the straggler's delay a microbatch: several of the arch's smoke
# microbatches on the CPU (zamba2's are the longer: the SSD's plain
# versions are sequential over S)
STRAGGLE = {"llama3.2-1b": 0.10, "zamba2-2.7b": 1.0}


@pytest.fixture(params=ARCHS)
def cfgs(request):
    """(JAX config, port config) of the arch's smoke model."""
    return (jconfigs.get_config(request.param, smoke=True),
            tconfigs.get_config(request.param, smoke=True))


def _leaves_np(tree):
    return [np.asarray(x.detach().float().numpy()) for x in tree_leaves(tree)]


def _set_params(mc, tree):
    mc.params = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                         tree)
    mc.opt_state = mc.opt.init(mc.params)


def test_step_matches_jax_coordinator_and_full_batch(cfgs):
    CFG_J, CFG_T = cfgs
    batch = SyntheticDataset(CFG_J, 8, 32).batch_at(0)
    jmc = JaxCoordinator(CFG_J, n_executors=3, n_microbatches=4)
    p0 = bridge.params_from_numpy(jax.tree.map(np.asarray, jmc.params),
                                  "cpu")
    try:
        jr = jmc.train_step(batch)
    finally:
        jmc.close()
    mc = MicrobatchCoordinator(CFG_T, n_executors=3, n_microbatches=4,
                               device="cpu")
    _set_params(mc, p0)
    try:
        r = mc.train_step(batch)
    finally:
        mc.close()
    assert r["loss"] is not None and not r["timed_out"]
    assert set(r) == {"step", "loss", "makespan", "timed_out",
                      "server_busy"} and r["step"] == 1
    np.testing.assert_allclose(r["loss"], jr["loss"], rtol=2e-4)
    got = _leaves_np(mc.params)
    jax_params = bridge.params_from_numpy(
        jax.tree.map(np.asarray, jmc.params), "cpu")
    for a, b in zip(got, _leaves_np(jax_params)):
        np.testing.assert_allclose(a, b, **STEP_TOL)
    # the port's single full-batch step from the same init
    opt = make_optimizer(CFG_T.optimizer)
    params = tree_map(lambda p: p.detach().clone().requires_grad_(True), p0)
    full, _, _ = make_train_step(CFG_T, opt)(
        params, opt.init(params),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    for a, b in zip(got, _leaves_np(full)):
        np.testing.assert_allclose(a, b, **STEP_TOL)


def _one_step(cfgs, n_executors, fail_worker=None, n_micro=4):
    CFG_J, CFG_T = cfgs
    mc = MicrobatchCoordinator(CFG_T, n_executors=n_executors,
                               n_microbatches=n_micro, device="cpu")
    try:
        r = mc.train_step(SyntheticDataset(CFG_J, 8, 32).batch_at(0),
                          fail_worker=fail_worker)
    finally:
        mc.close()
    assert r["loss"] is not None and not r["timed_out"]
    return r, [p.detach().clone() for p in tree_leaves(mc.params)]


def test_step_is_bit_equal_across_executors_and_failure(cfgs):
    """Each microbatch's gradient does not depend on the executor that ran
    it, and the reduce sums in list order: 3 executors, 1 executor and 4
    executors with one failed mid-step give the same bits."""
    ref_r, ref = _one_step(cfgs, 3)
    for n, fail in ((1, None), (4, 2)):
        r, got = _one_step(cfgs, n, fail)
        assert r["loss"] == ref_r["loss"]
        assert all(torch.equal(a, b) for a, b in zip(ref, got)), (n, fail)


def test_microbatch_survives_executor_failure(cfgs):
    """tests/test_train_serve_ft.py::test_microbatch_survives_executor_failure;
    the failed executor stays dead and the next step runs on the rest."""
    CFG_J, CFG_T = cfgs
    mc = MicrobatchCoordinator(CFG_T, n_executors=4, n_microbatches=8,
                               device="cpu")
    ds = SyntheticDataset(CFG_J, 8, 32)
    try:
        r = mc.train_step(ds.batch_at(0), fail_worker=2)
        assert r["loss"] is not None and not r["timed_out"]
        assert 2 in mc._cluster.runtime.dead
        r2 = mc.train_step(ds.batch_at(1))
        assert r2["loss"] is not None and not r2["timed_out"]
        assert r2["step"] == 2
    finally:
        mc.close()
    assert mc._cluster is None


def test_step_graph_keeps_no_gradient_after_the_reduce(cfgs):
    """The pool's graph keeps a step's task closures until compaction, so
    after each step no microbatch gradient is alive; nor after a failed
    executor's run of a microbatch that ends after the reduce."""
    CFG_J, CFG_T = cfgs
    n_micro = 2
    mc = MicrobatchCoordinator(CFG_T, n_executors=2, n_microbatches=n_micro,
                               device="cpu")
    made = []
    grad = mc._grad

    def spy(params, batch):
        out = grad(params, batch)
        made.extend(weakref.ref(g) for g in tree_leaves(out[1]))
        return out

    mc._grad = spy
    ds = SyntheticDataset(CFG_J, 4, 32)
    n_leaves = len(tree_leaves(mc.params))
    try:
        for step in range(2):
            r = mc.train_step(ds.batch_at(step))
            assert r["loss"] is not None and not r["timed_out"]
            gc.collect()
            assert len(made) == (step + 1) * n_micro * n_leaves
            assert all(w() is None for w in made), step
    finally:
        mc.close()
    made.clear()
    graph = mc._make_step_graph(ds.batch_at(2))
    micro = [graph.task(i) for i in range(n_micro)]
    for t in micro:
        t.fn()
    graph.task(n_micro).fn()
    micro[0].fn()    # the failed executor's run, ending after the reduce
    gc.collect()
    assert len(made) == (n_micro + 1) * n_leaves
    assert all(w() is None for w in made)


def test_straggler_loses_microbatches_to_stealing(cfgs):
    """A slow executor (0.1 s a microbatch for llama, as in
    tests/test_train_serve_ft.py::test_straggler_mitigation_moves_work;
    ``STRAGGLE``) runs fewer than its even share
    of the 12 microbatches.  The straggler's own loop publishes no
    ``task-started``, so its count is the step's microbatches that started
    on no other executor; ``task-finished`` by executor must agree."""
    CFG_J, CFG_T = cfgs
    n_micro, n_exec, slow = 12, 3, 0
    delay = STRAGGLE[CFG_T.name.removesuffix("-smoke")]
    mc = MicrobatchCoordinator(CFG_T, n_executors=n_exec,
                               n_microbatches=n_micro,
                               slow_workers={slow: delay}, events=True,
                               device="cpu")
    ds = SyntheticDataset(CFG_J, n_micro, 32)
    try:
        mc.train_step(ds.batch_at(0))
        bus = mc._cluster.events
        seq0 = bus.tail(1)[0]["seq"]
        r = mc.train_step(ds.batch_at(1))
        evs = bus.since(seq0)
    finally:
        mc.close()
    assert r["loss"] is not None and not r["timed_out"]
    (lo,) = [e["lo"] for e in evs if e["type"] == "epoch-open"]
    micro = set(range(lo, lo + n_micro))
    started = {e["tid"] for e in evs
               if e["type"] == "task-started" and e["tid"] in micro}
    assert all(e["wid"] != slow for e in evs if e["type"] == "task-started")
    on_slow = n_micro - len(started)
    finished_on_slow = {e["tid"] for e in evs
                        if e["type"] == "task-finished" and e["wid"] == slow
                        and e["tid"] in micro}
    assert len(finished_on_slow) == on_slow
    assert on_slow < n_micro / n_exec
    (step,) = [e for e in evs if e["type"] == "train-step"]
    assert step["step"] == 2 and step["makespan"] == r["makespan"]
