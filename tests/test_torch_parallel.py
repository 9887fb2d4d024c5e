"""One sharded train step on 8 gloo ranks of the CPU, a (2, 4)
``("data", "model")`` mesh: params bridged from JAX, made DTensors by the
param specs, the batch sharded by the input specs, the step inside
``logical_rules``.  Loss and every updated leaf against the unsharded
port step (loss and gradients within ``SHARDED_REL_L2``, each leaf's
update within ``STEP_UPDATE_REL_L2``) and the JAX step (the suite's
tolerances), for llama3.2-1b, zamba2-2.7b (``mamba_heads`` over the model
axis) and grok-1-314b (an MoE whose experts the rules put on the model
axis).  The ranks run ``torch_parallel_tasks.sharded_steps``."""
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jstep  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tstep  # noqa: E402

ARCHS = ["llama3.2-1b", "zamba2-2.7b", "grok-1-314b"]
OPT_KW = dict(lr=1e-2, warmup=3, decay_steps=10, weight_decay=0.1,
              grad_clip=0.5)                     # tests/test_torch_train.py
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)            # against JAX
STEP_UPDATE_REL_L2 = 1e-3                        # against JAX, a leaf
# sharded against unsharded, in fp32 (the sums run over other splits):
# the loss and every gradient leaf.  The updated leaves are held to
# STEP_UPDATE_REL_L2 as against JAX: the first AdamW update is
# lr * g / (|g| + eps), which turns a gradient's reordering noise (~1e-6
# here) into an O(lr) move where g is near zero (zero-initialised norm
# scales: 5e-4 of their update).
SHARDED_REL_L2 = 1e-5


def _batch(seed, b, s, vocab):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(
        np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _rel(a, b):
    return np.linalg.norm(np.asarray(a, np.float64) - b) / max(
        np.linalg.norm(np.asarray(b, np.float64)), 1e-30)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{arch: (sharded result, unsharded port result, JAX result, params
    before)}, the 8 ranks spawned once for all three."""
    tmp = tmp_path_factory.mktemp("parallel")
    jobs, local = {}, {}
    for arch in ARCHS:
        cfg_j = jconfigs.get_config(arch, smoke=True)
        cfg_t = tconfigs.get_config(arch, smoke=True)
        pj = jax.jit(jmodel.init_params, static_argnums=1)(
            jax.random.PRNGKey(0), cfg_j)
        p_np = jax.tree.map(np.asarray, pj)
        batch = _batch(6, 4, 16, cfg_t.vocab_size)
        jobs[arch] = {"arch": arch, "params": bridge.params_to_numpy(
            bridge.params_from_numpy(p_np, "cpu")), "batch": batch,
            "opt": OPT_KW}
        opt_j = jopt.make_optimizer("adamw", **OPT_KW)
        pj2, _, mj = jax.jit(jstep.make_train_step(cfg_j, opt_j))(
            pj, opt_j.init(pj), {k: jnp.asarray(v) for k, v in batch.items()})
        opt_t = topt.make_optimizer("adamw", **OPT_KW)
        pt = tree_map(lambda a: a.requires_grad_(True),
                      bridge.params_from_numpy(p_np, "cpu"))
        tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
        _, gt = tstep.make_grad_fn(cfg_t)(pt, tbatch)
        pt, _, mt = tstep.make_train_step(cfg_t, opt_t)(
            pt, opt_t.init(pt),
            {k: torch.from_numpy(v) for k, v in batch.items()})
        local[arch] = ({"params": bridge.params_to_numpy(pt),
                        "grads": bridge.params_to_numpy(gt),
                        "loss": float(mt["loss"])},
                       {"params": jax.tree.map(np.asarray, pj2),
                        "loss": float(mj["loss"])},
                       bridge.params_to_numpy(
                           bridge.params_from_numpy(p_np, "cpu")))
    in_path, out_path = tmp / "jobs.pkl", tmp / "out.pkl"
    in_path.write_bytes(pickle.dumps(jobs))
    import torch_parallel_tasks
    torch.multiprocessing.spawn(
        torch_parallel_tasks.sharded_steps,
        args=(8, str(tmp / "store"), str(in_path), str(out_path)),
        nprocs=8, join=True)
    sharded = pickle.loads(out_path.read_bytes())
    return {a: (sharded[a], *local[a]) for a in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_unsharded_and_jax(runs, arch):
    got, port, jax_, before = runs[arch]
    assert any("Shard" in p for p in got["placements"])
    assert abs(got["loss"] - port["loss"]) <= SHARDED_REL_L2 * abs(
        port["loss"])
    np.testing.assert_allclose(got["loss"], jax_["loss"], **LOSS_TOL)
    mine = jax.tree.leaves(got["params"])
    unsharded = jax.tree.leaves(port["params"])
    theirs = jax.tree.leaves(jax_["params"])
    p0s = jax.tree.leaves(before)
    assert len(mine) == len(unsharded) == len(theirs) == len(p0s)
    grads = jax.tree.leaves(got["grads"])
    assert len(grads) == len(mine)
    for g, gu in zip(grads, jax.tree.leaves(port["grads"])):
        assert _rel(g, gu) < SHARDED_REL_L2
    for a, u, w, p0 in zip(mine, unsharded, theirs, p0s):
        a, u, w, p0 = (np.asarray(t, np.float32) for t in (a, u, w, p0))
        assert _rel(a - p0, u - p0) < STEP_UPDATE_REL_L2
        want = w - p0
        assert np.abs(want).max() > 0
        assert _rel(a - p0, want) < STEP_UPDATE_REL_L2
        want = w - p0
        assert np.abs(want).max() > 0
        assert _rel(a - p0, want) < STEP_UPDATE_REL_L2


def test_experts_and_mamba_heads_are_sharded(runs):
    """The rules place grok's experts and zamba2's mamba heads on the
    model axis (4 ranks), as JAX's make_rules does on this mesh."""
    from repro_torch.parallel.annotate import make_rules

    class Mesh24:
        axis_names = ("data", "model")
        shape = {"data": 2, "model": 4}
    grok = make_rules(tconfigs.get_config("grok-1-314b", smoke=True),
                      Mesh24(), 4)
    zamba = make_rules(tconfigs.get_config("zamba2-2.7b", smoke=True),
                       Mesh24(), 4)
    assert grok["experts"] == "model" and zamba["mamba_heads"] == "model"
    assert "(Replicate(), Shard(dim=1))" in runs["grok-1-314b"][0][
        "placements"]


# sharded against plain serving (prefill and 4 decode steps) in fp32: the
# caches sharded by cache_spec (llama's and grok's kv heads do not divide
# the model axis, so their caches are sharded on the sequence and decode
# merges the shards' softmaxes; zamba2's SSM state by mamba heads)
SERVE_LOGITS_ABS = 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serving_matches_plain(runs, arch):
    got = runs[arch][0]["serve"]
    assert got["tokens_equal"]
    assert got["logits_max_abs"] < SERVE_LOGITS_ABS, got
