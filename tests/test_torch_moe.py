"""The port's MoE FFN (repro_torch.models.moe) against the JAX package's
(repro.models.moe), on JAX-initialised params moved over by
repro_torch.bridge, in fp32 on the CPU: the router's choices, the
capacity dispatch's kept slots and drops, the outputs and the aux
statistics; the router bias gets no gradient; the three new configs and
their counts; and the engine against the JAX engine where the capacity
couples a decode step's requests."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.config import LayerSpec as JSpec  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.models.config import MoEConfig as JMoE  # noqa: E402
from repro.models.config import uniform_groups as jgroups  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

MOE_TOL = dict(rtol=1e-4, atol=1e-4)          # tests/test_moe.py
NEW = ("grok-1-314b", "deepseek-v3-671b", "llama-3.2-vision-90b")
# the JAX package's counts (repro.models.config.ModelConfig.param_count)
PUBLISHED = {"grok-1-314b": (316_489_340_928, 84_561_106_944),
             "deepseek-v3-671b": (671_026_419_200, 37_552_297_472),
             "llama-3.2-vision-90b": (87_645_828_116, 87_645_828_116)}


def _cfgs(d=32, d_ff=64, **moe):
    """The same one-layer MoE config in both packages (fp32, GeLU)."""
    def make(config, spec, groups, moe_cls):
        return config(name="moe-test",
                      groups=groups(1, spec(kind="attn", mlp="moe")),
                      d_model=d, num_heads=4, num_kv_heads=4, head_dim=8,
                      d_ff=d_ff, vocab_size=64, moe=moe_cls(**moe),
                      activation="gelu", dtype="float32", remat="none")
    return (make(JConfig, JSpec, jgroups, JMoE),
            make(tconfig.ModelConfig, tconfig.LayerSpec,
                 tconfig.uniform_groups, tconfig.MoEConfig))


def _params(cfg_j, seed, rng):
    p = jmoe.init_moe(jax.random.PRNGKey(seed), cfg_j)
    if cfg_j.moe.router_bias:  # nonzero, so selection-only bias shows
        p["router"]["bias"] = jnp.asarray(
            rng.standard_normal(cfg_j.moe.num_experts) * 0.1, jnp.float32)
    return p, bridge.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


def _jax_dispatch(params, cfg, x):
    """idx, keep and slot (G,Sg,K) of the JAX version's one-hot dispatch:
    its router, ``topk_gating`` and slot lines (repro/models/moe.py:70-88)
    with keep and slot read at each choice's expert."""
    m = cfg.moe
    b, s, d = x.shape
    xt = jmoe._group(x.reshape(b * s, d), m.group_size)
    g, sg, _ = xt.shape
    e = m.num_experts
    cap = min(max(int(sg * m.top_k * m.capacity_factor / e), 1), sg)
    logits = jnp.einsum("gsd,de->gse", xt, params["router"]["w"])
    bias = params["router"].get("bias")
    _, idx = jax.vmap(lambda lg: jref.topk_gating(
        lg, m.top_k, router=m.router, bias=bias))(logits)
    onehot = jax.nn.one_hot(idx, e, dtype=jnp.int32)
    prio = jnp.moveaxis(onehot, 2, 1).reshape(g, m.top_k * sg, e)
    pos = jnp.cumsum(prio, axis=1) - 1
    pos = jnp.moveaxis(pos.reshape(g, m.top_k, sg, e), 1, 2)
    keep = (pos < cap) & (onehot > 0)
    slot = jnp.where(keep, pos, 0)
    return (np.asarray(idx), np.asarray(keep.any(-1)),
            np.asarray(slot.sum(-1)))


CASES = {
    # grok-1: softmax top-2 over 8, no bias, no shared expert
    "softmax-top2": (dict(num_experts=8, top_k=2, capacity_factor=1.25,
                          router="softmax", aux_loss_weight=0.01),
                     (2, 24)),
    # deepseek-v3: sigmoid top-8 with a nonzero bias and a shared expert
    "sigmoid-top8-bias-shared": (dict(num_experts=16, top_k=8, d_expert=16,
                                      num_shared=1, capacity_factor=1.25,
                                      router="sigmoid", router_bias=True),
                                 (2, 24)),
    # deepseek-v3's routing widths: 256 experts, top-8, cf 1.25, two
    # dispatch groups of 512 tokens (cap 20), at d 32: tokens drop
    "deepseek-widths": (dict(num_experts=256, top_k=8, d_expert=16,
                             num_shared=1, capacity_factor=1.25,
                             group_size=512, router="sigmoid",
                             router_bias=True), (2, 512)),
}


@pytest.mark.parametrize("case", CASES)
def test_apply_moe_matches_jax(case):
    """The same router choices, the same kept choices in the same slots,
    equal ``moe_dropped`` and the same ``moe_load``; the outputs and
    ``moe_aux_loss`` within 1e-4."""
    moe, (b, s) = CASES[case]
    cfg_j, cfg_t = _cfgs(**moe)
    rng = np.random.default_rng(0)
    params_j, params_t = _params(cfg_j, 0, rng)
    x = rng.standard_normal((b, s, cfg_j.d_model)).astype(np.float32)

    y_j, aux_j = jmoe.apply_moe(params_j, cfg_j, jnp.asarray(x))
    y_t, aux_t = tmoe.apply_moe(params_t, cfg_t, torch.from_numpy(x))
    idx_j, keep_j, slot_j = _jax_dispatch(params_j, cfg_j, jnp.asarray(x))
    xt = tmoe._group(torch.from_numpy(x).reshape(b * s, -1),
                     cfg_t.moe.group_size)
    _, _, idx_t, keep_t, slot_t, _ = tmoe.route(params_t, cfg_t, xt)
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)
    np.testing.assert_array_equal(keep_t.numpy(), keep_j)
    np.testing.assert_array_equal(slot_t.numpy(), slot_j)
    assert float(aux_t["moe_dropped"]) == float(aux_j["moe_dropped"])
    # the choices per expert, equal; their mean, to its rounding
    np.testing.assert_allclose(aux_t["moe_load"].numpy(),
                               np.asarray(aux_j["moe_load"]), rtol=1e-6)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **MOE_TOL)
    np.testing.assert_allclose(float(aux_t["moe_aux_loss"]),
                               float(aux_j["moe_aux_loss"]), **MOE_TOL)
    if case == "deepseek-widths":
        assert float(aux_j["moe_dropped"]) > 0.0
        assert not keep_j.all()
    # serving's form: the same output, no statistics
    y_s, aux_s = tmoe.apply_moe(params_t, cfg_t, torch.from_numpy(x),
                                stats=False)
    assert aux_s == {}
    assert torch.equal(y_s, y_t)


def test_router_bias_moves_selection_only():
    """A nonzero bias changes the choices, but the weights come from the
    unbiased logits (a sigmoid router renormalised over the k chosen)."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.standard_normal((32, 16)).astype(
        np.float32))
    bias = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    w0, i0 = ref.topk_gating(logits, 4, router="sigmoid")
    w1, i1 = ref.topk_gating(logits, 4, router="sigmoid", bias=bias)
    assert not torch.equal(i0, i1)
    want = torch.sigmoid(torch.gather(logits, -1, i1))
    torch.testing.assert_close(w1, want / want.sum(-1, keepdim=True))
    for router in ("softmax", "sigmoid"):
        for b in (None, bias):
            w_j, i_j = jref.topk_gating(
                jnp.asarray(logits.numpy()), 4, router=router,
                bias=None if b is None else jnp.asarray(b.numpy()))
            w_t, i_t = ref.topk_gating(logits, 4, router=router, bias=b)
            np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
            np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j),
                                       rtol=1e-6, atol=1e-6)


def test_router_bias_gets_no_gradient():
    """DeepSeek-V3's aux-loss-free bias (tests/test_models.py:122-137): the
    loss's gradient is zero on every router bias, and nonzero on every
    router weight."""
    from repro_torch.models.common import tree_map
    from repro_torch.train import train_step as tstep
    cfg_j = jconfigs.get_config("deepseek-v3-671b", smoke=True)
    cfg_t = tconfigs.get_config("deepseek-v3-671b", smoke=True)
    params_j = jmodel.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = tree_map(lambda a: a.requires_grad_(True),
                        bridge.params_from_numpy(
                            jax.tree.map(np.asarray, params_j), "cpu"))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg_t.vocab_size, (2, 16)).astype(np.int32))
    _, grads = tstep.make_grad_fn(cfg_t)(params_t, {"tokens": toks,
                                                    "labels": toks})
    n = 0
    for gspec, group in zip(cfg_t.groups, grads["groups"]):
        for spec, slot in zip(gspec.pattern, group["slots"]):
            if spec.mlp == "moe":
                assert float(slot["mlp"]["router"]["bias"].abs().max()) == 0
                assert float(slot["mlp"]["router"]["w"].abs().max()) > 0
                n += 1
    assert n == 1


@pytest.mark.parametrize("arch", ("grok-1-314b", "deepseek-v3-671b"))
def test_only_training_forwards_compute_moe_statistics(arch, monkeypatch):
    """forward and forward_loss ask every MoE layer for its statistics;
    prefill and decode_step, whose callers read none, ask none."""
    from repro_torch.models import model as tmodel
    cfg = tconfigs.get_config(arch, smoke=True)
    params = tmodel.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    n_moe = sum(sum(s.mlp == "moe" for s in g.pattern) * g.repeat
                for g in cfg.groups)
    asked, real = [], tmoe.apply_moe

    def apply_moe(params, cfg, x, *, stats=True):
        asked.append(stats)
        return real(params, cfg, x, stats=stats)

    monkeypatch.setattr(tmoe, "apply_moe", apply_moe)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32))
    with torch.no_grad():
        _, aux = tmodel.forward(params, cfg, toks[:, :8])
        tmodel.forward_loss(params, cfg, toks[:, :8], toks[:, 1:])
        assert asked == [True] * 2 * n_moe
        assert float(aux["moe_dropped"]) >= 0.0
        asked.clear()
        cache = tmodel.init_cache(cfg, 2, 16, device="cpu")
        _, cache = tmodel.prefill(params, cfg, toks[:, :8], cache)
        tmodel.decode_step(params, cfg, toks[:, 8:], cache,
                           torch.full((2,), 8, dtype=torch.int32))
    assert asked == [False] * 2 * n_moe


@pytest.mark.parametrize("arch", NEW)
@pytest.mark.parametrize("smoke", [False, True])
def test_new_configs_match_jax(arch, smoke):
    """Field by field, the MoE and MLA sub-configs and the groups
    included."""
    cj = jconfigs.get_config(arch, smoke=smoke)
    ct = tconfigs.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)


@pytest.mark.parametrize("arch", NEW)
def test_new_param_counts_match_jax(arch):
    """param_count() and active_param_count() (the meta device) at the
    published widths equal the JAX package's counts, and at the smoke
    widths its abstract params'."""
    ct = tconfigs.get_config(arch)
    assert (ct.param_count(), ct.active_param_count()) == PUBLISHED[arch]
    cj = jconfigs.get_config(arch)
    assert (cj.param_count(), cj.active_param_count()) == PUBLISHED[arch]
    cj, ct = (m.get_config(arch, smoke=True) for m in (jconfigs, tconfigs))
    shapes = jmodel.abstract_params(cj)
    assert ct.param_count() == sum(int(np.prod(x.shape))
                                   for x in jax.tree.leaves(shapes))
    assert ct.active_param_count() == cj.active_param_count()


@pytest.mark.parametrize("arch", NEW)
def test_new_optimized_configs_match_jax(arch):
    """The overrides, deepseek-v3's 512-token dispatch groups among them;
    ``moe_sharding`` is carried and changes nothing on one card."""
    from repro.configs.optimized import _OVERRIDES as JAX_OVERRIDES
    from repro.configs.optimized import optimized_config as jopt_config
    from repro_torch.configs.optimized import _OVERRIDES, optimized_config
    key = tconfigs.canonical(arch)
    assert _OVERRIDES[key] == JAX_OVERRIDES[key]
    assert dataclasses.asdict(optimized_config(arch)) == \
        dataclasses.asdict(jopt_config(arch))
    if arch == "deepseek-v3-671b":
        assert optimized_config(arch).moe.group_size == 512


def test_engine_matches_jax_engine_under_capacity_drops():
    """grok-1's smoke config with capacity_factor 0.5: a decode step of 4
    slots gives each of the 4 experts 1 slot for 8 choices, so batchmates
    (and idle slots) take each other's experts, and a prefill's padding
    takes slots from the prompt; both are the JAX engine's behaviour.  The
    same 6 requests (over 4 slots, so slots are reused), submitted before
    either engine starts, give the same tokens in both engines."""
    from repro.serve.engine import ServingEngine as JEngine
    from repro_torch.serve.engine import ServingEngine
    over = dict(capacity_factor=0.5)
    cfg_j = jconfigs.get_config("grok-1-314b", smoke=True)
    cfg_j = dataclasses.replace(cfg_j, moe=dataclasses.replace(cfg_j.moe,
                                                               **over))
    cfg_t = tconfigs.get_config("grok-1-314b", smoke=True)
    cfg_t = dataclasses.replace(cfg_t, moe=dataclasses.replace(cfg_t.moe,
                                                               **over))
    params_j = jmodel.init_params(jax.random.PRNGKey(3), cfg_j)
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        "cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg_t.vocab_size, size=n)
               for n in (5, 9, 17, 3, 12, 7)]
    kw = dict(max_batch=4, max_len=64)
    out = []
    for eng in (JEngine(cfg_j, params_j, **kw),
                ServingEngine(cfg_t, params_t, device="cpu", **kw)):
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.start()
        try:
            for r in reqs:
                assert r.done.wait(300)
        finally:
            eng.stop()
        out.append([r.out_tokens for r in reqs])
    assert out[0] == out[1]
    # a decode step of 4 slots drops choices at this capacity
    x = torch.from_numpy(rng.standard_normal((4, 1, cfg_t.d_model)).astype(
        np.float32))
    mlp = jax.tree.map(lambda a: a[0], params_j["groups"][0]["slots"][0])
    _, aux = tmoe.apply_moe(bridge.params_from_numpy(
        jax.tree.map(np.asarray, mlp["mlp"]), "cpu"), cfg_t, x)
    assert float(aux["moe_dropped"]) > 0.0
