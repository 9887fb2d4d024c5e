"""The port's models (llama3.2-1b, zamba2-2.7b, gemma-7b, gemma2-27b,
deepseek-coder-33b, musicgen-medium; xlstm-350m's are in
tests/test_torch_xlstm.py) against the JAX models, on JAX-initialised
params moved over by repro_torch.bridge (smoke configs, CPU); the configs,
their optimized overrides and param counts of every ported arch."""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_models.py
CACHE_TOL = dict(rtol=2e-5, atol=2e-5)
ARCHS = ("llama3.2-1b", "zamba2-2.7b", "gemma-7b", "gemma2-27b",
         "deepseek-coder-33b")
DENSE = ("gemma-7b", "gemma2-27b", "deepseek-coder-33b")
NEW = ("xlstm-350m", "musicgen-medium")   # the xLSTM and codebook families
# names of neither registry (every arch of the JAX package is ported; the
# MoE, MLA and VLM archs are tests/test_torch_moe.py's and
# tests/test_torch_mla_vlm.py's)
UNPORTED = ("mixtral-8x7b", "llama3_1_405b")


# the dense archs: gemma-7b (head_dim 256 at full width; GeGLU, scaled
# embeddings), gemma2-27b (post-norms, local/global windows, both
# softcaps, attn_scale), deepseek-coder-33b (untied head; 56/8 heads,
# G = 7, at full width)
@pytest.fixture(scope="module", params=("llama3.2-1b", *DENSE))
def setup(request):
    cfg_j = jconfigs.get_config(request.param, smoke=True)
    cfg_t = tconfigs.get_config(request.param, smoke=True)
    params_j = jmodel.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        "cpu")
    return cfg_j, cfg_t, params_j, params_t


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def test_config_matches_jax():
    for arch, smoke in itertools.product(ARCHS + NEW, (False, True)):
        cj = jconfigs.get_config(arch, smoke=smoke)
        ct = tconfigs.get_config(arch, smoke=smoke)
        fields = {f.name for f in dataclasses.fields(ct)}
        assert fields <= {f.name for f in dataclasses.fields(cj)}
        for name in fields - {"groups", "mamba", "xlstm"}:
            assert getattr(ct, name) == getattr(cj, name), name
        assert dataclasses.asdict(ct)["groups"] == \
            dataclasses.asdict(cj)["groups"]
        for sub in ("mamba", "xlstm"):
            assert (getattr(ct, sub) is None) == (getattr(cj, sub) is None)
            if getattr(ct, sub) is not None:
                assert dataclasses.asdict(getattr(ct, sub)) == \
                    dataclasses.asdict(getattr(cj, sub))
        assert ct.num_layers == cj.num_layers


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_archs_raise(arch):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tconfigs.get_config(arch)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS + NEW)
def test_param_counts_match_jax(arch, smoke):
    """param_count and active_param_count (counted on the meta device)
    equal the JAX package's, at the published and the smoke widths."""
    cj = jconfigs.get_config(arch, smoke=smoke)
    ct = tconfigs.get_config(arch, smoke=smoke)
    assert ct.param_count() == cj.param_count()
    assert ct.active_param_count() == cj.active_param_count()


def test_init_params_tree_matches_jax(setup):
    """init_params and init_cache give JAX's trees, leaf shapes and
    dtypes."""
    cfg_j, cfg_t, params_j, _ = setup
    gen = torch.Generator().manual_seed(0)
    mine_p = bridge.params_to_numpy(tmodel.init_params(gen, cfg_t, "cpu"))
    mine_c = bridge.params_to_numpy(
        tmodel.init_cache(cfg_t, 2, 24, device="cpu"))
    for mine, theirs in ((mine_p, params_j),
                         (mine_c, jmodel.init_cache(cfg_j, 2, 24))):
        theirs = jax.tree.map(np.asarray, theirs)
        assert jax.tree.structure(mine) == jax.tree.structure(theirs)
        for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
            assert a.shape == b.shape and a.dtype == b.dtype


def test_post_norm_and_head_leaves_and_bridge_round_trip(setup):
    """The post-norm leaves ``post_norm`` and ``post_mlp_norm`` are there
    exactly where a layer has post-norms (gemma2), the ``head`` exactly
    where the embeddings are untied (deepseek-coder), and a bridged JAX
    tree comes back bit for bit."""
    _, cfg_t, params_j, params_t = setup
    slot = params_t["groups"][0]["slots"][0]
    post = any(s.post_norms for g in cfg_t.groups for s in g.pattern)
    assert ("post_norm" in slot and "post_mlp_norm" in slot) == post
    assert ("head" in params_t) == (not cfg_t.tie_embeddings)
    back = bridge.params_to_numpy(params_t)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params_j)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_forward_matches_jax(setup):
    cfg_j, cfg_t, params_j, params_t = setup
    toks = _tokens(0, 2, 32, cfg_t.vocab_size)
    want, _ = jmodel.forward(params_j, cfg_j, jnp.asarray(toks))
    got, aux = tmodel.forward(params_t, cfg_t, torch.from_numpy(toks))
    assert got.shape == (2, 32, cfg_t.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert float(aux["moe_aux_loss"]) == 0.0


def test_prefill_decode_logits_and_caches_match_jax(setup):
    cfg_j, cfg_t, params_j, params_t = setup
    b, s = 2, 32
    toks = _tokens(1, b, s, cfg_t.vocab_size)
    cache_j = jmodel.init_cache(cfg_j, b, s + 4)
    cache_t = tmodel.init_cache(cfg_t, b, s + 4, device="cpu")
    pre_j, cache_j = jmodel.prefill(params_j, cfg_j,
                                    jnp.asarray(toks[:, :-1]), cache_j)
    pre_t, cache_t = tmodel.prefill(params_t, cfg_t,
                                    torch.from_numpy(toks[:, :-1]), cache_t)
    np.testing.assert_allclose(pre_t.numpy(), np.asarray(pre_j), **LOGIT_TOL)
    pos = np.full((b,), s - 1, np.int32)
    dec_j, cache_j = jmodel.decode_step(params_j, cfg_j,
                                        jnp.asarray(toks[:, -1:]), cache_j,
                                        jnp.asarray(pos))
    dec_t, cache_t = tmodel.decode_step(params_t, cfg_t,
                                        torch.from_numpy(toks[:, -1:]),
                                        cache_t, torch.from_numpy(pos))
    np.testing.assert_allclose(dec_t.numpy(), np.asarray(dec_j), **LOGIT_TOL)
    mine = bridge.params_to_numpy(cache_t)
    theirs = jax.tree.map(np.asarray, cache_j)
    assert jax.tree.structure(mine) == jax.tree.structure(theirs)
    for a, b_ in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
        np.testing.assert_allclose(a, b_, **CACHE_TOL)


def test_prefill_decode_matches_forward(setup):
    """prefill(t[:-1]) + one decode step gives the last forward logits
    (tests/test_models.py::test_prefill_decode_matches_forward)."""
    _, cfg_t, _, params_t = setup
    b, s = 2, 32
    toks = torch.from_numpy(_tokens(2, b, s, cfg_t.vocab_size))
    full, _ = tmodel.forward(params_t, cfg_t, toks)
    cache = tmodel.init_cache(cfg_t, b, s + 4, device="cpu")
    _, cache = tmodel.prefill(params_t, cfg_t, toks[:, :-1], cache)
    dec, _ = tmodel.decode_step(params_t, cfg_t, toks[:, -1:], cache,
                                torch.full((b,), s - 1, dtype=torch.int32))
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(),
                               **LOGIT_TOL)


def test_bridge_round_trips_bf16_tree():
    cfg = dataclasses.replace(
        jconfigs.get_config("llama3.2-1b", smoke=True), dtype="bfloat16")
    tree = jax.tree.map(np.asarray,
                        jmodel.init_params(jax.random.PRNGKey(3), cfg))
    assert jax.tree.leaves(tree)[0].dtype.name == "bfloat16"
    moved = bridge.params_from_numpy(tree, "cpu")
    leaves = jax.tree.leaves(moved)
    assert all(t.dtype == torch.bfloat16 for t in leaves)
    assert isinstance(moved["groups"][0]["slots"], tuple)
    back = bridge.params_to_numpy(moved)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == np.uint16
        np.testing.assert_array_equal(a, b.view(np.uint16))
    # the bits are the values: bf16 -> f32 agrees on both sides
    t0 = leaves[0].float().numpy()
    np.testing.assert_array_equal(t0, jax.tree.leaves(tree)[0].astype(
        np.float32))


# ---------------------------------------------------------------------------
# zamba2: mamba2 layers and a weight-shared attention+GLU slot
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def zsetup():
    cfg_j = jconfigs.get_config("zamba2-2.7b", smoke=True)
    cfg_t = tconfigs.get_config("zamba2-2.7b", smoke=True)
    params_j = jmodel.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        "cpu")
    return cfg_j, cfg_t, params_j, params_t


def test_zamba2_bridge_round_trips_params_and_cache(zsetup):
    """init_params and init_cache give JAX's trees (keys, shapes, dtypes:
    fp32 a_log/dt_bias/d_skip and ssm state, unstacked shared slot), and
    a bridged JAX tree comes back bit for bit."""
    cfg_j, cfg_t, params_j, params_t = zsetup
    shared = cfg_t.groups[0].pattern.index(
        next(p for p in cfg_t.groups[0].pattern if p.shared))
    assert params_t["groups"][0]["slots"][shared]["mixer"]["wq"].dim() == 2
    mine_p = bridge.params_to_numpy(
        tmodel.init_params(torch.Generator().manual_seed(0), cfg_t, "cpu"))
    mine_c = bridge.params_to_numpy(
        tmodel.init_cache(cfg_t, 2, 24, device="cpu"))
    for mine, theirs in ((mine_p, params_j),
                         (mine_c, jmodel.init_cache(cfg_j, 2, 24))):
        theirs = jax.tree.map(np.asarray, theirs)
        assert jax.tree.structure(mine) == jax.tree.structure(theirs)
        for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
            assert a.shape == b.shape and a.dtype == b.dtype
    back = bridge.params_to_numpy(params_t)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params_j)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_zamba2_forward_matches_jax(zsetup):
    cfg_j, cfg_t, params_j, params_t = zsetup
    toks = _tokens(3, 2, 37, cfg_t.vocab_size)
    want, _ = jmodel.forward(params_j, cfg_j, jnp.asarray(toks))
    got, _ = tmodel.forward(params_t, cfg_t, torch.from_numpy(toks))
    assert got.shape == (2, 37, cfg_t.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


@pytest.mark.parametrize("s", [32, 37])  # 37: not a chunk multiple
def test_zamba2_prefill_decode_logits_and_caches_match_jax(zsetup, s):
    cfg_j, cfg_t, params_j, params_t = zsetup
    b = 2
    toks = _tokens(s, b, s, cfg_t.vocab_size)
    cache_j = jmodel.init_cache(cfg_j, b, s + 4)
    cache_t = tmodel.init_cache(cfg_t, b, s + 4, device="cpu")
    pre_j, cache_j = jmodel.prefill(params_j, cfg_j,
                                    jnp.asarray(toks[:, :-1]), cache_j)
    pre_t, cache_t = tmodel.prefill(params_t, cfg_t,
                                    torch.from_numpy(toks[:, :-1]), cache_t)
    np.testing.assert_allclose(pre_t.numpy(), np.asarray(pre_j), **LOGIT_TOL)
    pos = np.full((b,), s - 1, np.int32)
    dec_j, cache_j = jmodel.decode_step(params_j, cfg_j,
                                        jnp.asarray(toks[:, -1:]), cache_j,
                                        jnp.asarray(pos))
    dec_t, cache_t = tmodel.decode_step(params_t, cfg_t,
                                        torch.from_numpy(toks[:, -1:]),
                                        cache_t, torch.from_numpy(pos))
    np.testing.assert_allclose(dec_t.numpy(), np.asarray(dec_j), **LOGIT_TOL)
    mine = bridge.params_to_numpy(cache_t)
    theirs = jax.tree.map(np.asarray, cache_j)
    assert jax.tree.structure(mine) == jax.tree.structure(theirs)
    for a, b_ in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
        np.testing.assert_allclose(a, b_, **LOGIT_TOL)


def test_zamba2_prefill_decode_matches_forward(zsetup):
    """prefill(t[:-1]) + one decode step gives the last forward logits
    (tests/test_models.py::test_prefill_decode_matches_forward)."""
    _, cfg_t, _, params_t = zsetup
    b, s = 2, 32
    toks = torch.from_numpy(_tokens(4, b, s, cfg_t.vocab_size))
    full, _ = tmodel.forward(params_t, cfg_t, toks)
    cache = tmodel.init_cache(cfg_t, b, s + 4, device="cpu")
    _, cache = tmodel.prefill(params_t, cfg_t, toks[:, :-1], cache)
    dec, _ = tmodel.decode_step(params_t, cfg_t, toks[:, -1:], cache,
                                torch.full((b,), s - 1, dtype=torch.int32))
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(),
                               **LOGIT_TOL)


def test_pure_mlp_layers_match_jax():
    """kind="none" layers (MLP only, no mixer, empty cache) as JAX runs
    them: a llama smoke config whose pattern is (attn, none)."""
    from repro.models.config import GroupSpec as JGroup
    from repro.models.config import LayerSpec as JSpec
    from repro_torch.models.config import GroupSpec, LayerSpec
    cfg_j = dataclasses.replace(
        jconfigs.get_config("llama3.2-1b", smoke=True),
        groups=(JGroup(pattern=(JSpec(), JSpec(kind="none")), repeat=2),))
    cfg_t = dataclasses.replace(
        tconfigs.get_config("llama3.2-1b", smoke=True),
        groups=(GroupSpec(pattern=(LayerSpec(), LayerSpec(kind="none")),
                          repeat=2),))
    params_j = jmodel.init_params(jax.random.PRNGKey(5), cfg_j)
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        "cpu")
    assert set(params_t["groups"][0]["slots"][1]) == {"pre_mlp_norm", "mlp"}
    toks = _tokens(5, 2, 16, cfg_t.vocab_size)
    want, _ = jmodel.forward(params_j, cfg_j, jnp.asarray(toks))
    got, _ = tmodel.forward(params_t, cfg_t, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    cache = tmodel.init_cache(cfg_t, 2, 20, device="cpu")
    assert cache[0]["slots"][1] == {}
    pre, _ = tmodel.prefill(params_t, cfg_t, torch.from_numpy(toks), cache)
    np.testing.assert_allclose(pre[:, 0].numpy(), np.asarray(want)[:, -1],
                               **LOGIT_TOL)


@pytest.mark.parametrize("spec", [dict(kind="rwkv"), dict(mlp="switch")])
def test_unported_layers_raise(spec):
    from repro_torch.models import blocks
    from repro_torch.models.config import LayerSpec
    cfg = tconfigs.get_config("llama3.2-1b", smoke=True)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        blocks.init_layer(torch.Generator(), cfg, LayerSpec(**spec), "cpu")


# ---------------------------------------------------------------------------
# the optimized configs: fused QKV and gate/up projections
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS + NEW)
def test_optimized_config_matches_jax(arch):
    from repro.configs.optimized import _OVERRIDES as JAX_OVERRIDES
    from repro.configs.optimized import optimized_config as jopt_config
    from repro_torch.configs.optimized import _OVERRIDES, optimized_config
    cj, ct = jopt_config(arch), optimized_config(arch)
    for name in ("fuse_qkv", "fuse_glu", "seq_parallel", "remat",
                 "optimizer", "d_model", "num_layers"):
        assert getattr(ct, name) == getattr(cj, name), name
    key = tconfigs.canonical(arch)
    assert _OVERRIDES[key] == JAX_OVERRIDES[key]
    for other in UNPORTED:
        with pytest.raises(NotImplementedError, match="not ported yet"):
            optimized_config(other)


def test_fused_qkv_matches_unfused():
    """tests/test_optimized_configs.py::test_fused_qkv_matches_unfused on
    the port: the fused weight is the concatenation of wq, wk and wv."""
    from repro_torch.models import attention
    from repro_torch.models.config import LayerSpec
    base = tconfigs.get_config("llama3.2-1b", smoke=True)
    spec = LayerSpec(kind="attn", mlp="glu")
    p = attention.init_attn(torch.Generator().manual_seed(0), base, spec,
                            "cpu")
    pf = {"wqkv": torch.cat([p["wq"], p["wk"], p["wv"]], dim=-1),
          "wo": p["wo"]}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 16, base.d_model)).astype(np.float32))
    pos = torch.arange(16)[None].expand(2, 16)
    want, _ = attention.apply_attn(p, base, spec, x, pos)
    got, _ = attention.apply_attn(
        pf, dataclasses.replace(base, fuse_qkv=True), spec, x, pos)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_fused_glu_matches_unfused():
    """tests/test_optimized_configs.py::test_fused_glu_matches_unfused on
    the port: wgu = stack(wi, wu) on a new axis 1, (D, 2, F)."""
    from repro_torch.models import mlp
    base = tconfigs.get_config("llama3.2-1b", smoke=True)
    p = mlp.init_mlp(torch.Generator().manual_seed(0), base, "cpu")
    pf = {"wgu": torch.stack([p["wi"], p["wu"]], dim=1), "wo": p["wo"]}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 16, base.d_model)).astype(np.float32))
    want = mlp.apply_mlp(p, base, x)
    got = mlp.apply_mlp(pf, dataclasses.replace(base, fuse_glu=True), x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_optimized_smoke_forward_and_decode_match_jax(arch):
    """The optimized overrides on each smoke config: the param trees
    (``wqkv``, ``wgu``) and the training forward's, prefill's and a decode
    step's logits against JAX on bridged params."""
    from repro.configs.optimized import _OVERRIDES as JAX_OVERRIDES
    from repro_torch.configs.optimized import _OVERRIDES
    key = tconfigs.canonical(arch)
    assert _OVERRIDES[key] == JAX_OVERRIDES[key]
    cfg_t = dataclasses.replace(tconfigs.get_config(arch, smoke=True),
                                **_OVERRIDES[key])
    cfg_j = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                                **JAX_OVERRIDES[key])
    params_j = jmodel.init_params(jax.random.PRNGKey(3), cfg_j)
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        "cpu")
    mine = bridge.params_to_numpy(tmodel.init_params(
        torch.Generator().manual_seed(0), cfg_t, "cpu"))
    assert jax.tree.structure(mine) == jax.tree.structure(
        jax.tree.map(np.asarray, params_j))
    slots = params_t["groups"][0]["slots"]
    assert any("wgu" in s.get("mlp", {}) for s in slots)
    assert any("wqkv" in s.get("mixer", {}) for s in slots) == \
        cfg_t.fuse_qkv
    b, s = 2, 12
    toks = _tokens(7, b, s + 1, cfg_t.vocab_size)
    want, _ = jmodel.forward(params_j, cfg_j, jnp.asarray(toks[:, :-1]))
    got, _ = tmodel.forward(params_t, cfg_t, torch.from_numpy(toks[:, :-1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    cache_j = jmodel.init_cache(cfg_j, b, s + 4)
    cache_t = tmodel.init_cache(cfg_t, b, s + 4, device="cpu")
    pre_j, cache_j = jmodel.prefill(params_j, cfg_j,
                                    jnp.asarray(toks[:, :-1]), cache_j)
    pre_t, cache_t = tmodel.prefill(params_t, cfg_t,
                                    torch.from_numpy(toks[:, :-1]), cache_t)
    np.testing.assert_allclose(pre_t.numpy(), np.asarray(pre_j), **LOGIT_TOL)
    pos = np.full((b,), s, np.int32)
    dec_j, _ = jmodel.decode_step(params_j, cfg_j, jnp.asarray(toks[:, -1:]),
                                  cache_j, jnp.asarray(pos))
    dec_t, _ = tmodel.decode_step(params_t, cfg_t,
                                  torch.from_numpy(toks[:, -1:]), cache_t,
                                  torch.from_numpy(pos))
    np.testing.assert_allclose(dec_t.numpy(), np.asarray(dec_j), **LOGIT_TOL)


# ---------------------------------------------------------------------------
# the dense attention family: the gemma2 window and qk_norm
# ---------------------------------------------------------------------------

def test_gemma2_local_window_bites():
    """The gemma2 smoke model's local layers have a window of 8, shorter
    than the 24-token sequence: the port matches JAX there, and the same
    params without the window give other logits (the mask is live)."""
    cfg_j = jconfigs.get_config("gemma2-27b", smoke=True)
    cfg_t = tconfigs.get_config("gemma2-27b", smoke=True)
    windows = [s.window for g in cfg_t.groups for s in g.pattern]
    assert 0 < min(w for w in windows if w) < 24 and 0 in windows
    params_j = jmodel.init_params(jax.random.PRNGKey(4), cfg_j)
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        "cpu")
    toks = _tokens(14, 2, 24, cfg_t.vocab_size)
    want, _ = jmodel.forward(params_j, cfg_j, jnp.asarray(toks))
    got, _ = tmodel.forward(params_t, cfg_t, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    unwindowed = dataclasses.replace(cfg_t, groups=tuple(
        dataclasses.replace(g, pattern=tuple(
            dataclasses.replace(s, window=0) for s in g.pattern))
        for g in cfg_t.groups))
    other, _ = tmodel.forward(params_t, unwindowed, torch.from_numpy(toks))
    assert np.abs(other.numpy()[:, 8:] - got.numpy()[:, 8:]).max() > 1e-3
    np.testing.assert_allclose(other.numpy()[:, :8], got.numpy()[:, :8],
                               rtol=1e-5, atol=1e-5)


def test_qk_norm_matches_jax():
    """qk_norm (an RMSNorm over head_dim on q and k before RoPE, leaves
    ``q_norm`` and ``k_norm``), which no config turns on yet, on a smoke
    llama with ``qk_norm=True`` set on both sides: the params tree, the
    forward, prefill and decode logits."""
    from repro.models.config import GroupSpec as JGroup
    from repro.models.config import LayerSpec as JSpec
    from repro_torch.models.config import GroupSpec, LayerSpec
    cfg_j = dataclasses.replace(
        jconfigs.get_config("llama3.2-1b", smoke=True),
        groups=(JGroup(pattern=(JSpec(qk_norm=True),), repeat=2),))
    cfg_t = dataclasses.replace(
        tconfigs.get_config("llama3.2-1b", smoke=True),
        groups=(GroupSpec(pattern=(LayerSpec(qk_norm=True),), repeat=2),))
    params_j = jmodel.init_params(jax.random.PRNGKey(6), cfg_j)

    def bump(path, a):  # nonzero q/k norm scales: a misplaced norm shows
        key = jax.tree_util.keystr(path)
        return a + 0.3 if "q_norm" in key or "k_norm" in key else a

    params_j = jax.tree_util.tree_map_with_path(bump, params_j)
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        "cpu")
    mixer = params_t["groups"][0]["slots"][0]["mixer"]
    assert mixer["q_norm"]["scale"].shape == (2, cfg_t.head_dim)
    assert mixer["k_norm"]["scale"].shape == (2, cfg_t.head_dim)
    mine = bridge.params_to_numpy(tmodel.init_params(
        torch.Generator().manual_seed(0), cfg_t, "cpu"))
    assert jax.tree.structure(mine) == jax.tree.structure(
        jax.tree.map(np.asarray, params_j))
    b, s = 2, 16
    toks = _tokens(15, b, s + 1, cfg_t.vocab_size)
    want, _ = jmodel.forward(params_j, cfg_j, jnp.asarray(toks[:, :-1]))
    got, _ = tmodel.forward(params_t, cfg_t, torch.from_numpy(toks[:, :-1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    cache_j = jmodel.init_cache(cfg_j, b, s + 4)
    cache_t = tmodel.init_cache(cfg_t, b, s + 4, device="cpu")
    pre_j, cache_j = jmodel.prefill(params_j, cfg_j,
                                    jnp.asarray(toks[:, :-1]), cache_j)
    pre_t, cache_t = tmodel.prefill(params_t, cfg_t,
                                    torch.from_numpy(toks[:, :-1]), cache_t)
    np.testing.assert_allclose(pre_t.numpy(), np.asarray(pre_j), **LOGIT_TOL)
    pos = np.full((b,), s, np.int32)
    dec_j, _ = jmodel.decode_step(params_j, cfg_j, jnp.asarray(toks[:, -1:]),
                                  cache_j, jnp.asarray(pos))
    dec_t, _ = tmodel.decode_step(params_t, cfg_t,
                                  torch.from_numpy(toks[:, -1:]), cache_t,
                                  torch.from_numpy(pos))
    np.testing.assert_allclose(dec_t.numpy(), np.asarray(dec_j), **LOGIT_TOL)


# ---------------------------------------------------------------------------
# musicgen-medium: multi-codebook streams (tokens (B,S,K), summed (K,V,D)
# embeddings, an untied (K,D,V) head) over a plain GELU MLP
# ---------------------------------------------------------------------------

GRAD_REL_L2 = 1e-4          # tests/test_torch_train.py
STEP_UPDATE_REL_L2 = 1e-3   # tests/test_torch_train.py
OPT_KW = dict(lr=1e-2, warmup=3, decay_steps=10, weight_decay=0.1,
              grad_clip=0.5)


@pytest.fixture(scope="module")
def msetup():
    cfg_j = jconfigs.get_config("musicgen-medium", smoke=True)
    cfg_t = tconfigs.get_config("musicgen-medium", smoke=True)
    params_j = jmodel.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        "cpu")
    return cfg_j, cfg_t, params_j, params_t


def _codes(seed, b, s, cfg):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s, cfg.num_codebooks)).astype(np.int32)


def _batch(toks):
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _requiring_grad(params_j):
    from repro_torch.models.common import tree_map
    return tree_map(lambda a: a.requires_grad_(True), bridge.params_from_numpy(
        jax.tree.map(np.asarray, params_j), "cpu"))


def test_musicgen_trees_match_jax(msetup):
    """(K,V,D) embeddings and a (K,D,V) head, the rest of the tree as
    JAX's; a bridged tree comes back bit for bit."""
    cfg_j, cfg_t, params_j, params_t = msetup
    k, v, d = cfg_t.num_codebooks, cfg_t.vocab_size, cfg_t.d_model
    assert params_t["embed"].shape == (k, v, d)
    assert params_t["head"].shape == (k, d, v)
    mine = bridge.params_to_numpy(tmodel.init_params(
        torch.Generator().manual_seed(0), cfg_t, "cpu"))
    theirs = jax.tree.map(np.asarray, params_j)
    assert jax.tree.structure(mine) == jax.tree.structure(theirs)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
        assert a.shape == b.shape and a.dtype == b.dtype
    for a, b in zip(jax.tree.leaves(bridge.params_to_numpy(params_t)),
                    jax.tree.leaves(theirs)):
        np.testing.assert_array_equal(a, b)


def test_musicgen_forward_and_loss_match_jax(msetup):
    cfg_j, cfg_t, params_j, params_t = msetup
    toks = _codes(0, 2, 33, cfg_t)
    want, _ = jmodel.forward(params_j, cfg_j, jnp.asarray(toks[:, :-1]))
    got, _ = tmodel.forward(params_t, cfg_t, torch.from_numpy(toks[:, :-1]))
    assert got.shape == (2, 32, cfg_t.num_codebooks, cfg_t.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    b = _batch(toks)
    want_l, _ = jmodel.forward_loss(params_j, cfg_j, jnp.asarray(b["tokens"]),
                                    jnp.asarray(b["labels"]))
    got_l, _ = tmodel.forward_loss(params_t, cfg_t,
                                   torch.from_numpy(b["tokens"]),
                                   torch.from_numpy(b["labels"]))
    np.testing.assert_allclose(float(got_l), float(want_l), **LOGIT_TOL)
    # the loss is the cross-entropy of the (B,S,K,V) logits
    from repro_torch.train.train_step import cross_entropy
    torch.testing.assert_close(got_l, cross_entropy(
        got, torch.from_numpy(b["labels"])), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_musicgen_grads_match_jax(msetup, remat):
    """forward_loss's gradients, every leaf within GRAD_REL_L2 of JAX's,
    without remat and under musicgen-medium's own ("dots")."""
    from repro.train import train_step as jstep
    from repro_torch.train import train_step as tstep
    cfg_j, cfg_t, params_j, _ = msetup
    b = _batch(_codes(1, 2, 17, cfg_t))
    (want_loss, _), want_g = jax.value_and_grad(
        jstep.make_loss_fn(cfg_j), has_aux=True)(
            params_j, {k: jnp.asarray(v) for k, v in b.items()})
    (loss, _), grads = tstep.make_grad_fn(
        dataclasses.replace(cfg_t, remat=remat))(
            _requiring_grad(params_j),
            {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(loss), float(want_loss), **LOGIT_TOL)
    got = jax.tree.leaves(bridge.params_to_numpy(grads))
    want = jax.tree.leaves(jax.tree.map(np.asarray, want_g))
    assert len(got) == len(want)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        assert np.linalg.norm(a - w) / np.linalg.norm(w) < GRAD_REL_L2


def test_musicgen_prefill_decode_match_jax_and_forward(msetup):
    """prefill(t[:-1]) + one decode step of (B,1,K) tokens: logits and
    caches against JAX, and the decode logits against the forward's last
    position (tests/test_models.py:64-86)."""
    cfg_j, cfg_t, params_j, params_t = msetup
    b, s = 2, 32
    toks = _codes(2, b, s, cfg_t)
    cache_j = jmodel.init_cache(cfg_j, b, s + 4)
    cache_t = tmodel.init_cache(cfg_t, b, s + 4, device="cpu")
    pre_j, cache_j = jmodel.prefill(params_j, cfg_j,
                                    jnp.asarray(toks[:, :-1]), cache_j)
    pre_t, cache_t = tmodel.prefill(params_t, cfg_t,
                                    torch.from_numpy(toks[:, :-1]), cache_t)
    assert pre_t.shape == (b, 1, cfg_t.num_codebooks, cfg_t.vocab_size)
    np.testing.assert_allclose(pre_t.numpy(), np.asarray(pre_j), **LOGIT_TOL)
    pos = np.full((b,), s - 1, np.int32)
    dec_j, cache_j = jmodel.decode_step(params_j, cfg_j,
                                        jnp.asarray(toks[:, -1:]), cache_j,
                                        jnp.asarray(pos))
    dec_t, cache_t = tmodel.decode_step(params_t, cfg_t,
                                        torch.from_numpy(toks[:, -1:]),
                                        cache_t, torch.from_numpy(pos))
    np.testing.assert_allclose(dec_t.numpy(), np.asarray(dec_j), **LOGIT_TOL)
    for a, w in zip(jax.tree.leaves(bridge.params_to_numpy(cache_t)),
                    jax.tree.leaves(jax.tree.map(np.asarray, cache_j))):
        np.testing.assert_allclose(a, w, **CACHE_TOL)
    full, _ = tmodel.forward(params_t, cfg_t, torch.from_numpy(toks))
    np.testing.assert_allclose(dec_t[:, 0].numpy(), full[:, -1].numpy(),
                               **LOGIT_TOL)


def test_musicgen_train_step_matches_jax(msetup):
    """One AdamW train step: loss, gradient norm, and each leaf's update
    within STEP_UPDATE_REL_L2 of JAX's (tests/test_torch_train.py)."""
    from repro.train import optimizer as jopt
    from repro.train import train_step as jstep
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_step as tstep
    cfg_j, cfg_t, params_j, _ = msetup
    b = _batch(_codes(3, 4, 17, cfg_t))
    opt_j = jopt.make_optimizer("adamw", **OPT_KW)
    opt_t = topt.make_optimizer("adamw", **OPT_KW)
    pj, _, mj = jax.jit(jstep.make_train_step(cfg_j, opt_j))(
        params_j, opt_j.init(params_j),
        {k: jnp.asarray(v) for k, v in b.items()})
    pt = _requiring_grad(params_j)
    pt, _, mt = tstep.make_train_step(cfg_t, opt_t)(
        pt, opt_t.init(pt), {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               **LOGIT_TOL)
    np.testing.assert_allclose(float(mt["grad_norm"]),
                               float(mj["grad_norm"]), rtol=1e-4)
    for a, w, p0 in zip(jax.tree.leaves(bridge.params_to_numpy(pt)),
                        jax.tree.leaves(pj), jax.tree.leaves(params_j)):
        p0 = np.asarray(p0)
        want = np.asarray(w) - p0
        assert np.abs(want).max() > 0
        assert np.linalg.norm((a - p0) - want) / np.linalg.norm(want) \
            < STEP_UPDATE_REL_L2


def test_musicgen_optimized_smoke_matches_jax():
    """musicgen's optimized override (fused QKV and gate/up over a plain
    MLP, where the GLU fusion does nothing; remat "full") on its smoke
    config: the tree and the forward logits against JAX."""
    from repro.configs.optimized import _OVERRIDES as JAX_OVERRIDES
    over = JAX_OVERRIDES["musicgen_medium"]
    cfg_j = dataclasses.replace(
        jconfigs.get_config("musicgen-medium", smoke=True), **over)
    cfg_t = dataclasses.replace(
        tconfigs.get_config("musicgen-medium", smoke=True), **over)
    params_j = jmodel.init_params(jax.random.PRNGKey(3), cfg_j)
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        "cpu")
    slot = params_t["groups"][0]["slots"][0]
    assert "wqkv" in slot["mixer"] and "wgu" not in slot["mlp"]
    toks = _codes(4, 2, 12, cfg_t)
    want, _ = jmodel.forward(params_j, cfg_j, jnp.asarray(toks))
    got, _ = tmodel.forward(params_t, cfg_t, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_engine_refuses_codebook_configs(msetup):
    """The engine serves one token stream a request (as the JAX engine,
    which fails on a codebook config at ``int(req.prompt[-1])``)."""
    from repro_torch.serve.engine import ServingEngine
    _, cfg_t, _, params_t = msetup
    with pytest.raises(NotImplementedError, match="codebooks"):
        ServingEngine(cfg_t, params_t, device="cpu")
