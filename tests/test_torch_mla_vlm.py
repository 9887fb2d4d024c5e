"""DeepSeek MLA and gated cross-attention of the port
(repro_torch.models.attention) against the JAX package's, and the three
models that need them and MoE (grok-1-314b, deepseek-v3-671b,
llama-3.2-vision-90b) as whole models, on JAX-initialised params moved
over by repro_torch.bridge (smoke configs, fp32, CPU).

Cross-attention's gate starts at 0 (tanh(0) = 0 would hide the whole
layer) and deepseek-v3's router bias at 0 (it moves the selection only):
both are set to nonzero values from a seed before any comparison."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_models.py
CACHE_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_REL_L2 = 1e-3
# moe_dropped = 1 - kept / choices, to one fp32 ulp of 1: XLA evaluates
# JAX's form as a fused multiply-add with the reciprocal (-2**-27 where
# nothing drops)
DROPPED_TOL = dict(rtol=0, atol=2**-23)
ARCHS = ("grok-1-314b", "deepseek-v3-671b", "llama-3.2-vision-90b")


def _live(params_j, seed):
    """JAX params with every cross-attention ``gate`` and every router
    ``bias`` set to nonzero values drawn from ``seed``."""
    rng = np.random.default_rng(seed)

    def fix(path, a):
        name = jax.tree_util.keystr(path)
        if name.endswith("['gate']"):
            return jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype)
        if name.endswith("['router']['bias']"):
            return jnp.asarray(rng.standard_normal(a.shape) * 0.1, a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(fix, params_j)


def _bridged(params_j):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                    "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    cfg_j = jconfigs.get_config(request.param, smoke=True)
    cfg_t = tconfigs.get_config(request.param, smoke=True)
    params_j = _live(jmodel.init_params(jax.random.PRNGKey(0), cfg_j), 1)
    return cfg_j, cfg_t, params_j, _bridged(params_j)


def _inputs(cfg, seed, b, s):
    """Tokens (B,S) and, for a VLM, image embeddings (B,N_img,vision)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    img = (rng.standard_normal((b, cfg.num_image_tokens, cfg.vision_dim))
           .astype(np.float32) if cfg.vision_dim else None)
    return toks, img


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def test_live_gates_and_biases(setup):
    """The params under test have a nonzero gate on every cross-attention
    layer and a nonzero bias on every router, and come back bit for
    bit through the bridge."""
    cfg_j, _, params_j, params_t = setup
    names = {jax.tree_util.keystr(p): np.asarray(a) for p, a in
             jax.tree_util.tree_leaves_with_path(params_j)}
    for name, a in names.items():
        if name.endswith("['gate']") or name.endswith("['bias']"):
            assert np.all(a != 0), name
    kinds = {s.kind for g in cfg_j.groups for s in g.pattern}
    assert any(n.endswith("['gate']") for n in names) == \
        ("cross_attn" in kinds)
    for a, b in zip(jax.tree.leaves(bridge.params_to_numpy(params_t)),
                    jax.tree.leaves(params_j)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_forward_and_loss_match_jax(setup):
    """Logits at 2e-4, the loss at 2e-4, and the MoE statistics summed
    over the layers: ``moe_dropped`` to an ulp, ``moe_aux_loss`` at
    1e-6."""
    cfg_j, cfg_t, params_j, params_t = setup
    toks, img = _inputs(cfg_t, 0, 2, 17)
    want, aux_j = jmodel.forward(params_j, cfg_j, jnp.asarray(toks),
                                 _j(img))
    got, aux_t = tmodel.forward(params_t, cfg_t, torch.from_numpy(toks),
                                _t(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    loss_j, laux_j = jmodel.forward_loss(
        params_j, cfg_j, jnp.asarray(toks[:, :-1]),
        jnp.asarray(toks[:, 1:]), _j(img))
    loss_t, laux_t = tmodel.forward_loss(
        params_t, cfg_t, torch.from_numpy(toks[:, :-1]),
        torch.from_numpy(toks[:, 1:]), _t(img))
    np.testing.assert_allclose(float(loss_t), float(loss_j), **LOGIT_TOL)
    for a_t, a_j in ((aux_t, aux_j), (laux_t, laux_j)):
        np.testing.assert_allclose(float(a_t["moe_dropped"]),
                                   float(a_j["moe_dropped"]), **DROPPED_TOL)
        np.testing.assert_allclose(float(a_t["moe_aux_loss"]),
                                   float(a_j["moe_aux_loss"]), rtol=1e-6)
        assert (float(a_t["moe_aux_loss"]) > 0) == (cfg_t.moe is not None
                                                    and cfg_t.moe.router
                                                    == "softmax")


def test_prefill_decode_match_jax_and_forward(setup):
    """prefill(t[:-1]) and one decode step: logits at 2e-4 and every cache
    leaf at 2e-5 against JAX, and the decode logits against the forward's
    last position (tests/test_models.py:64-86).  The VLM's decode step
    reads the image keys and values from the cache."""
    cfg_j, cfg_t, params_j, params_t = setup
    b, s = 2, 24
    toks, img = _inputs(cfg_t, 1, b, s)
    cache_j = jmodel.init_cache(cfg_j, b, s + 4)
    cache_t = tmodel.init_cache(cfg_t, b, s + 4, device="cpu")
    pre_j, cache_j = jmodel.prefill(params_j, cfg_j,
                                    jnp.asarray(toks[:, :-1]), cache_j,
                                    _j(img))
    pre_t, cache_t = tmodel.prefill(params_t, cfg_t,
                                    torch.from_numpy(toks[:, :-1]), cache_t,
                                    _t(img))
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
    for a, w in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
        assert a.shape == w.shape and a.dtype == w.dtype
        np.testing.assert_allclose(a, w, **CACHE_TOL)
    full, _ = tmodel.forward(params_t, cfg_t, torch.from_numpy(toks),
                             _t(img))
    np.testing.assert_allclose(dec_t[:, 0].numpy(), full[:, -1].numpy(),
                               **LOGIT_TOL)


def test_grads_match_jax(setup):
    """The train step's loss (the cross-entropy plus ``moe_aux_loss``) and
    its gradients, every leaf within 1e-3 rel. L2 of JAX's (a leaf JAX
    gives no gradient, as a router bias, gets none here either), with the
    image embeddings in the batch for the VLM."""
    from repro.train import train_step as jstep
    from repro_torch.models.common import tree_map
    from repro_torch.train import train_step as tstep
    cfg_j, cfg_t, params_j, _ = setup
    toks, img = _inputs(cfg_t, 2, 2, 17)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if img is not None:
        batch["image_embeds"] = img
    (want_total, want_m), want_g = jax.value_and_grad(
        jstep.make_loss_fn(cfg_j), has_aux=True)(
            params_j, {k: jnp.asarray(v) for k, v in batch.items()})
    params = tree_map(lambda a: a.requires_grad_(True), _bridged(params_j))
    (total, metrics), grads = tstep.make_grad_fn(cfg_t)(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(total), float(want_total), **LOGIT_TOL)
    np.testing.assert_allclose(float(metrics["moe_dropped"]),
                               float(want_m["moe_dropped"]), **DROPPED_TOL)
    np.testing.assert_allclose(float(metrics["moe_aux_loss"]),
                               float(want_m["moe_aux_loss"]), rtol=1e-6)
    got = jax.tree_util.tree_leaves_with_path(bridge.params_to_numpy(grads))
    want = jax.tree.leaves(jax.tree.map(np.asarray, want_g))
    assert len(got) == len(want)
    for (path, a), w in zip(got, want):
        assert a.shape == w.shape
        if not np.any(w):
            assert not np.any(a), jax.tree_util.keystr(path)
            continue
        rel = np.linalg.norm(a - w) / np.linalg.norm(w)
        assert rel < GRAD_REL_L2, (jax.tree_util.keystr(path), rel)


def test_engine_refuses_vision_config():
    """As the JAX engine (repro/serve/engine.py:74): requests carry no
    image embeddings."""
    from repro_torch.serve.engine import ServingEngine
    cfg = tconfigs.get_config("llama-3.2-vision-90b", smoke=True)
    params = tmodel.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    with pytest.raises(NotImplementedError, match="image"):
        ServingEngine(cfg, params, device="cpu")


# ---------------------------------------------------------------------------
# MLA, one layer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mla():
    cfg_j = jconfigs.get_config("deepseek-v3-671b", smoke=True)
    cfg_t = tconfigs.get_config("deepseek-v3-671b", smoke=True)
    spec = cfg_j.groups[0].pattern[0]
    p_j = jattn.init_mla(jax.random.PRNGKey(4), cfg_j, spec)
    # nonzero norm scales, so q_norm and kv_norm are not the identity
    p_j = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.3 * jax.random.normal(jax.random.PRNGKey(5),
                                                    a.shape)
        if "norm" in jax.tree_util.keystr(path) else a, p_j)
    return cfg_j, cfg_t, spec, p_j, _bridged(p_j)


def _mla_run(apply, cfg, spec, p, x, cache, absorbed, to_array):
    """Prefill of x[:, :-1] into ``cache``, then a decode step of x[:, -1:]
    at position S - 1: (prefill out, decode out, cache)."""
    b, s, _ = x.shape
    pos = np.broadcast_to(np.arange(s - 1)[None], (b, s - 1)).astype(
        np.int32)
    out_p, cache = apply(p, cfg, spec, x[:, :-1], to_array(pos), cache,
                         absorbed=absorbed)
    out_d, cache = apply(p, cfg, spec, x[:, -1:],
                         to_array(np.full((b, 1), s - 1, np.int32)), cache,
                         absorbed=absorbed)
    return out_p, out_d, cache


@pytest.mark.parametrize("absorbed", [False, True])
def test_mla_matches_jax(mla, absorbed):
    """apply_mla's training form, prefill and decode (naive and absorbed)
    against JAX at 2e-4, its cache (``ckv``, ``krope``) at 2e-5, and the
    absorbed form against the naive one at 2e-4
    (tests/test_optimized_configs.py:87-108)."""
    cfg_j, cfg_t, spec, p_j, p_t = mla
    b, s = 2, 13
    x = np.random.default_rng(6).standard_normal(
        (b, s, cfg_t.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)
    want, _ = jattn.apply_mla(p_j, cfg_j, spec, jnp.asarray(x),
                              jnp.asarray(pos), absorbed=absorbed)
    got, none = tattn.apply_mla(p_t, cfg_t, spec, torch.from_numpy(x),
                                torch.from_numpy(pos), absorbed=absorbed)
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)

    pj, dj, cj = _mla_run(jattn.apply_mla, cfg_j, spec, p_j, jnp.asarray(x),
                          jattn.init_mla_cache(cfg_j, spec, b, 16,
                                               jnp.float32),
                          absorbed, jnp.asarray)
    pt, dt, ct = _mla_run(tattn.apply_mla, cfg_t, spec, p_t,
                          torch.from_numpy(x),
                          tattn.init_mla_cache(cfg_t, spec, b, 16,
                                               torch.float32, "cpu"),
                          absorbed, torch.from_numpy)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **LOGIT_TOL)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **LOGIT_TOL)
    for k in ("ckv", "krope"):
        np.testing.assert_allclose(ct[k].numpy(), np.asarray(cj[k]),
                                   **CACHE_TOL)
    # the decode step against the training form's last position
    np.testing.assert_allclose(dt[:, 0].numpy(), got[:, -1].numpy(),
                               **LOGIT_TOL)
    if absorbed:
        pn, dn, _ = _mla_run(tattn.apply_mla, cfg_t, spec, p_t,
                             torch.from_numpy(x),
                             tattn.init_mla_cache(cfg_t, spec, b, 16,
                                                  torch.float32, "cpu"),
                             False, torch.from_numpy)
        np.testing.assert_allclose(pt.numpy(), pn.numpy(), **LOGIT_TOL)
        np.testing.assert_allclose(dt.numpy(), dn.numpy(), **LOGIT_TOL)


@pytest.mark.parametrize("absorbed", [False, True])
def test_mla_query_blocks_match_jax(mla, monkeypatch, absorbed):
    """Past the block threshold the causal attention runs in query blocks,
    each against the keys up to its last query: with the threshold at 8
    and blocks of 4, a 16-token prompt runs in 4 blocks, equal to the
    unblocked form and to JAX's blocks."""
    cfg_j, cfg_t, spec, p_j, p_t = mla
    x = np.random.default_rng(7).standard_normal(
        (2, 16, cfg_t.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16)[None], (2, 16)).astype(np.int32)
    whole, _ = tattn.apply_mla(p_t, cfg_t, spec, torch.from_numpy(x),
                               torch.from_numpy(pos), absorbed=absorbed)
    for mod in (jattn, tattn):
        monkeypatch.setattr(mod, "_MLA_BLOCK_THRESHOLD", 8)
        monkeypatch.setattr(mod, "_MLA_Q_BLOCK", 4)
    want, _ = jattn.apply_mla(p_j, cfg_j, spec, jnp.asarray(x),
                              jnp.asarray(pos), absorbed=absorbed)
    got, _ = tattn.apply_mla(p_t, cfg_t, spec, torch.from_numpy(x),
                             torch.from_numpy(pos), absorbed=absorbed)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), **LOGIT_TOL)


def test_mla_absorbed_model_matches_naive_and_jax():
    """The whole deepseek-v3 smoke model's prefill and decode with
    ``mla_absorbed``: against the naive form at 2e-4 and JAX's absorbed
    form at 2e-4 (tests/test_optimized_configs.py:87-108)."""
    cfg_j = jconfigs.get_config("deepseek-v3-671b", smoke=True)
    cfg_t = tconfigs.get_config("deepseek-v3-671b", smoke=True)
    params_j = _live(jmodel.init_params(jax.random.PRNGKey(0), cfg_j), 3)
    params_t = _bridged(params_j)
    toks, _ = _inputs(cfg_t, 8, 2, 16)
    pos = np.full((2,), 16, np.int32)
    got = {}
    for absorbed in (False, True):
        cache = tmodel.init_cache(cfg_t, 2, 32, device="cpu")
        pre, cache = tmodel.prefill(params_t, cfg_t, torch.from_numpy(toks),
                                    cache, mla_absorbed=absorbed)
        dec, _ = tmodel.decode_step(params_t, cfg_t,
                                    torch.from_numpy(toks[:, :1]), cache,
                                    torch.from_numpy(pos),
                                    mla_absorbed=absorbed)
        got[absorbed] = (pre.numpy(), dec.numpy())
    cache = jmodel.init_cache(cfg_j, 2, 32)
    pre_j, cache = jmodel.prefill(params_j, cfg_j, jnp.asarray(toks), cache,
                                  mla_absorbed=True)
    dec_j, _ = jmodel.decode_step(params_j, cfg_j, jnp.asarray(toks[:, :1]),
                                  cache, jnp.asarray(pos), mla_absorbed=True)
    for a, n, j in zip(got[True], got[False], (pre_j, dec_j)):
        np.testing.assert_allclose(a, n, **LOGIT_TOL)
        np.testing.assert_allclose(a, np.asarray(j), **LOGIT_TOL)


# ---------------------------------------------------------------------------
# Gated cross-attention, one layer
# ---------------------------------------------------------------------------

def test_cross_attn_matches_jax():
    """Prefill with the image embeddings (the cache filled with their keys
    and values) and a decode step from the filled cache, at a nonzero
    gate, against JAX at 2e-4; the gate scales the output by its tanh,
    and other image embeddings give another output."""
    cfg_j = jconfigs.get_config("llama-3.2-vision-90b", smoke=True)
    cfg_t = tconfigs.get_config("llama-3.2-vision-90b", smoke=True)
    spec = cfg_j.groups[0].pattern[1]
    assert spec.kind == "cross_attn"
    p_j = jattn.init_cross_attn(jax.random.PRNGKey(6), cfg_j, spec)
    p_j = dict(p_j, gate=jnp.asarray(0.7, jnp.float32))
    p_t = _bridged(p_j)
    rng = np.random.default_rng(9)
    b, s = 2, 9
    x = rng.standard_normal((b, s, cfg_t.d_model)).astype(np.float32)
    img = rng.standard_normal((b, cfg_t.num_image_tokens,
                               cfg_t.vision_dim)).astype(np.float32)

    want, _ = jattn.apply_cross_attn(p_j, cfg_j, spec, jnp.asarray(x),
                                     jnp.asarray(img))
    got, none = tattn.apply_cross_attn(p_t, cfg_t, spec,
                                       torch.from_numpy(x),
                                       torch.from_numpy(img))
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)

    cj = jattn.init_cross_cache(cfg_j, spec, b, 16, jnp.float32)
    ct = tattn.init_cross_cache(cfg_t, spec, b, 16, torch.float32, "cpu")
    pj, cj = jattn.apply_cross_attn(p_j, cfg_j, spec, jnp.asarray(x[:, :-1]),
                                    jnp.asarray(img), cj)
    pt, ct = tattn.apply_cross_attn(p_t, cfg_t, spec,
                                    torch.from_numpy(x[:, :-1]),
                                    torch.from_numpy(img), ct)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **LOGIT_TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(ct[k].numpy(), np.asarray(cj[k]),
                                   **CACHE_TOL)
    assert int(ct["filled"]) == int(cj["filled"]) == 1
    dj, _ = jattn.apply_cross_attn(p_j, cfg_j, spec, jnp.asarray(x[:, -1:]),
                                   None, cj)
    dt, _ = tattn.apply_cross_attn(p_t, cfg_t, spec,
                                   torch.from_numpy(x[:, -1:]), None, ct)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **LOGIT_TOL)
    np.testing.assert_allclose(dt[:, 0].numpy(), got[:, -1].numpy(),
                               **LOGIT_TOL)
    # the gate: tanh(0.7) times the ungated output; 0 at gate 0
    ungated, _ = tattn.apply_cross_attn(
        dict(p_t, gate=torch.tensor(20.0)), cfg_t, spec,
        torch.from_numpy(x), torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), np.tanh(0.7) * ungated.numpy(),
                               rtol=1e-5, atol=1e-6)
    closed, _ = tattn.apply_cross_attn(
        dict(p_t, gate=torch.tensor(0.0)), cfg_t, spec,
        torch.from_numpy(x), torch.from_numpy(img))
    assert not closed.any()
    other, _ = tattn.apply_cross_attn(p_t, cfg_t, spec, torch.from_numpy(x),
                                      torch.from_numpy(img[::-1].copy()))
    assert not torch.allclose(other, got)


def test_cross_attn_bf16_projects_fp32_embeddings_as_jax():
    """A bf16 layer given fp32 image embeddings (as a training batch
    carries them): JAX's einsum promotes them with the bf16 weights and
    projects K and V in fp32, and so does the port, which then rounds K
    and V to bf16 for the flash kernel.  The V cache (JAX's fp32 V rounded
    to bf16) agrees in all but 1% of its elements, where the embeddings
    rounded to bf16 before the projection disagree in about 40%; the
    output and the K cache within the bf16 tolerance."""
    from repro_torch.models.common import tree_map
    cfg_j = jconfigs.get_config("llama-3.2-vision-90b", smoke=True)
    cfg_t = tconfigs.get_config("llama-3.2-vision-90b", smoke=True)
    spec = cfg_j.groups[0].pattern[1]
    p_j = jattn.init_cross_attn(jax.random.PRNGKey(6), cfg_j, spec)
    p_j = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                       dict(p_j, gate=jnp.asarray(0.7, jnp.float32)))
    p_t = tree_map(lambda a: a.to(torch.bfloat16),
                   _bridged(jax.tree.map(lambda a: a.astype(jnp.float32),
                                         p_j)))
    rng = np.random.default_rng(9)
    b, s = 2, 9
    x = rng.standard_normal((b, s, cfg_t.d_model)).astype(np.float32)
    img = rng.standard_normal((b, cfg_t.num_image_tokens,
                               cfg_t.vision_dim)).astype(np.float32)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    cj = jattn.init_cross_cache(cfg_j, spec, b, 16, jnp.bfloat16)
    ct = tattn.init_cross_cache(cfg_t, spec, b, 16, torch.bfloat16, "cpu")
    want, cj = jattn.apply_cross_attn(p_j, cfg_j, spec, xj, jnp.asarray(img),
                                      cj)
    got, ct = tattn.apply_cross_attn(p_t, cfg_t, spec, xt,
                                     torch.from_numpy(img), ct)
    assert got.dtype == ct["v"].dtype == torch.bfloat16
    bf16_tol = dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **bf16_tol)
    np.testing.assert_allclose(ct["k"].float().numpy(),
                               np.asarray(cj["k"], np.float32), **bf16_tol)
    v_j = np.asarray(cj["v"], np.float32)
    assert np.mean(ct["v"].float().numpy() != v_j) <= 0.01
    rounded = tattn.init_cross_cache(cfg_t, spec, b, 16, torch.bfloat16,
                                     "cpu")
    tattn.apply_cross_attn(p_t, cfg_t, spec, xt,
                           torch.from_numpy(img).bfloat16(), rounded)
    assert np.mean(rounded["v"].float().numpy() != v_j) > 0.1


# tests/test_torch_train.py's tolerances: the loss (as tests/test_models.py)
# and the updated params
TRAIN_LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
TRAIN_PARAM_TOL = dict(rtol=1e-5, atol=1e-5)


def test_deepseek_v3_trainer_step_matches_jax():
    """deepseek-v3's smoke config (MLA, a dense layer and two MoE layers)
    takes one Adafactor step through the port's ``Trainer`` and through
    the JAX package's, from the same params (router biases set nonzero)
    on the same synthetic batch: the loss and every updated param and
    every leaf of the optimizer state as JAX has them."""
    from repro.train import optimizer as jopt
    from repro.train.trainer import Trainer as JTrainer
    from repro.train.trainer import TrainerConfig as JTrainerConfig
    from repro_torch.models.common import tree_map
    from repro_torch.train import optimizer as topt
    from repro_torch.train.trainer import Trainer, TrainerConfig
    arch = "deepseek-v3-671b"
    kw = dict(steps=1, global_batch=2, seq_len=16, log_every=10**9,
              eval_every=10**9)
    jt = JTrainer(jconfigs.get_config(arch, smoke=True), JTrainerConfig(**kw),
                  optimizer=jopt.make_optimizer("adafactor"))
    jt.params = _live(jt.params, 1)
    jt.opt_state = jt.opt.init(jt.params)
    tt = Trainer(tconfigs.get_config(arch, smoke=True), TrainerConfig(**kw),
                 optimizer=topt.make_optimizer("adafactor"), device="cpu")
    tt.params = tree_map(lambda a: a.requires_grad_(True),
                         _bridged(jt.params))
    tt.opt_state = tt.opt.init(tt.params)
    (want,), (got,) = jt.train(), tt.train()
    assert got["step"] == want["step"] == 1
    np.testing.assert_allclose(got["loss"], want["loss"], **TRAIN_LOSS_TOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-4)
    mine = bridge.params_to_numpy({"p": tt.params, "s": tt.opt_state})
    theirs = jax.tree.map(np.asarray, {"p": jt.params, "s": jt.opt_state})
    assert jax.tree.structure(mine) == jax.tree.structure(theirs)
    for (path, a), w in zip(jax.tree_util.tree_leaves_with_path(mine),
                            jax.tree.leaves(theirs)):
        assert a.shape == w.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(a, w, **TRAIN_PARAM_TOL,
                                   err_msg=jax.tree_util.keystr(path))
