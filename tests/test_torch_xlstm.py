"""The port's xLSTM (``repro_torch.models.xlstm``, ``ref.mlstm_chunkwise``)
against the JAX package's, on the CPU: the chunked mLSTM with and without
a carried state and across its padding, the quadratic oracle, the sLSTM
scan, the decode branches and caches, and the xlstm-350m smoke model
(forward, loss, gradients, prefill/decode, one AdamW step, the engine's
tokens) on JAX-initialised params bridged to torch."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jstep  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tstep  # noqa: E402

ARCH = "xlstm-350m"
F32 = dict(rtol=2e-5, atol=2e-5)          # tests/test_kernels.py
# the carried states c and n: rel. L2 against JAX's.  They sum products
# weighted by up to e^15 (GATE_CAP), so an element that cancels to ~0.1
# among terms of ~1e3 differs by more than F32's atol when the chunks are
# summed in another order (a loop here, an associative scan in JAX)
STATE_REL_L2 = 2e-5
ORACLE = dict(rtol=2e-3, atol=2e-3)       # tests/test_kernels.py:149-151
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)    # tests/test_models.py:85-86
GRAD_REL_L2 = 1e-4                        # tests/test_torch_train.py
PARAM_TOL = dict(rtol=1e-5, atol=1e-5)    # tests/test_torch_train.py
OPT_KW = dict(lr=1e-2, warmup=3, decay_steps=10, weight_decay=0.1,
              grad_clip=0.5)


@pytest.fixture(scope="module")
def setup():
    cfg_j = jconfigs.get_config(ARCH, smoke=True)
    cfg_t = tconfigs.get_config(ARCH, smoke=True)
    params_j = jax.jit(jmodel.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cfg_j)
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        "cpu")
    return cfg_j, cfg_t, params_j, params_t


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _capped(a):
    """Gate pre-activations as the model makes them (soft-capped)."""
    return (jx.GATE_CAP * np.tanh(a / jx.GATE_CAP)).astype(np.float32)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _close_rel(got, want, limit=STATE_REL_L2):
    g, w = got.detach().numpy(), np.asarray(want)
    assert g.shape == w.shape
    assert np.linalg.norm(g - w) / np.linalg.norm(w) <= limit


def _mlstm_inputs(seed, b, s, nh, hd, state=True):
    rng = np.random.default_rng(seed)
    q, k, v = (_np(rng, b, s, nh, hd) for _ in range(3))
    ig = _capped(_np(rng, b, s, nh, scale=3.0))
    fg = _capped(_np(rng, b, s, nh, scale=2.0) + 2.0)
    c0 = _np(rng, b, nh, hd, hd) if state else np.zeros((b, nh, hd, hd),
                                                        np.float32)
    n0 = _np(rng, b, nh, hd) if state else np.zeros((b, nh, hd), np.float32)
    return q, k, v, ig, fg, c0, n0


@pytest.mark.parametrize("s,chunk,state", [(48, 16, False), (48, 16, True),
                                           (8, 16, True), (64, 64, False),
                                           (512, 256, True)])
def test_mlstm_chunked_matches_jax(s, chunk, state):
    """y, c_final and n_final of the chunked path, fp32: three chunks, one
    chunk shorter than ``chunk`` (qq = S), one full chunk, and two of
    xlstm-350m's 256."""
    jin, tin = _both(*_mlstm_inputs(s, 2, s, 4, 32, state))
    want = jx._mlstm_chunked(*jin, chunk)
    got = tx._mlstm_chunked(*tin, chunk)
    assert all(g.dtype == torch.float32 for g in got)
    if chunk < 256:
        _close(got[0], want[0], F32)
    else:  # 256 terms a row weighted by up to e^15; |y| reaches ~340 here
        _close_rel(got[0], want[0])
    _close_rel(got[1], want[1])
    _close_rel(got[2], want[2])


def test_mlstm_chunked_matches_oracle():
    """tests/test_kernels.py::test_model_chunked_paths_match_oracles on
    the port: the chunked path against the stabilised quadratic oracle."""
    rng = np.random.default_rng(7)
    b, s, nh, hd = 2, 96, 2, 16
    q, k, v = (torch.from_numpy(_np(rng, b, s, nh, hd)) for _ in range(3))
    ig = torch.from_numpy(_np(rng, b, s, nh)) * 2
    fg = torch.from_numpy(_np(rng, b, s, nh)) * 2 + 2
    c0, n0 = torch.zeros((b, nh, hd, hd)), torch.zeros((b, nh, hd))
    y, _, _ = tx._mlstm_chunked(q, k, v, ig, fg, c0, n0, 32)
    want = ref.mlstm_chunkwise(q, k, v, ig, fg)
    torch.testing.assert_close(y, want, **ORACLE)
    torch.testing.assert_close(ops.mlstm(q, k, v, ig, fg), want,
                               rtol=0, atol=0)


def test_mlstm_chunked_gradient_is_finite_where_exp_overflows():
    """Forget gates at -4 over a 256-token chunk: exp(gap) above the
    diagonal overflows.  JAX's gradient through its ``where(tri,
    exp(gap), 0)`` is NaN there (0 * inf); the port masks before the
    exponential, so its forward is JAX's and its gradient finite and
    the quadratic oracle's."""
    rng = np.random.default_rng(11)
    b, s, nh, hd = 1, 256, 2, 16
    q, k, v = (_np(rng, b, s, nh, hd) for _ in range(3))
    ig = _capped(_np(rng, b, s, nh))
    fg = np.full((b, s, nh), -4.0, np.float32)
    c0, n0 = np.zeros((b, nh, hd, hd), np.float32), np.zeros((b, nh, hd),
                                                               np.float32)
    gy = _np(rng, b, s, nh, hd)

    def jloss(fg_):
        y, _, _ = jx._mlstm_chunked(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(ig), fg_,
                                    jnp.asarray(c0), jnp.asarray(n0), s)
        return jnp.sum(y * gy), y

    (_, want_y), want_g = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(fg))
    assert np.isnan(np.asarray(want_g)).any()
    qt, kt, vt, igt = (torch.from_numpy(a) for a in (q, k, v, ig))
    grads = []
    for fn in (lambda f: tx._mlstm_chunked(qt, kt, vt, igt, f,
                                           torch.from_numpy(c0),
                                           torch.from_numpy(n0), s)[0],
               lambda f: ref.mlstm_chunkwise(qt, kt, vt, igt, f)):
        fgt = torch.from_numpy(fg).requires_grad_(True)
        y = fn(fgt)
        grads.append(torch.autograd.grad(y, fgt, torch.from_numpy(gy))[0])
        if not grads[1:]:
            _close_rel(y, want_y)
    assert torch.isfinite(grads[0]).all()
    torch.testing.assert_close(grads[0], grads[1], **ORACLE)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_chunkwise_matches_jax(dtype):
    rng = np.random.default_rng(8)
    b, s, nh, hd = 2, 40, 3, 16
    arrays = [_np(rng, b, s, nh, hd) for _ in range(3)] + [
        _np(rng, b, s, nh, scale=2.0), _np(rng, b, s, nh, scale=2.0) + 1.0]
    jin, tin = _both(*arrays)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jin = [a.astype(jdt) for a in jin[:3]] + jin[3:]
    tin = [t.to(tdt) for t in tin[:3]] + tin[3:]
    want = jref.mlstm_chunkwise(*jin)
    got = ref.mlstm_chunkwise(*tin)
    assert got.dtype == tdt
    tol = F32 if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


def _layer(cfg_j, kind, seed):
    init = {"mlstm": jx.init_mlstm, "slstm": jx.init_slstm}[kind]
    p_j = init(jax.random.PRNGKey(seed), cfg_j)
    if kind == "slstm":  # a nonzero norm scale
        p_j = dict(p_j, norm={"scale": p_j["norm"]["scale"] + 0.2})
    return p_j, bridge.params_from_numpy(jax.tree.map(np.asarray, p_j),
                                         "cpu")


def _cache(kind, p_j, cfg_j, seed):
    """The layer's cache after JAX ran it over an 11-token prefix from
    its initial state (a state the model makes: n > 0, m finite), and
    the same cache bridged to torch."""
    init, apply = {"mlstm": (jx.init_mlstm_cache, jx.apply_mlstm),
                   "slstm": (jx.init_slstm_cache, jx.apply_slstm)}[kind]
    x = _np(np.random.default_rng(seed), 2, 11, cfg_j.d_model)
    _, cache_j = apply(p_j, cfg_j, None, jnp.asarray(x),
                       init(cfg_j, None, 2, 0, jnp.float32))
    return cache_j, bridge.params_from_numpy(
        jax.tree.map(np.asarray, cache_j), "cpu")


@pytest.mark.parametrize("s", [1, 16, 37])
def test_apply_mlstm_with_cache_matches_jax(setup, s):
    """A decode step (S = 1), a prefill of one chunk and one of 37 tokens
    (padded with inert gates to 48) from a carried state: outputs and
    the cache's c and n."""
    cfg_j, cfg_t, _, _ = setup
    p_j, p_t = _layer(cfg_j, "mlstm", 1)
    cache_j, cache_t = _cache("mlstm", p_j, cfg_j, s)
    x = _np(np.random.default_rng(s + 100), 2, s, cfg_t.d_model)
    want, new_j = jx.apply_mlstm(p_j, cfg_j, None, jnp.asarray(x), cache_j)
    got, new_t = tx.apply_mlstm(p_t, cfg_t, None, torch.from_numpy(x),
                                cache_t)
    assert new_t is cache_t
    _close(got, want, F32)
    for key in ("c", "n"):
        _close_rel(new_t[key], new_j[key])


def test_apply_mlstm_training_matches_jax(setup):
    """No cache (training): 37 tokens through the padded chunked path."""
    cfg_j, cfg_t, _, _ = setup
    p_j, p_t = _layer(cfg_j, "mlstm", 2)
    x = _np(np.random.default_rng(9), 2, 37, cfg_t.d_model)
    want, _ = jx.apply_mlstm(p_j, cfg_j, None, jnp.asarray(x))
    got, none = tx.apply_mlstm(p_t, cfg_t, None, torch.from_numpy(x))
    assert none is None
    _close(got, want, F32)


def test_slstm_scan_matches_jax():
    rng = np.random.default_rng(10)
    b, s, nh, hd = 2, 19, 4, 16
    pre = _np(rng, b, s, 4, nh, hd)
    r = _np(rng, 4, nh, hd, hd, scale=hd ** -0.5)
    state = [_np(rng, b, nh, hd, scale=0.5) for _ in range(3)] + [
        _np(rng, b, nh, hd)]
    jin, tin = _both(pre, r, *state)
    ys_j, st_j = jx._slstm_scan(jin[0], jin[1], tuple(jin[2:]))
    ys_t, st_t = tx._slstm_scan(tin[0], tin[1], tuple(tin[2:]))
    assert ys_t.shape == (b, s, nh, hd)
    _close(ys_t, ys_j, F32)
    for g, w in zip(st_t, st_j):
        assert g.shape == (b, nh, hd)
        _close(g, w, F32)


@pytest.mark.parametrize("s", [1, 13])
def test_apply_slstm_with_cache_matches_jax(setup, s):
    cfg_j, cfg_t, _, _ = setup
    p_j, p_t = _layer(cfg_j, "slstm", 3)
    cache_j, cache_t = _cache("slstm", p_j, cfg_j, s)
    x = _np(np.random.default_rng(s + 200), 2, s, cfg_t.d_model)
    want, new_j = jx.apply_slstm(p_j, cfg_j, None, jnp.asarray(x), cache_j)
    got, new_t = tx.apply_slstm(p_t, cfg_t, None, torch.from_numpy(x),
                                cache_t)
    assert new_t is cache_t
    _close(got, want, F32)
    for key in "hcnm":
        _close(new_t[key], new_j[key], F32)
    # training: no cache, the initial state of zeros and m = -1e30
    want, _ = jx.apply_slstm(p_j, cfg_j, None, jnp.asarray(x))
    got, _ = tx.apply_slstm(p_t, cfg_t, None, torch.from_numpy(x))
    _close(got, want, F32)


def test_init_trees_match_jax(setup):
    """init_params and init_cache give JAX's trees (the stacked mLSTM and
    sLSTM slots, fp32 states, m at -1e30); a bridged tree comes back bit
    for bit; param_count is JAX's."""
    cfg_j, cfg_t, params_j, params_t = setup
    mine_p = bridge.params_to_numpy(
        tmodel.init_params(torch.Generator().manual_seed(0), cfg_t, "cpu"))
    mine_c = tmodel.init_cache(cfg_t, 2, 24, device="cpu")
    theirs_c = jmodel.init_cache(cfg_j, 2, 24)
    for mine, theirs in ((mine_p, params_j),
                         (bridge.params_to_numpy(mine_c), theirs_c)):
        theirs = jax.tree.map(np.asarray, theirs)
        assert jax.tree.structure(mine) == jax.tree.structure(theirs)
        for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
            assert a.shape == b.shape and a.dtype == b.dtype
    slstm = cfg_t.groups[0].pattern.index(
        next(s for s in cfg_t.groups[0].pattern if s.kind == "slstm"))
    m = mine_c[0]["slots"][slstm]["m"]
    assert bool((m == -1e30).all())
    # each state leaf its own storage: the in-place writes stay apart
    ptrs = [t.data_ptr() for t in mine_c[0]["slots"][slstm].values()]
    assert len(set(ptrs)) == 4
    back = bridge.params_to_numpy(params_t)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params_j)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert cfg_t.param_count() == cfg_j.param_count()


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def test_forward_and_loss_match_jax(setup):
    cfg_j, cfg_t, params_j, params_t = setup
    toks = _tokens(0, 2, 37, cfg_t.vocab_size)
    want, _ = jmodel.forward(params_j, cfg_j, jnp.asarray(toks))
    got, _ = tmodel.forward(params_t, cfg_t, torch.from_numpy(toks))
    assert got.shape == (2, 37, cfg_t.vocab_size)
    _close(got, want, LOGIT_TOL)
    want_l, _ = jmodel.forward_loss(params_j, cfg_j, jnp.asarray(toks[:, :-1]),
                                    jnp.asarray(toks[:, 1:]))
    got_l, _ = tmodel.forward_loss(params_t, cfg_t,
                                   torch.from_numpy(toks[:, :-1]),
                                   torch.from_numpy(toks[:, 1:]))
    np.testing.assert_allclose(float(got_l), float(want_l), **LOGIT_TOL)


def _bridged(params_j):
    return tree_map(lambda a: a.requires_grad_(True),
                    bridge.params_from_numpy(
                        jax.tree.map(np.asarray, params_j), "cpu"))


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_grads_match_jax(setup, remat):
    """forward_loss's gradients, every leaf within GRAD_REL_L2 of JAX's;
    under remat "dots" (xlstm-350m's own) the port's are the bits of
    "none"."""
    import dataclasses
    cfg_j, cfg_t, params_j, _ = setup
    toks = _tokens(1, 2, 33, cfg_t.vocab_size)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (want_loss, _), want_g = jax.value_and_grad(
        jstep.make_loss_fn(cfg_j), has_aux=True)(
            params_j, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (loss, _), grads = tstep.make_grad_fn(
        dataclasses.replace(cfg_t, remat=remat))(_bridged(params_j), tb)
    np.testing.assert_allclose(float(loss), float(want_loss), **LOGIT_TOL)
    got = jax.tree.leaves(bridge.params_to_numpy(grads))
    want = jax.tree.leaves(jax.tree.map(np.asarray, want_g))
    assert len(got) == len(want)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        assert np.linalg.norm(a - w) / np.linalg.norm(w) < GRAD_REL_L2


def test_prefill_decode_match_jax_and_forward(setup):
    """prefill(t[:-1]) + one decode step against JAX (logits and every
    cache leaf), and the port's own decode logits against its forward's
    last position (tests/test_models.py:64-86)."""
    cfg_j, cfg_t, params_j, params_t = setup
    b, s = 2, 32
    toks = _tokens(2, b, s, cfg_t.vocab_size)
    cache_j = jmodel.init_cache(cfg_j, b, s + 4)
    cache_t = tmodel.init_cache(cfg_t, b, s + 4, device="cpu")
    pre_j, cache_j = jmodel.prefill(params_j, cfg_j,
                                    jnp.asarray(toks[:, :-1]), cache_j)
    pre_t, cache_t = tmodel.prefill(params_t, cfg_t,
                                    torch.from_numpy(toks[:, :-1]), cache_t)
    _close(pre_t, pre_j, LOGIT_TOL)
    pos = np.full((b,), s - 1, np.int32)
    dec_j, cache_j = jmodel.decode_step(params_j, cfg_j,
                                        jnp.asarray(toks[:, -1:]), cache_j,
                                        jnp.asarray(pos))
    dec_t, cache_t = tmodel.decode_step(params_t, cfg_t,
                                        torch.from_numpy(toks[:, -1:]),
                                        cache_t, torch.from_numpy(pos))
    _close(dec_t, dec_j, LOGIT_TOL)
    mine = bridge.params_to_numpy(cache_t)
    theirs = jax.tree.map(np.asarray, cache_j)
    assert jax.tree.structure(mine) == jax.tree.structure(theirs)
    for a, w in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
        np.testing.assert_allclose(a, w, **LOGIT_TOL)
    full, _ = tmodel.forward(params_t, cfg_t, torch.from_numpy(toks))
    np.testing.assert_allclose(dec_t[:, 0].numpy(), full[:, -1].numpy(),
                               **LOGIT_TOL)


def test_adamw_train_step_matches_jax(setup):
    """One train step (AdamW): the loss and the gradient norm against JAX's
    train step, and the new params against JAX's AdamW applied to the
    port's own gradients (PARAM_TOL a leaf).

    Not each leaf's update against JAX's train step, as
    tests/test_torch_train.py holds llama and zamba2 (STEP_UPDATE_REL_L2):
    this model's fp32 gradients are ill-conditioned (its exponential
    gates), so the two packages' lie up to GRAD_REL_L2 apart a leaf
    (``test_grads_match_jax``), and the first AdamW update, ~ lr
    sign(g), flips on every element whose gradient is within that of
    zero, past STEP_UPDATE_REL_L2 on some leaves."""
    cfg_j, cfg_t, params_j, _ = setup
    toks = _tokens(3, 4, 17, cfg_t.vocab_size)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    opt_j = jopt.make_optimizer("adamw", **OPT_KW)
    opt_t = topt.make_optimizer("adamw", **OPT_KW)
    _, _, mj = jax.jit(jstep.make_train_step(cfg_j, opt_j))(
        params_j, opt_j.init(params_j),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, grads = tstep.make_grad_fn(cfg_t)(_bridged(params_j), tb)
    pt = _bridged(params_j)
    pt, st, mt = tstep.make_train_step(cfg_t, opt_t)(pt, opt_t.init(pt), tb)
    assert int(st["step"]) == 1
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               **LOGIT_TOL)
    np.testing.assert_allclose(float(mt["grad_norm"]),
                               float(mj["grad_norm"]), rtol=1e-4)
    gj = jax.tree.map(jnp.asarray, bridge.params_to_numpy(grads))
    pj, _, _ = jax.jit(opt_j.apply)(params_j, gj, opt_j.init(params_j))
    for a, w, p0 in zip(jax.tree.leaves(bridge.params_to_numpy(pt)),
                        jax.tree.leaves(pj), jax.tree.leaves(params_j)):
        assert np.abs(np.asarray(w) - np.asarray(p0)).max() > 0
        np.testing.assert_allclose(a, np.asarray(w), **PARAM_TOL)


def test_engine_matches_jax_reference_generation(setup):
    """The mLSTM and sLSTM states through the engine: prompts prefilled at
    their exact lengths (the padded chunk path), 3 requests over 2 slots
    (a slot reused), tokens equal JAX's greedy generation."""
    from repro_torch.serve.engine import ServingEngine
    cfg_j, cfg_t, params_j, params_t = setup
    prefill = jax.jit(jmodel.prefill, static_argnums=1)
    decode_step = jax.jit(jmodel.decode_step, static_argnums=1)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg_t.vocab_size, size=n) for n in (9, 30, 17)]
    eng = ServingEngine(cfg_t, params_t, max_batch=2, max_len=64,
                        device="cpu")
    eng.start()
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    try:
        for r in reqs:
            assert r.done.wait(120)
    finally:
        eng.stop()
    for p, r in zip(prompts, reqs):
        cache = jmodel.init_cache(cfg_j, 1, 64)
        _, cache = prefill(params_j, cfg_j, jnp.asarray(p[None, :-1],
                                                        jnp.int32), cache)
        cur, pos, out = int(p[-1]), len(p) - 1, []
        for _ in range(6):
            logits, cache = decode_step(
                params_j, cfg_j, jnp.asarray([[cur]], jnp.int32), cache,
                jnp.asarray([pos], jnp.int32))
            cur = int(jnp.argmax(logits[0, 0]))
            out.append(cur)
            pos += 1
        assert r.out_tokens == out
    assert eng.n_prefills == 3 and eng.n_generated == 18


# the bf16 witness: xlstm-350m at its published widths, one of its three
# (7 mLSTM + 1 sLSTM) repeats, one sequence of WITNESS_SEQ tokens
WITNESS_REPEATS, WITNESS_SEQ = 1, 64
# the port's reading over JAX's, for each of the witness's measures
WITNESS_RATIO = (2 / 3, 3 / 2)


def _rms_rsqrt_in(dtype_of, rsqrt, cast):
    """The model's rmsnorm with one more rounding: the row's rsqrt factor
    rounded to x's dtype before it scales the row (``cast(a, dtype)``).
    In bf16 it moves a norm's outputs by about an ulp."""
    def rmsnorm(params, x, *, eps=1e-6, zero_centered=True):
        xf = cast(x, "float32")
        r = rsqrt((xf * xf).mean(-1, keepdims=True) + eps)
        xh = xf * cast(cast(r, dtype_of(x)), "float32")
        sc = cast(params["scale"], "float32")
        sc = 1.0 + sc if zero_centered else sc
        return cast(xh * sc, dtype_of(x))
    return rmsnorm


def _jax_reading(cfg, params, batch, monkeypatch, perturbed=False):
    """(logits, loss, gradient leaves) of the JAX model, as fp32 numpy."""
    from repro.models import blocks as jblocks
    with monkeypatch.context() as mp:
        if perturbed:
            norm = _rms_rsqrt_in(lambda x: x.dtype, jax.lax.rsqrt,
                                 lambda a, d: a.astype(d))
            for mod in (jx, jblocks, jmodel):
                mp.setattr(mod, "rmsnorm", norm)
        # a new function each call: jit's cache would give the unpatched
        # trace for the same (function, config)
        logits, _ = jax.jit(lambda p, t: jmodel.forward(p, cfg, t))(
            params, batch["tokens"])
        (loss, _), grads = jax.jit(jax.value_and_grad(
            jstep.make_loss_fn(cfg), has_aux=True))(params, batch)
    return (np.asarray(logits.astype(jnp.float32)), float(loss),
            [np.asarray(g.astype(jnp.float32)) for g in jax.tree.leaves(grads)])


def _port_reading(cfg, params, batch, monkeypatch, perturbed=False):
    """(logits, loss, gradient leaves) of the port's model, as fp32
    numpy, in the JAX tree's leaf order."""
    from repro_torch.models import blocks as tblocks
    from repro_torch.models.config import dtype_named
    with monkeypatch.context() as mp:
        if perturbed:
            norm = _rms_rsqrt_in(lambda x: x.dtype, torch.rsqrt,
                                 lambda a, d: a.to(dtype_named(d)
                                                   if isinstance(d, str)
                                                   else d))
            for mod in (tx, tblocks, tmodel):
                mp.setattr(mod, "rmsnorm", norm)
        with torch.no_grad():
            logits = tmodel.forward(params, cfg, batch["tokens"])[0]
        (loss, _), grads = tstep.make_grad_fn(cfg)(
            tree_map(lambda p: p.detach().requires_grad_(True), params),
            batch)
    return (logits.float().numpy(), float(loss),
            jax.tree.leaves(bridge.params_to_numpy(
                tree_map(lambda g: g.float(), grads))))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _median_leaf_rel(got, want):
    return float(np.median([_rel(a, w) for a, w in zip(got, want)
                            if np.linalg.norm(w) > 0]))


def _sensitivity(read, cfg32, cfg16, p32, p16, batch, monkeypatch):
    """bf16 against fp32, and one rounding more in every norm against bf16
    (``_rms_rsqrt_in``): logits rel. L2 and the median leaf's gradient
    rel. L2 of each."""
    full = read(cfg32, p32, batch, monkeypatch)
    half = read(cfg16, p16, batch, monkeypatch)
    out = {"logits_bf16_vs_fp32": _rel(half[0], full[0]),
           "grads_bf16_vs_fp32": _median_leaf_rel(half[2], full[2])}
    del full
    once = read(cfg16, p16, batch, monkeypatch, perturbed=True)
    out["logits_one_rounding"] = _rel(once[0], half[0])
    out["grads_one_rounding"] = _median_leaf_rel(once[2], half[2])
    return out


def _full_width(repeats, dtype):
    """(JAX config, port config) of xlstm-350m at its published widths and
    ``repeats`` of its three (7 mLSTM + 1 sLSTM) repeats, remat "none"."""
    import dataclasses
    out = []
    for cfg in (jconfigs.get_config(ARCH), tconfigs.get_config(ARCH)):
        g = cfg.groups[0]
        out.append(dataclasses.replace(
            cfg, groups=(dataclasses.replace(g, repeat=repeats),),
            dtype=dtype, remat="none"))
    return tuple(out)


def test_reference_gradient_overflows_at_full_width():
    """At xlstm-350m's published widths and chunk (256), on one sequence
    of 256 tokens in fp32 from the JAX package's init: JAX's gradient is
    not finite (its ``where(tri, exp(gap), 0)`` meets an overflow above
    the diagonal), so the JAX package cannot train this model at its own
    chunk and no run of it stands beside the port's training on the card;
    the port's loss is JAX's and its gradient finite."""
    cj, ct = _full_width(1, "float32")
    assert cj.xlstm.chunk == 256
    pj = jax.jit(jmodel.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cj)
    toks = _tokens(6, 1, cj.xlstm.chunk + 1, cj.vocab_size)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (want, _), grads = jax.jit(jax.value_and_grad(
        jstep.make_loss_fn(cj), has_aux=True))(
            pj, {k: jnp.asarray(v) for k, v in batch.items()})
    assert not all(np.isfinite(np.asarray(g)).all()
                   for g in jax.tree.leaves(grads))
    del grads
    pt = _bridged(pj)
    del pj
    (loss, _), grads = tstep.make_grad_fn(ct)(
        pt, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(want), **LOGIT_TOL)
    assert all(torch.isfinite(g).all() for g in tree_leaves(grads))


def test_bf16_sensitivity_matches_jax_at_full_width(monkeypatch):
    """xlstm-350m's bf16 logits and gradients are as far from its fp32 ones,
    and move as far under one more rounding in its norms, in the JAX
    package as in the port: the port's reading within WITNESS_RATIO of
    JAX's on each measure, at the published widths (d 1024, mLSTM heads
    512 wide, vocab 50304) and one of the three repeats.  This is why the
    card's kernel-vs-plain checks of this model run in fp32
    (chip_smoke.py's LOGITS_DTYPE and PARITY_DTYPE).  Prints the readings
    (``pytest -s``)."""
    cj32, ct32 = _full_width(WITNESS_REPEATS, "float32")
    cj16, ct16 = _full_width(WITNESS_REPEATS, "bfloat16")
    pj32 = jax.jit(jmodel.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cj32)
    toks = _tokens(5, 1, WITNESS_SEQ + 1, cj32.vocab_size)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jax_read = _sensitivity(
        _jax_reading, cj32, cj16, pj32,
        jax.tree.map(lambda a: a.astype(jnp.bfloat16), pj32),
        {k: jnp.asarray(v) for k, v in batch.items()}, monkeypatch)
    pt32 = bridge.params_from_numpy(jax.tree.map(np.asarray, pj32), "cpu")
    del pj32
    port_read = _sensitivity(
        _port_reading, ct32, ct16, pt32,
        tree_map(lambda a: a.to(torch.bfloat16), pt32),
        {k: torch.from_numpy(v) for k, v in batch.items()}, monkeypatch)
    print(f"\nxlstm-350m widths, {8 * WITNESS_REPEATS} layers, "
          f"S {WITNESS_SEQ} (rel. L2; gradients: the median leaf)")
    for key, want in jax_read.items():
        print(f"  {key}: JAX {want:.4f}, port {port_read[key]:.4f}")
        assert want > 0
        lo, hi = WITNESS_RATIO
        assert lo <= port_read[key] / want <= hi, (key, want, port_read)
