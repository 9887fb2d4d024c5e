"""The port's training slice against the JAX package on the CPU: the plain
RMSNorm and flash-attention backward versions against ``jax.vjp`` of the JAX
oracles, the autograd wiring of ``ops`` (gradcheck), ``forward_loss`` and
its gradients (llama3.2-1b and zamba2-2.7b), remat "full" and "dots",
AdamW, Adafactor and Lion, the train step (single and accumulated) and
the ``Trainer`` (smoke configs, JAX-initialised params moved over by
``repro_torch.bridge``).  The CUDA kernels themselves are held against the
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import dataclasses
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jstep  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data.pipeline import SyntheticDataset  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tstep  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),   # tests/test_kernels.py
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Gradients against jax.vjp: fp32 sums run in another order (1e-4); in
# bf16 JAX's vjp rounds every intermediate gradient to bf16 while the
# port's plain backward keeps them in fp32 and rounds once at the end, so
# the two differ by a few bf16 steps of the largest gradient (5e-2).
GRAD_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
            "bfloat16": dict(rtol=5e-2, atol=5e-2)}
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)           # tests/test_models.py
# every gradient leaf of forward_loss within this relative L2 of JAX's
GRAD_REL_L2 = 1e-4
PARAM_TOL = dict(rtol=1e-5, atol=1e-5)          # AdamW on equal gradients
# After a train step, each leaf's update (new - old params) within this
# relative L2 of JAX's.  Not elementwise: the first AdamW update is
# lr * g / (|g| + eps), so an element whose gradient is near zero moves by
# up to 2 lr on a gradient difference of a few ulps.
STEP_UPDATE_REL_L2 = 1e-3

RMS_SHAPES = [(4, 37, 256), (2, 128), (1, 8, 8, 512)]  # test_kernels.py
FLASH_CASES = [  # tests/test_kernels.py
    (2, 256, 4, 2, 64, True, None, None),
    (1, 256, 8, 8, 128, True, None, 50.0),
    (2, 512, 4, 1, 64, True, 128, None),
    (1, 128, 4, 4, 32, False, None, None),
    (1, 384, 6, 2, 64, True, 256, 30.0),
    # the training shapes' head dim 256 (gemma-7b), G 6 with grok's cap 30
    # and G 7 (deepseek-coder-33b)
    (1, 128, 2, 2, 256, True, None, None),
    (1, 192, 6, 1, 128, True, None, 30.0),
    (2, 128, 7, 1, 128, True, None, None),
]


def _pair(a: np.ndarray, dtype: str):
    """The same numpy array as a JAX array and a CPU tensor of ``dtype``."""
    return (jnp.asarray(a, JDT[dtype]),
            torch.from_numpy(a.astype(np.float32)).to(TDT[dtype]))


def _inputs(seed, dtype, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [_pair(rng.standard_normal(s).astype(np.float32) * scale, dtype)
            for s in shapes]


def _jvjp(f, primals, cotangent):
    """jax.vjp of ``f`` at ``primals``, jitted (as the JAX Trainer jits its
    step; op-by-op it takes ten times as long)."""
    return jax.jit(lambda p, c: jax.vjp(f, *p)[1](c))(primals, cotangent)


def _close(got_t, want_j, tol):
    np.testing.assert_allclose(got_t.detach().float().numpy(),
                               np.asarray(want_j, np.float32), **tol)


# ---------------------------------------------------------------------------
# RMSNorm and flash attention: plain versions against the JAX oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RMS_SHAPES)
@pytest.mark.parametrize("zero_centered", [True, False])
def test_rmsnorm_matches_jax_ref_and_pallas(dtype, shape, zero_centered):
    (xj, xt), = _inputs(len(shape), dtype, shape)
    (sj, st), = _inputs(shape[-1], dtype, (shape[-1],), scale=0.1)
    got = ref.rmsnorm(xt, st, zero_centered=zero_centered)
    assert got.dtype == TDT[dtype]
    _close(got, jref.rmsnorm(xj, sj, zero_centered=zero_centered), TOL[dtype])
    _close(got, pallas_rmsnorm(xj, sj, zero_centered=zero_centered,
                               interpret=True), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RMS_SHAPES)
@pytest.mark.parametrize("zero_centered", [True, False])
def test_rmsnorm_bwd_matches_jax_vjp(dtype, shape, zero_centered):
    (xj, xt), (gj, gt) = _inputs(len(shape) + 10, dtype, shape, shape)
    (sj, st), = _inputs(shape[-1], dtype, (shape[-1],), scale=0.1)
    want_dx, want_ds = _jvjp(lambda x, s: jref.rmsnorm(
        x, s, zero_centered=zero_centered), (xj, sj), gj)
    dx, ds = ref.rmsnorm_bwd(xt, st, gt, zero_centered=zero_centered)
    assert dx.dtype == ds.dtype == TDT[dtype]
    _close(dx, want_dx, GRAD_TOL[dtype])
    _close(ds, want_ds, GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,hd,causal,window,cap", FLASH_CASES)
def test_flash_attention_bwd_matches_jax_vjp(dtype, b, s, h, kv, hd, causal,
                                             window, cap):
    (qj, qt), (kj, kt), (vj, vt), (gj, gt) = _inputs(
        s + hd, dtype, (b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd),
        (b, s, h, hd))
    kw = dict(causal=causal, window=window, softcap=cap,
              scale=1.0 / np.sqrt(hd))

    def jax_side(q, k, v, g):
        """The JAX oracle's output, the LSE of its masked fp32 scores, and
        its vjp."""
        o, vjp = jax.vjp(lambda *a: jref.flash_attention(*a, **kw), q, k, v)
        sc = jnp.einsum("bshd,bthd->bhst", q, jref._expand_kv(k, h)).astype(
            jnp.float32) * kw["scale"]
        if cap:
            sc = cap * jnp.tanh(sc / cap)
        m = jref._mask(s, s, causal=causal, window=window)
        return (o, jax.nn.logsumexp(jnp.where(m, sc, jref.NEG_INF), axis=-1),
                vjp(g))

    want_o, want_lse, want_g = jax.jit(jax_side)(qj, kj, vj, gj)
    o, lse = ref.flash_attention_fwd(qt, kt, vt, **kw)
    _close(o, want_o, TOL[dtype])
    _close(lse, want_lse, TOL[dtype])
    got = ref.flash_attention_bwd(qt, kt, vt, o, lse, gt, **kw)
    for a, w in zip(got, want_g):
        assert a.dtype == TDT[dtype]
        _close(a, w, GRAD_TOL[dtype])


def test_flash_attention_bwd_of_a_fully_masked_row_is_finite():
    """A window with q_offset past the keys leaves rows with no live key:
    their gradient is finite (the plain forward attends uniformly there)."""
    (_, q), (_, k), (_, v), (_, g) = _inputs(
        5, "float32", (1, 4, 2, 8), (1, 6, 2, 8), (1, 6, 2, 8), (1, 4, 2, 8))
    kw = dict(causal=True, window=2, scale=0.3, q_offset=8)
    o, lse = ref.flash_attention_fwd(q, k, v, **kw)
    grads = ref.flash_attention_bwd(q, k, v, o, lse, g, **kw)
    assert all(bool(torch.isfinite(x).all()) for x in grads)
    assert float(grads[0].abs().max()) == 0.0  # no live score, no dq


# ---------------------------------------------------------------------------
# ops: the autograd functions (CPU dispatch), float64 gradcheck
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zero_centered", [True, False])
def test_ops_rmsnorm_gradcheck(zero_centered):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 16, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    s = (0.1 * torch.randn(16, dtype=torch.float64, generator=gen)
         ).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x, s: ops.rmsnorm(x, s, zero_centered=zero_centered), (x, s))


@pytest.mark.parametrize("s,t,h,kv,causal,window,cap", [
    (6, 6, 4, 2, True, None, None),
    (6, 6, 4, 1, True, 3, 2.0),     # GQA 4, window, softcap
    (5, 7, 2, 2, False, None, 1.5),
])
def test_ops_flash_attention_gradcheck(s, t, h, kv, causal, window, cap):
    gen = torch.Generator().manual_seed(s + t)
    q, k, v = (torch.randn(shape, dtype=torch.float64, generator=gen,
                           requires_grad=True)
               for shape in ((1, s, h, 4), (1, t, kv, 4), (1, t, kv, 4)))
    kw = dict(causal=causal, window=window, softcap=cap, scale=0.5)
    assert torch.autograd.gradcheck(
        lambda q, k, v: ops.flash_attention(q, k, v, **kw), (q, k, v))


def test_ops_run_the_autograd_function_only_when_recording():
    x = torch.randn(2, 8)
    s = torch.zeros(8, requires_grad=True)
    assert ops.rmsnorm(x, s).grad_fn is not None
    with torch.no_grad():
        assert ops.rmsnorm(x, s).grad_fn is None
    assert ops.rmsnorm(x, s.detach()).grad_fn is None


# ---------------------------------------------------------------------------
# model: forward_loss and its gradients against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["llama3.2-1b", "zamba2-2.7b",
                                        "gemma-7b", "gemma2-27b",
                                        "deepseek-coder-33b"])
def setup(request):
    cfg_j = jconfigs.get_config(request.param, smoke=True)
    cfg_t = tconfigs.get_config(request.param, smoke=True)
    params_j = jax.jit(jmodel.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cfg_j)  # jitted: 3x faster than op by op
    return cfg_j, cfg_t, params_j


def _bridged(params_j):
    return tree_map(lambda a: a.requires_grad_(True),
                    bridge.params_from_numpy(
                        jax.tree.map(np.asarray, params_j), "cpu"))


def _batch(seed, b, s, vocab):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(
        np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grads_close(got_tree, want_tree):
    got = jax.tree.leaves(bridge.params_to_numpy(got_tree))
    want = jax.tree.leaves(jax.tree.map(np.asarray, want_tree))
    assert len(got) == len(want)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        rel = np.linalg.norm(a - w) / max(np.linalg.norm(w), 1e-30)
        assert rel < GRAD_REL_L2


def test_forward_loss_and_grads_match_jax(setup):
    cfg_j, cfg_t, params_j = setup
    batch = _batch(0, 2, 32, cfg_t.vocab_size)
    (want_loss, want_m), want_g = jax.jit(jax.value_and_grad(
        jstep.make_loss_fn(cfg_j), has_aux=True))(params_j, _jbatch(batch))
    (loss, metrics), grads = tstep.make_grad_fn(cfg_t)(_bridged(params_j),
                                                       _tbatch(batch))
    np.testing.assert_allclose(float(loss), float(want_loss), **LOSS_TOL)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(want_m["loss"]), **LOSS_TOL)
    assert float(metrics["moe_aux_loss"]) == 0.0
    _grads_close(grads, want_g)


def test_forward_loss_equals_cross_entropy_of_logits(setup):
    _, cfg_t, params_j = setup
    params = _bridged(params_j)
    batch = _tbatch(_batch(1, 2, 16, cfg_t.vocab_size))
    loss, _ = tmodel.forward_loss(params, cfg_t, batch["tokens"],
                                  batch["labels"])
    logits, _ = tmodel.forward(params, cfg_t, batch["tokens"])
    torch.testing.assert_close(
        loss, tstep.cross_entropy(logits, batch["labels"]), **LOSS_TOL)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_full_gives_the_gradients_of_none(setup, remat):
    """Checkpointing changes what the backward recomputes, never the
    gradients: "full" (recompute every repeat) and "dots" (keep the matmul
    outputs) give the bits of "none" on the CPU."""
    cfg_j, cfg_t, params_j = setup
    batch = _tbatch(_batch(2, 2, 16, cfg_t.vocab_size))
    grads = [tree_leaves(tstep.make_grad_fn(
        dataclasses.replace(cfg_t, remat=r))(_bridged(params_j), batch)[1])
             for r in ("none", remat)]
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_unknown_remat_raises(setup):
    _, cfg_t, params_j = setup
    with pytest.raises(ValueError, match="remat='some'"):
        tstep.make_grad_fn(dataclasses.replace(cfg_t, remat="some"))(
            _bridged(params_j), _tbatch(_batch(2, 2, 8, cfg_t.vocab_size)))


def test_remat_dots_recomputes_no_matmul(setup):
    """Counted by a dispatch mode over the backward alone: "dots" runs the
    matmuls of "none" (its kept outputs are not recomputed), "full" runs
    every forward matmul of the checkpointed repeats once more."""
    from torch.utils._python_dispatch import TorchDispatchMode
    mms = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
           torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}

    class CountMatmuls(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func in mms
            return func(*args, **(kwargs or {}))

    _, cfg_t, params_j = setup
    batch = _tbatch(_batch(3, 2, 16, cfg_t.vocab_size))
    counts = {}
    for remat in ("none", "dots", "full"):
        cfg = dataclasses.replace(cfg_t, remat=remat)
        params = _bridged(params_j)
        with torch.enable_grad():
            loss, _ = tmodel.forward_loss(params, cfg, batch["tokens"],
                                          batch["labels"])
            with CountMatmuls() as mode:
                torch.autograd.grad(loss, tree_leaves(params))
        counts[remat] = mode.n
    assert counts["dots"] == counts["none"] < counts["full"], counts


# ---------------------------------------------------------------------------
# optimizer and train step against JAX
# ---------------------------------------------------------------------------

OPT_KW = dict(lr=1e-2, warmup=3, decay_steps=10, weight_decay=0.1,
              grad_clip=0.5)


@pytest.mark.parametrize("step", [0, 1, 3, 6, 10, 20])
def test_schedule_matches_jax(step):
    c_j, c_t = jopt.OptConfig(**OPT_KW), topt.OptConfig(**OPT_KW)
    np.testing.assert_allclose(
        float(topt.schedule(c_t, torch.tensor(step, dtype=torch.int32))),
        float(jopt.schedule(c_j, jnp.asarray(step, jnp.int32))), rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.1, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [rng.standard_normal(5).astype(np.float32)]}
    got, gnorm = topt.clip_by_global_norm(
        tree_map(torch.from_numpy, tree), max_norm)
    want, wnorm = jopt.clip_by_global_norm(
        jax.tree.map(jnp.asarray, tree), max_norm)
    np.testing.assert_allclose(float(gnorm), float(wnorm), rtol=1e-6)
    for a, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        _close(a, w, TOL["float32"])


def test_adamw_steps_match_jax(setup):
    """Three AdamW steps on fixed gradients (warmup, clipping, weight
    decay, bias correction) from bridged params."""
    _, _, params_j = setup
    rng = np.random.default_rng(5)
    grads_np = jax.tree.map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params_j)
    opt_j = jopt.make_optimizer("adamw", **OPT_KW)
    opt_t = topt.make_optimizer("adamw", **OPT_KW)
    pj, sj = params_j, opt_j.init(params_j)
    pt = _bridged(params_j)
    st = opt_t.init(pt)
    gt = bridge.params_from_numpy(grads_np, "cpu")
    for _ in range(3):
        pj, sj, mj = jax.jit(opt_j.apply)(pj, jax.tree.map(jnp.asarray,
                                                           grads_np), sj)
        pt, st, mt = opt_t.apply(pt, gt, st)
    assert int(st["step"]) == 3 and st["step"].dtype == torch.int32
    np.testing.assert_allclose(float(mt["lr"]), float(mj["lr"]), rtol=1e-6)
    np.testing.assert_allclose(float(mt["grad_norm"]),
                               float(mj["grad_norm"]), rtol=1e-5)
    for a, w in zip(jax.tree.leaves(bridge.params_to_numpy(
            {"p": pt, "m": st["m"], "v": st["v"]})),
            jax.tree.leaves({"p": pj, "m": sj["m"], "v": sj["v"]})):
        np.testing.assert_allclose(a, np.asarray(w), **PARAM_TOL)


@pytest.mark.parametrize("name", ["adafactor", "lion"])
def test_optimizer_steps_match_jax(setup, name):
    """Three steps on fixed gradients (warmup, clipping, weight decay, and
    Adafactor's factored moments with its update clipping over each whole
    stacked leaf, or Lion's sign update) from bridged params: params and
    state as JAX has them."""
    _, _, params_j = setup
    rng = np.random.default_rng(8)
    grads_np = jax.tree.map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params_j)
    opt_j = jopt.make_optimizer(name, **OPT_KW)
    opt_t = topt.make_optimizer(name, **OPT_KW)
    pj, sj = params_j, opt_j.init(params_j)
    pt = _bridged(params_j)
    st = opt_t.init(pt)
    gt = bridge.params_from_numpy(grads_np, "cpu")
    for _ in range(3):
        pj, sj, mj = jax.jit(opt_j.apply)(pj, jax.tree.map(jnp.asarray,
                                                           grads_np), sj)
        pt, st, mt = opt_t.apply(pt, gt, st)
    assert int(st["step"]) == 3 and st["step"].dtype == torch.int32
    np.testing.assert_allclose(float(mt["grad_norm"]),
                               float(mj["grad_norm"]), rtol=1e-5)
    mine = bridge.params_to_numpy({"p": pt, "s": st})
    theirs = jax.tree.map(np.asarray, {"p": pj, "s": sj})
    assert jax.tree.structure(mine) == jax.tree.structure(theirs)
    for a, w in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
        assert a.shape == w.shape
        np.testing.assert_allclose(a, w, **PARAM_TOL)


def test_adafactor_state_is_factored():
    """tests/test_train_serve_ft.py::test_adafactor_state_is_factored, and
    on the stacked, fused params of the optimized llama config: every leaf
    of rank >= 2 is factored over its last two axes, the repeat axis kept
    (``wgu`` (R, D, 2, F): ``vr`` (R, D, 2), ``vc`` (R, D, F)), with the
    shapes and keys of the JAX state."""
    from repro.configs.optimized import optimized_config as jopt_config
    from repro_torch.configs.optimized import _OVERRIDES
    opt = topt.make_optimizer("adafactor")
    st = opt.init({"w": torch.zeros(64, 32), "b": torch.zeros(7)})
    assert st["stats"]["w"]["vr"].shape == (64,)
    assert st["stats"]["w"]["vc"].shape == (32,)
    assert st["stats"]["b"]["v"].shape == (7,)
    cfg = dataclasses.replace(tconfigs.get_config("llama3.2-1b", smoke=True),
                              **_OVERRIDES["llama3_2_1b"])
    params = tmodel.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    st = opt.init(params)
    wgu = params["groups"][0]["slots"][0]["mlp"]["wgu"]
    r, d, two, f = wgu.shape
    assert two == 2 and r == cfg.groups[0].repeat
    stat = st["stats"]["groups"][0]["slots"][0]["mlp"]["wgu"]
    assert stat["vr"].shape == (r, d, 2) and stat["vc"].shape == (r, d, f)
    cfg_j = dataclasses.replace(
        jconfigs.get_config("llama3.2-1b", smoke=True),
        **{k: getattr(jopt_config("llama3.2-1b"), k)
           for k in ("fuse_qkv", "fuse_glu", "seq_parallel")})
    want = jax.eval_shape(
        jopt.make_optimizer("adafactor").init,
        jax.eval_shape(lambda k: jmodel.init_params(k, cfg_j),
                       jax.random.PRNGKey(0)))
    got = jax.tree.map(lambda t: t.shape, bridge.params_to_numpy(st))
    assert got == jax.tree.map(lambda t: t.shape, want)


# leaves of the sliced-update test: a stacked leaf, a matrix, a vector, a
# scalar; SLICE_ELEMS forced down to 24 cuts the first two (and the
# vector, in Adafactor's unfactored moments)
SLICED_SHAPES = {"stack": (3, 4, 6, 5), "mat": (40, 7), "vec": (50,),
                 "s": ()}


@pytest.mark.parametrize("name", ["adamw", "lion", "adafactor"])
def test_sliced_update_equals_whole_leaf_update(name, monkeypatch):
    """Three steps with every large leaf updated in slices (SLICE_ELEMS
    forced small) against the same steps on whole leaves: AdamW and Lion
    are elementwise, so params and state are bit-equal; Adafactor's
    update clip sums the squares over the slices in another order, within
    1e-6 rel. L2 a leaf."""
    rng = np.random.default_rng(9)
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in SLICED_SHAPES.items()}
    grads = [{k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for k, s in SLICED_SHAPES.items()} for _ in range(3)]

    def run(limit):
        monkeypatch.setattr(topt, "SLICE_ELEMS", limit)
        opt = topt.make_optimizer(name, **OPT_KW)
        params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
        state = opt.init(params)
        for g in grads:
            params, state, _ = opt.apply(params, g, state)
        return tree_leaves({"p": params, "s": state})

    whole = run(topt.SLICE_ELEMS)
    monkeypatch.setattr(topt, "SLICE_ELEMS", 24)
    keep = 2 if name == "adafactor" else 1
    assert len(topt._slices(torch.Size(SLICED_SHAPES["stack"]), keep)) > 1
    assert len(topt._slices(torch.Size(SLICED_SHAPES["mat"]), 1)) > 1
    sliced = run(24)
    assert len(whole) == len(sliced)
    for a, w in zip(sliced, whole):
        if name == "adafactor":
            a, w = a.double(), w.double()
            assert float((a - w).norm()) <= 1e-6 * max(float(w.norm()),
                                                       1e-30)
        else:
            assert torch.equal(a, w)


def test_global_norm_sums_a_large_leaf_in_slices(monkeypatch):
    """A leaf past ``NORM_SLICE_ELEMS`` has its sum of squares taken a
    slice at a time (no fp32 copy of the whole leaf): the same norm within
    1e-6 rel., a small leaf's bit-equal."""
    rng = np.random.default_rng(10)
    tree = {"big": torch.from_numpy(rng.standard_normal((5, 7, 33)).astype(
        np.float32)).to(torch.bfloat16),
        "small": torch.from_numpy(rng.standard_normal(6).astype(np.float32))}
    whole = topt.global_norm(tree)
    monkeypatch.setattr(topt, "NORM_SLICE_ELEMS", 100)
    sliced = topt.global_norm(tree)
    want = np.sqrt(sum(np.square(np.asarray(t.float(), np.float64)).sum()
                       for t in tree.values()))
    assert abs(float(sliced) - want) <= 1e-6 * want
    assert abs(float(sliced) - float(whole)) <= 1e-6 * want
    assert torch.equal(topt.global_norm({"small": tree["small"]}),
                       tree["small"].square().sum().sqrt())


@pytest.mark.parametrize("name", ["adafactor", "lion"])
def test_optimizer_descends_quadratic(name):
    """tests/test_train_serve_ft.py::test_optimizer_descends_quadratic."""
    opt = topt.make_optimizer(name, lr=0.1, weight_decay=0.0, warmup=1,
                              decay_steps=1000)
    params = {"w": torch.tensor([3.0, -2.0, 5.0], requires_grad=True)}
    state = opt.init(params)
    l0 = float(params["w"].detach().square().sum())
    for _ in range(50):
        g = torch.autograd.grad(params["w"].square().sum(), params["w"])[0]
        params, state, _ = opt.apply(params, {"w": g}, state)
    assert float(params["w"].detach().square().sum()) < 0.2 * l0


def test_adamw_descends_quadratic():
    """tests/test_train_serve_ft.py::test_optimizer_descends_quadratic."""
    opt = topt.make_optimizer("adamw", lr=0.1, weight_decay=0.0, warmup=1,
                              decay_steps=1000)
    params = {"w": torch.tensor([3.0, -2.0, 5.0], requires_grad=True)}
    state = opt.init(params)
    l0 = float(params["w"].detach().square().sum())
    for _ in range(50):
        g = torch.autograd.grad(params["w"].square().sum(), params["w"])[0]
        params, state, _ = opt.apply(params, {"w": g}, state)
    assert float(params["w"].detach().square().sum()) < 0.2 * l0


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_jax(setup, grad_accum):
    cfg_j, cfg_t, params_j = setup
    batch = _batch(6, 4, 16, cfg_t.vocab_size)
    opt_j = jopt.make_optimizer("adamw", **OPT_KW)
    opt_t = topt.make_optimizer("adamw", **OPT_KW)
    step_j = jax.jit(jstep.make_train_step(cfg_j, opt_j,
                                           grad_accum=grad_accum))
    step_t = tstep.make_train_step(cfg_t, opt_t, grad_accum=grad_accum)
    pj, sj, mj = step_j(params_j, opt_j.init(params_j), _jbatch(batch))
    pt = _bridged(params_j)
    pt, st, mt = step_t(pt, opt_t.init(pt), _tbatch(batch))
    assert int(st["step"]) == 1
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               **LOSS_TOL)
    np.testing.assert_allclose(float(mt["grad_norm"]),
                               float(mj["grad_norm"]), rtol=1e-4)
    for a, w, p0 in zip(jax.tree.leaves(bridge.params_to_numpy(pt)),
                        jax.tree.leaves(pj), jax.tree.leaves(params_j)):
        p0 = np.asarray(p0)
        want = np.asarray(w) - p0
        assert np.abs(want).max() > 0
        rel = np.linalg.norm((a - p0) - want) / np.linalg.norm(want)
        assert rel < STEP_UPDATE_REL_L2


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

CFG = tconfigs.get_config("llama3.2-1b", smoke=True)


def test_trainer_memorizes_fixed_batch():
    """tests/test_train_serve_ft.py::test_trainer_memorizes_fixed_batch."""
    class FixedDataset(SyntheticDataset):
        def batch_at(self, step):
            return super().batch_at(0)  # same batch every step

    tr = Trainer(CFG, TrainerConfig(steps=30, global_batch=4, seq_len=32,
                                    log_every=1000),
                 optimizer=topt.make_optimizer("adamw", lr=3e-3, warmup=2,
                                               weight_decay=0.0),
                 device="cpu")
    tr.dataset = FixedDataset(CFG, 4, 32)
    hist = tr.train()
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.5  # memorization


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_checkpoint_restart_resumes_identically(optimizer):
    """tests/test_train_serve_ft.py::
    test_checkpoint_restart_resumes_identically: 3 steps, checkpoint,
    restore into a fresh Trainer, 3 more equal 6 straight steps, params
    and optimizer state; the Trainer takes the optimizer named by the
    config."""
    cfg = dataclasses.replace(CFG, optimizer=optimizer)
    with tempfile.TemporaryDirectory() as d:
        kw = dict(global_batch=4, seq_len=32, log_every=1000, eval_every=2)
        a = Trainer(cfg, TrainerConfig(steps=6, **kw), device="cpu")
        assert type(a.opt).__name__.lower() == optimizer
        a.train()
        b1 = Trainer(cfg, TrainerConfig(steps=3, ckpt_every=3, ckpt_dir=d,
                                        **kw), device="cpu")
        b1.train()
        b2 = Trainer(cfg, TrainerConfig(steps=6, ckpt_dir=d, **kw),
                     device="cpu")
        assert b2.maybe_restore() and b2.step == 3
        b2.train()
        assert [r["step"] for r in b2.history] == [4, 5, 6]
        assert "eval_loss" in b2.history[0]
        for x, y in zip(tree_leaves(a.opt_state), tree_leaves(b2.opt_state)):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6,
                                       atol=1e-6)
        for x, y in zip(tree_leaves(a.params), tree_leaves(b2.params)):
            np.testing.assert_allclose(x.detach().numpy(),
                                       y.detach().numpy(), rtol=1e-6,
                                       atol=1e-6)
            assert y.requires_grad and y.is_leaf


def test_trainer_matches_jax_trainer_data():
    """Both packages draw the same batches from (seed, step)."""
    from repro.data.pipeline import SyntheticDataset as JDataset
    cfg_j = jconfigs.get_config("llama3.2-1b", smoke=True)
    for step in (0, 7):
        want = JDataset(cfg_j, 4, 32, seed=3).batch_at(step)
        got = SyntheticDataset(CFG, 4, 32, seed=3).batch_at(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])


def test_trainer_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(CFG, TrainerConfig(steps=1))
    Trainer(CFG, TrainerConfig(steps=1), device="cpu")


def test_trainer_records_a_step_span_with_its_children():
    """One ``train.step`` span a step, each with the data, gradient,
    optimizer and sync children, all carrying the step's number as
    ``history`` has it; ``spans=False`` records none."""
    tr = Trainer(CFG, TrainerConfig(steps=3, global_batch=2, seq_len=16,
                                    log_every=1000), device="cpu")
    tr.train()
    recs = list(tr.spans.records)
    steps = [r for r in recs if r.name == "train.step"]
    assert [r.step for r in steps] == [h["step"] for h in tr.history]
    for s in steps:
        kids = [r for r in recs if r.parent == s.sid]
        assert [k.name for k in kids] == ["train.data", "train.grad",
                                          "train.optimizer", "train.sync"]
        assert all(k.step == s.step and s.t0_ns <= k.t0_ns <= k.t1_ns
                   <= s.t1_ns for k in kids)
        assert [k.device_s for k in kids] == [None] * 4  # no card here
    off = Trainer(CFG, TrainerConfig(steps=1, global_batch=2, seq_len=16,
                                     log_every=1000), device="cpu",
                  spans=False)
    off.train()
    assert list(off.spans.records) == [] and len(off.history) == 1
