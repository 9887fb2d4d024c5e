"""The port's Mamba-2 SSD and block against the JAX package, on the CPU:
the plain ``mamba_chunk_scan`` against the JAX sequential oracle and the
Pallas kernel in interpret mode (the sweeps of tests/test_kernels.py), its
plain backward ``mamba_chunk_scan_bwd`` against ``jax.vjp`` of the JAX
chunked scan and of the sequential oracle, the autograd wiring of
``ops.mamba_chunk_scan`` (gradcheck), and ``apply_mamba2`` against the JAX
block on bridged params.  The CUDA kernels themselves are held against the
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mamba_chunk_scan import \
    mamba_chunk_scan as pallas_ssd  # noqa: E402
from repro.models import mamba2 as jmamba  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import mamba_chunk_scan as mcs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import mamba2 as tmamba  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_kernels.py (SSD sweeps)
# Gradients against jax.vjp (tests/test_torch_train.py): each fp32
# gradient within this relative L2; in bf16 the JAX vjp rounds the
# gradients of x, b and c to bf16 where the port's plain backward rounds
# once at the end, a few bf16 steps apart (elementwise).
GRAD_REL_L2 = 1e-4
GRAD_TOL_BF16 = dict(rtol=5e-2, atol=5e-2)

SWEEP = [  # (b, s, nh, hd, ns, chunk): tests/test_kernels.py
    (2, 128, 3, 32, 16, 32),
    (1, 256, 2, 64, 32, 64),
    (1, 64, 4, 16, 8, 64),   # single chunk
]


def _ssd_inputs(seed, b, s, nh, hd, ns):
    """x, dt, a, b, c, d as numpy fp32, drawn as tests/test_kernels.py
    draws them (dt > 0, a < 0)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, s, nh, hd)).astype(f),
            (np.abs(rng.standard_normal((b, s, nh))) * 0.1 + 0.01).astype(f),
            -(np.abs(rng.standard_normal(nh)) + 0.1).astype(f),
            rng.standard_normal((b, s, ns)).astype(f),
            rng.standard_normal((b, s, ns)).astype(f),
            rng.standard_normal(nh).astype(f))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("oracle", ["jax_ref", "pallas_interpret"])
@pytest.mark.parametrize("b,s,nh,hd,ns,chunk", SWEEP)
def test_plain_ssd_matches_jax(oracle, b, s, nh, hd, ns, chunk):
    arrs = _ssd_inputs(s + nh, b, s, nh, hd, ns)
    if oracle == "jax_ref":
        want_y, want_h = jref.mamba_chunk_scan(*map(jnp.asarray, arrs))
    else:
        want_y, want_h = pallas_ssd(*map(jnp.asarray, arrs), chunk=chunk,
                                    interpret=True)
    got_y, got_h = ops.mamba_chunk_scan(*map(torch.from_numpy, arrs),
                                        chunk=chunk)
    assert got_y.dtype == torch.float32 and got_h.dtype == torch.float32
    _close(got_y, want_y)
    _close(got_h, want_h)


def test_plain_ssd_with_initial_state_matches_pallas():
    """Split at h0: the first half's h_final feeds the second half
    (tests/test_kernels.py::test_mamba_chunk_scan_with_initial_state)."""
    b, s, nh, hd, ns = 1, 128, 2, 16, 8
    x, dt, a, bm, cm, d = _ssd_inputs(5, b, s, nh, hd, ns)
    t = torch.from_numpy
    _, h1 = ref.mamba_chunk_scan(t(x[:, :64]), t(dt[:, :64]), t(a),
                                 t(bm[:, :64]), t(cm[:, :64]), t(d))
    y2, h2 = ref.mamba_chunk_scan(t(x[:, 64:]), t(dt[:, 64:]), t(a),
                                  t(bm[:, 64:]), t(cm[:, 64:]), t(d), h0=h1)
    j = jnp.asarray
    _, jh1 = jref.mamba_chunk_scan(j(x[:, :64]), j(dt[:, :64]), j(a),
                                   j(bm[:, :64]), j(cm[:, :64]), j(d))
    jy2, jh2 = pallas_ssd(j(x[:, 64:]), j(dt[:, 64:]), j(a), j(bm[:, 64:]),
                          j(cm[:, 64:]), j(d), chunk=32, h0=jh1,
                          interpret=True)
    _close(y2, jy2)
    _close(h2, jh2)
    y_full, h_full = ref.mamba_chunk_scan(*map(t, (x, dt, a, bm, cm, d)))
    _close(y2, y_full[:, 64:].numpy())
    _close(h2, h_full.numpy())


def test_plain_ssd_keeps_x_dtype():
    x, dt, a, bm, cm, d = map(torch.from_numpy,
                              _ssd_inputs(6, 1, 9, 2, 16, 8))
    y, h = ref.mamba_chunk_scan(x.bfloat16(), dt, a, bm.bfloat16(),
                                cm.bfloat16(), d)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32


# (b, s, nh, hd, ns, chunk, with h0): one chunk, several, a ragged S
BWD_CASES = [(1, 16, 2, 8, 4, 16, True),
             (2, 48, 3, 8, 4, 16, False),
             (1, 37, 2, 8, 4, 16, True)]
NAMES = ("x", "dt", "a", "b", "c", "d", "h0")


def _jax_ssd(oracle, s, chunk, with_h0):
    """The JAX forward as a function of (x, dt, a, b, c, d[, h0]) ->
    (y, h_final): the chunked scan of the JAX model (zero-padded to whole
    chunks, as apply_mamba2 pads, h0 zeros when not given) or the
    sequential oracle."""
    def f(x, dt, a, b, c, d, h0=None):
        if oracle == "jax_ref":
            return jref.mamba_chunk_scan(x, dt, a, b, c, d, h0=h0)
        pad = -s % chunk
        padded = [jnp.pad(t, [(0, 0), (0, pad)] + [(0, 0)] * (t.ndim - 2))
                  for t in (x, dt, b, c)]
        if h0 is None:
            h0 = jnp.zeros((x.shape[0], x.shape[2], x.shape[3], b.shape[-1]),
                           jnp.float32)
        y, hf = jmamba._ssd_chunked(padded[0], padded[1], a, padded[2],
                                    padded[3], d, h0, chunk)
        return y[:, :s].astype(x.dtype), hf
    return f


@pytest.mark.parametrize("oracle", ["ssd_chunked", "jax_ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,nh,hd,ns,chunk,with_h0", BWD_CASES)
def test_plain_ssd_bwd_matches_jax_vjp(oracle, dtype, b, s, nh, hd, ns,
                                       chunk, with_h0):
    """ref.mamba_chunk_scan_bwd, the exact reverse recurrence, against
    jax.vjp of the JAX chunked scan and of the sequential oracle: x, b and
    c (and dy) in ``dtype``, the rest fp32."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    rng = np.random.default_rng(s + nh)
    arrs = list(_ssd_inputs(s + nh, b, s, nh, hd, ns))
    if with_h0:
        arrs.append(rng.standard_normal((b, nh, hd, ns)).astype(np.float32))
    dy = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    dhf = rng.standard_normal((b, nh, hd, ns)).astype(np.float32)
    low = (0, 3, 4)  # x, b, c in dtype
    jargs = [jnp.asarray(a, jdt if i in low else jnp.float32)
             for i, a in enumerate(arrs)]
    targs = [torch.from_numpy(a).to(tdt if i in low else torch.float32)
             for i, a in enumerate(arrs)]
    f = _jax_ssd(oracle, s, chunk, with_h0)
    want = jax.jit(lambda p, c: jax.vjp(f, *p)[1](c))(
        jargs, (jnp.asarray(dy, jdt), jnp.asarray(dhf)))
    got = ref.mamba_chunk_scan_bwd(*targs[:6], torch.from_numpy(dy).to(tdt),
                                   torch.from_numpy(dhf),
                                   h0=targs[6] if with_h0 else None)
    assert (got[-1] is None) == (not with_h0)
    for name, g, w, t in zip(NAMES, got, want, targs):
        assert g.dtype == t.dtype, name
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        if dtype == "float32":
            rel = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert rel < GRAD_REL_L2, (name, rel)
        else:
            np.testing.assert_allclose(g, w, **GRAD_TOL_BF16, err_msg=name)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ops_mamba_chunk_scan_gradcheck(with_h0):
    """The autograd function of ops.mamba_chunk_scan (forward and
    ref.mamba_chunk_scan_bwd, on the CPU) against finite differences, in
    float64; a ragged-free small case with h_final used too."""
    gen = torch.Generator().manual_seed(3)
    b, s, nh, hd, ns = 1, 5, 2, 3, 4
    r = lambda *sh: torch.randn(sh, dtype=torch.float64,  # noqa: E731
                                generator=gen)
    args = [r(b, s, nh, hd),
            torch.rand(b, s, nh, dtype=torch.float64, generator=gen) * 0.5
            + 0.05,
            -torch.rand(nh, dtype=torch.float64, generator=gen) - 0.1,
            r(b, s, ns), r(b, s, ns), r(nh)]
    if with_h0:
        args.append(r(b, nh, hd, ns))
    args = [a.requires_grad_(True) for a in args]

    def f(*t):
        y, hf = ops.mamba_chunk_scan(*t[:6], h0=t[6] if with_h0 else None)
        return y, hf
    assert torch.autograd.gradcheck(f, tuple(args))


def test_ops_mamba_chunk_scan_records_only_when_asked():
    """Serving (no grad, or no input that requires grad) runs the forward
    alone; under autograd the function's backward reaches a, d, dt and
    the rest, with h_final unused (no zeros materialized for it)."""
    x, dt, a, bm, cm, d = map(torch.from_numpy,
                              _ssd_inputs(7, 1, 10, 2, 8, 4))
    y, _ = ops.mamba_chunk_scan(x, dt, a, bm, cm, d)
    assert y.grad_fn is None
    a = a.requires_grad_(True)
    with torch.no_grad():
        assert ops.mamba_chunk_scan(x, dt, a, bm, cm, d)[0].grad_fn is None
    y, _ = ops.mamba_chunk_scan(x, dt, a, bm, cm, d)
    assert y.grad_fn is not None
    (da,) = torch.autograd.grad(y.sum(), a)
    assert da.shape == a.shape and bool(torch.isfinite(da).all())


@pytest.fixture(scope="module")
def block():
    cfg_j = jconfigs.get_config("zamba2-2.7b", smoke=True)
    cfg_t = tconfigs.get_config("zamba2-2.7b", smoke=True)
    spec = cfg_j.groups[0].pattern[0]
    params_j = jmamba.init_mamba2(jax.random.PRNGKey(0), cfg_j, spec)
    # non-trivial decay rates and skips, the same on both sides
    rng = np.random.default_rng(0)
    nh = params_j["a_log"].shape[0]
    params_j = dict(params_j,
                    a_log=jnp.asarray(rng.normal(0, 0.5, nh), jnp.float32),
                    dt_bias=jnp.asarray(rng.normal(-1, 0.5, nh), jnp.float32),
                    d_skip=jnp.asarray(rng.normal(1, 0.2, nh), jnp.float32))
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        "cpu")
    return cfg_j, cfg_t, spec, params_j, params_t


@pytest.mark.parametrize("s", [32, 37])  # 37: not a chunk multiple (16)
def test_apply_mamba2_prefill_then_decode_matches_jax(block, s):
    cfg_j, cfg_t, spec, params_j, params_t = block
    b = 2
    x = np.random.default_rng(s).standard_normal(
        (b, s + 1, cfg_t.d_model)).astype(np.float32)
    cache_j = jmamba.init_mamba_cache(cfg_j, spec, b, s + 1, jnp.float32)
    cache_t = tmamba.init_mamba_cache(cfg_t, spec, b, s + 1, torch.float32,
                                      "cpu")
    for sl in (slice(0, s), slice(s, s + 1)):  # prefill, then one decode
        want, cache_j = jmamba.apply_mamba2(params_j, cfg_j, spec,
                                            jnp.asarray(x[:, sl]), cache_j)
        got, cache_t = tmamba.apply_mamba2(params_t, cfg_t, spec,
                                           torch.from_numpy(x[:, sl]),
                                           cache_t)
        _close(got, want)
        for key in ("conv", "ssm"):
            _close(cache_t[key], cache_j[key])


def test_apply_mamba2_without_cache_matches_jax(block):
    cfg_j, cfg_t, spec, params_j, params_t = block
    x = np.random.default_rng(1).standard_normal(
        (2, 21, cfg_t.d_model)).astype(np.float32)
    want, _ = jmamba.apply_mamba2(params_j, cfg_j, spec, jnp.asarray(x))
    got, cache = tmamba.apply_mamba2(params_t, cfg_t, spec,
                                     torch.from_numpy(x))
    assert cache is None
    _close(got, want)


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(2)
    x, w, b, tail = (rng.standard_normal(s).astype(np.float32)
                     for s in ((2, 9, 12), (4, 12), (12,), (2, 3, 12)))
    for t in (None, tail):
        want = jmamba._causal_conv(*map(jnp.asarray, (x, w, b)),
                                   None if t is None else jnp.asarray(t))
        got = tmamba._causal_conv(*map(torch.from_numpy, (x, w, b)),
                                  None if t is None else torch.from_numpy(t))
        for g, w_ in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w_),
                                       rtol=1e-6, atol=1e-6)


def test_init_mamba2_tree_matches_jax(block):
    cfg_j, cfg_t, spec, params_j, _ = block
    mine = bridge.params_to_numpy(tmamba.init_mamba2(
        torch.Generator().manual_seed(0), cfg_t, spec, "cpu"))
    theirs = jax.tree.map(np.asarray, params_j)
    assert jax.tree.structure(mine) == jax.tree.structure(theirs)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
        assert a.shape == b.shape and a.dtype == b.dtype
    for key in ("a_log", "dt_bias", "d_skip"):
        assert mine[key].dtype == np.float32


def test_cpu_dispatch_launches_no_ssd_kernel():
    mcs.mamba_chunk_scan.launches = 0
    arrs = map(torch.from_numpy, _ssd_inputs(3, 1, 8, 2, 16, 8))
    ops.mamba_chunk_scan(*arrs)
    assert mcs.mamba_chunk_scan.launches == 0


def test_ssd_wrapper_refuses_cpu_tensors():
    arrs = list(map(torch.from_numpy, _ssd_inputs(4, 1, 8, 2, 16, 8)))
    with pytest.raises(ValueError, match="not CUDA"):
        mcs.mamba_chunk_scan(*arrs)
    assert mcs.mamba_chunk_scan.launches == 0
    bwd0 = mcs.mamba_chunk_scan_bwd.launches
    with pytest.raises(ValueError, match="not CUDA"):
        mcs.mamba_chunk_scan_bwd(*arrs, torch.zeros(1, 8, 2, 16), None)
    assert mcs.mamba_chunk_scan_bwd.launches == bwd0


@pytest.mark.parametrize("hd,ns,q", [(64, 64, 64), (128, 64, 64),
                                     (64, 128, 64), (128, 128, 32),
                                     (8, 8, 64)])
def test_ssd_bwd_chunk_fits_shared_memory(hd, ns, q):
    """The backward kernel's chunk length: 64 rows where its shared memory
    fits a CTA on the H100, else 32; every shape the forward takes fits
    at one of them."""
    assert mcs.bwd_chunk(hd, ns) == q
    assert mcs.bwd_smem_bytes(q, hd, ns) <= mcs.MAX_SMEM


@pytest.mark.parametrize("nh,hd,ns,g", [(80, 64, 64, 8), (3, 64, 64, 3),
                                        (80, 128, 64, 8), (80, 64, 128, 1),
                                        (80, 128, 128, 1), (2, 8, 8, 2)])
def test_ssd_bwd_head_group_fits_shared_memory(nh, hd, ns, g):
    """The bf16 backward's head group: 8 heads (at most NH) where NS <=
    64, whose db and dc the kernel sums in registers; one head at a larger
    NS; its chunk kernel's shared memory fits a CTA on the H100 at every
    shape the forward takes, and two CTAs an SM at zamba2's."""
    assert mcs.bwd_group(nh, hd, ns) == g
    assert mcs.bwd_sm90_smem_bytes(hd, ns, g) <= mcs.MAX_SMEM
    assert 2 * (mcs.bwd_sm90_smem_bytes(64, 64, 8) + 1024) <= 228 * 1024
