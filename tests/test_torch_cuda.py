"""The port's CUDA kernels and models on the card, against the plain PyTorch
versions.  Marked ``cuda``: they skip without a CUDA device and run on the
card with ``python -m pytest -m cuda tests/test_torch_cuda.py`` (needs no
JAX)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba_chunk_scan as mcs  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device=device, dtype=dtype)


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,window,cap,q_offset", [
    (1, 200, 200, 32, 8, 64, True, None, None, 0),   # ragged S
    (2, 77, 77, 4, 1, 128, True, 32, 30.0, 0),
    (1, 40, 168, 4, 2, 32, True, 100, None, 128),    # q_offset, T > S
    (1, 33, 50, 4, 4, 64, False, None, 50.0, 0),
    (1, 200, 200, 32, 32, 80, True, None, None, 0),  # zamba2's hd 80
    (2, 45, 109, 4, 2, 80, True, 40, 30.0, 64),
    (1, 1, 1, 4, 2, 64, True, None, None, 0),        # S, T off the 64 grid
    (2, 63, 63, 8, 1, 64, True, None, None, 0),      # G = 8
    (1, 65, 129, 4, 4, 64, True, None, None, 64),    # G = 1, T > S
    (1, 129, 129, 8, 2, 128, False, None, None, 0),
    (1, 129, 129, 4, 2, 80, True, 48, 30.0, 0),      # hd 80, window, cap
    (1, 65, 65, 8, 1, 32, True, 16, 50.0, 0),
])
def test_flash_kernel_matches_plain(cuda, dtype, b, s, t, h, kv, hd, causal,
                                    window, cap, q_offset):
    rng = np.random.default_rng(s)
    q = _randn(rng, (b, s, h, hd), dtype, cuda)
    k = _randn(rng, (b, t, kv, hd), dtype, cuda)
    v = _randn(rng, (b, t, kv, hd), dtype, cuda)
    kw = dict(causal=causal, window=window, softcap=cap, scale=hd ** -0.5,
              q_offset=q_offset)
    n = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n + 1
    _close(got, ref.flash_attention(q, k, v, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,kv,hd,window,cap", [
    (8, 1024, 32, 8, 64, None, None),
    (3, 300, 16, 1, 32, 100, None),
    (2, 64, 8, 8, 128, None, 20.0),
    (8, 1024, 32, 32, 80, None, None),               # zamba2's hd 80, G 1
    (3, 300, 8, 2, 80, 100, 30.0),
])
def test_decode_kernel_matches_plain(cuda, dtype, b, t, h, kv, hd, window,
                                     cap):
    rng = np.random.default_rng(t)
    q = _randn(rng, (b, 1, h, hd), dtype, cuda)
    k = _randn(rng, (b, t, kv, hd), dtype, cuda)
    v = _randn(rng, (b, t, kv, hd), dtype, cuda)
    lengths = torch.from_numpy(
        rng.integers(1, t + 1, size=(b,)).astype(np.int32)).to(cuda)
    kw = dict(lengths=lengths, window=window, softcap=cap, scale=hd ** -0.5)
    got = da.decode_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    _close(got, ref.decode_attention(q, k, v, **kw), dtype)


SSD_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
           torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _ssd_inputs(rng, b, s, nh, hd, ns, dtype, device):
    """x, b, c in ``dtype``; dt, a, d in fp32 (tests/test_kernels.py)."""
    f = np.float32
    dt = (np.abs(rng.standard_normal((b, s, nh))) * 0.1 + 0.01).astype(f)
    a = -(np.abs(rng.standard_normal(nh)) + 0.1).astype(f)
    return (_randn(rng, (b, s, nh, hd), dtype, device),
            torch.from_numpy(dt).to(device), torch.from_numpy(a).to(device),
            _randn(rng, (b, s, ns), dtype, device),
            _randn(rng, (b, s, ns), dtype, device),
            _randn(rng, (nh,), torch.float32, device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,nh,hd,ns", [
    (2, 128, 3, 32, 16),     # the sweep of tests/test_kernels.py
    (1, 256, 2, 64, 32),
    (1, 64, 4, 16, 8),
    (1, 512, 80, 64, 64),    # zamba2-2.7b's prefill at full width
    (2, 200, 3, 64, 64),     # ragged S: 3 chunks of 64 and 8 rows
    (1, 37, 4, 128, 128),    # ragged single chunk, largest dims
])
def test_ssd_kernel_matches_plain(cuda, dtype, b, s, nh, hd, ns):
    rng = np.random.default_rng(s + nh)
    args = _ssd_inputs(rng, b, s, nh, hd, ns, dtype, cuda)
    n = mcs.mamba_chunk_scan.launches
    y, h = mcs.mamba_chunk_scan(*args)
    torch.cuda.synchronize()
    assert mcs.mamba_chunk_scan.launches == n + 1
    assert y.dtype == dtype and h.dtype == torch.float32
    want_y, want_h = ref.mamba_chunk_scan(*args)
    torch.testing.assert_close(y.float(), want_y.float(), **SSD_TOL[dtype])
    torch.testing.assert_close(h, want_h, **SSD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_with_initial_state(cuda, dtype):
    """Split at h0 (tests/test_kernels.py): the first half's h_final fed
    as h0 to the second half gives the whole sequence's y and h_final."""
    x, dt, a, bm, cm, d = _ssd_inputs(np.random.default_rng(7), 2, 160, 4,
                                      64, 64, dtype, cuda)
    cut = 96
    first = [t[:, :cut].contiguous() for t in (x, dt, bm, cm)]
    second = [t[:, cut:].contiguous() for t in (x, dt, bm, cm)]
    _, h1 = mcs.mamba_chunk_scan(first[0], first[1], a, first[2], first[3],
                                 d)
    y2, h2 = mcs.mamba_chunk_scan(second[0], second[1], a, second[2],
                                  second[3], d, h0=h1)
    torch.cuda.synchronize()
    want_y, want_h = ref.mamba_chunk_scan(x, dt, a, bm, cm, d)
    torch.testing.assert_close(y2.float(), want_y[:, cut:].float(),
                               **SSD_TOL[dtype])
    torch.testing.assert_close(h2, want_h, **SSD_TOL[dtype])


def test_kernels_reject_unsupported_inputs(cuda):
    q = torch.zeros(1, 4, 4, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 4, 4, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 1, 4, 64, device=cuda)
    k = torch.zeros(1, 8, 4, 64, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        da.decode_attention(q, k, k, lengths=torch.ones(1, dtype=torch.int64,
                                                        device=cuda))
    x, dt, a, bm, cm, d = _ssd_inputs(np.random.default_rng(0), 1, 8, 2,
                                      160, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="head dim"):
        mcs.mamba_chunk_scan(x, dt, a, bm, cm, d)
    x, dt, a, bm, cm, d = _ssd_inputs(np.random.default_rng(0), 1, 8, 2,
                                      16, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="dtype"):
        mcs.mamba_chunk_scan(x, dt, a, bm.bfloat16(), cm, d)


def test_model_on_card_matches_cpu(cuda):
    """A small llama-shaped model (head_dim 32, which the kernels take):
    prefill + decode logits through the kernels match the CPU plain path."""
    from repro_torch import configs
    from repro_torch.models import model
    from repro_torch.models.common import tree_map
    cfg = dataclasses.replace(configs.get_config("llama3.2-1b", smoke=True),
                              d_model=128, num_heads=4, num_kv_heads=2,
                              head_dim=32, d_ff=256)
    params = model.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    params_gpu = tree_map(lambda a: a.to(cuda), params)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 21)).astype(np.int32))
    outs = []
    for dev, p in (("cpu", params), (cuda, params_gpu)):
        cache = model.init_cache(cfg, 2, 32, device=dev)
        pre, cache = model.prefill(p, cfg, toks[:, :-1].to(dev), cache)
        dec, _ = model.decode_step(p, cfg, toks[:, -1:].to(dev), cache,
                                   torch.full((2,), 20, dtype=torch.int32,
                                              device=dev))
        outs.append((pre.cpu(), dec.cpu()))
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, rtol=2e-4, atol=2e-4)


def test_zamba2_on_card_matches_cpu(cuda):
    """A small zamba2-shaped model (attention head_dim 80, which the
    kernels take): prefill + decode logits through the three kernels match
    the CPU plain path, and the SSD kernel runs once per mamba layer."""
    from repro_torch import configs
    from repro_torch.models import model
    from repro_torch.models.common import tree_map
    cfg = dataclasses.replace(configs.get_config("zamba2-2.7b", smoke=True),
                              d_model=128, num_heads=2, num_kv_heads=2,
                              head_dim=80, d_ff=256)
    params = model.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    params_gpu = tree_map(lambda a: a.to(cuda), params)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 71)).astype(np.int32))
    outs = []
    n_mamba = sum(sum(s.kind == "mamba2" for s in g.pattern) * g.repeat
                  for g in cfg.groups)
    for dev, p in (("cpu", params), (cuda, params_gpu)):
        cache = model.init_cache(cfg, 2, 80, device=dev)
        n = mcs.mamba_chunk_scan.launches
        pre, cache = model.prefill(p, cfg, toks[:, :-1].to(dev), cache)
        launched = mcs.mamba_chunk_scan.launches - n
        dec, _ = model.decode_step(p, cfg, toks[:, -1:].to(dev), cache,
                                   torch.full((2,), 70, dtype=torch.int32,
                                              device=dev))
        outs.append((pre.cpu(), dec.cpu()))
    assert launched == n_mamba
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# training kernels: rmsnorm forward/backward, flash-attention LSE and
# backward
# ---------------------------------------------------------------------------

# dx and dscale are sums in another order than the plain version's: fp32
# within 1e-4, bf16 within the kernel tolerance of tests/test_kernels.py
RMS_BWD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
               torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
# fp32: the backward's products run in fp32 on both sides (the kernel on
# the CUDA cores), summed in another order; bf16: the plain version rounds
# q.k to bf16 before the softmax, the kernel rounds P and dS to bf16 as
# tensor-core operands
FLASH_BWD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
                 torch.bfloat16: dict(rtol=5e-2, atol=5e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (4, 37, 256), (2, 128), (1, 8, 8, 512),   # tests/test_kernels.py
    (8192, 2048), (37, 2560), (5, 5120),      # the slices' widths
    (3, 100), (1, 64),                        # d not a multiple of 8
])
@pytest.mark.parametrize("zero_centered", [True, False])
def test_rmsnorm_kernels_match_plain(cuda, dtype, shape, zero_centered):
    from repro_torch.kernels import rmsnorm as rn
    rng = np.random.default_rng(shape[-1] + len(shape))
    x = _randn(rng, shape, dtype, cuda)
    scale = _randn(rng, (shape[-1],), dtype, cuda) * 0.1
    g = _randn(rng, shape, dtype, cuda)
    kw = dict(eps=1e-6, zero_centered=zero_centered)
    n = rn.rmsnorm_fwd.launches, rn.rmsnorm_bwd.launches
    y, rstd = rn.rmsnorm_fwd(x, scale, **kw)
    dx, dscale = rn.rmsnorm_bwd(x, scale, rstd, g,
                                zero_centered=zero_centered)
    torch.cuda.synchronize()
    assert (rn.rmsnorm_fwd.launches, rn.rmsnorm_bwd.launches) == \
        (n[0] + 1, n[1] + 1)
    _close(y, ref.rmsnorm(x, scale, **kw), dtype)
    want_r = torch.rsqrt(x.float().square().mean(-1) + 1e-6)
    torch.testing.assert_close(rstd, want_r, rtol=2e-5, atol=2e-5)
    want_dx, want_ds = ref.rmsnorm_bwd(x, scale, g, **kw)
    assert dx.dtype == dtype and dscale.dtype == dtype
    torch.testing.assert_close(dx.float(), want_dx.float(),
                               **RMS_BWD_TOL[dtype])
    torch.testing.assert_close(dscale.float(), want_ds.float(),
                               **RMS_BWD_TOL[dtype])


def test_rmsnorm_backward_is_deterministic(cuda):
    from repro_torch.kernels import rmsnorm as rn
    rng = np.random.default_rng(1)
    x = _randn(rng, (8192, 2048), torch.bfloat16, cuda)
    scale = _randn(rng, (2048,), torch.bfloat16, cuda)
    g = _randn(rng, (8192, 2048), torch.bfloat16, cuda)
    _, rstd = rn.rmsnorm_fwd(x, scale)
    first = rn.rmsnorm_bwd(x, scale, rstd, g)
    for _ in range(3):
        for a, b in zip(first, rn.rmsnorm_bwd(x, scale, rstd, g)):
            assert torch.equal(a, b)


FLASH_BWD_CASES = [  # (b, s, t, h, kv, hd, causal, window, cap)
    (2, 256, 256, 4, 2, 64, True, None, None),   # tests/test_kernels.py
    (1, 256, 256, 8, 8, 128, True, None, 50.0),
    (2, 512, 512, 4, 1, 64, True, 128, None),
    (1, 128, 128, 4, 4, 32, False, None, None),
    (1, 384, 384, 6, 2, 64, True, 256, 30.0),
    (1, 200, 200, 4, 2, 80, True, 64, 30.0),     # hd 80, ragged S
    (2, 77, 77, 4, 1, 128, True, 32, None),      # ragged, window
    (1, 33, 50, 4, 4, 64, False, None, 50.0),    # T > S, non-causal
    (1, 1, 1, 4, 2, 64, True, None, None),       # S, T off the 64 grid
    (2, 63, 63, 8, 1, 64, True, None, None),     # G = 8
    (1, 65, 129, 4, 4, 64, False, None, None),   # G = 1
    (1, 129, 129, 8, 2, 128, True, None, None),
    (1, 129, 129, 4, 2, 80, True, 48, 30.0),     # hd 80, window, cap
    (1, 65, 65, 8, 1, 32, True, 16, 50.0),
]


def _flash_bwd_inputs(rng, b, s, t, h, kv, hd, dtype, device):
    return (_randn(rng, (b, s, h, hd), dtype, device),
            _randn(rng, (b, t, kv, hd), dtype, device),
            _randn(rng, (b, t, kv, hd), dtype, device),
            _randn(rng, (b, s, h, hd), dtype, device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,window,cap", FLASH_BWD_CASES)
def test_flash_lse_and_backward_match_plain(cuda, dtype, b, s, t, h, kv, hd,
                                            causal, window, cap):
    rng = np.random.default_rng(s + hd)
    q, k, v, do = _flash_bwd_inputs(rng, b, s, t, h, kv, hd, dtype, cuda)
    kw = dict(causal=causal, window=window, softcap=cap, scale=hd ** -0.5)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    want_o, want_lse = ref.flash_attention_fwd(q, k, v, **kw)
    _close(o, want_o, dtype)
    torch.testing.assert_close(lse, want_lse, **TOL[dtype])
    n = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == n + 1
    want = ref.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype, name
        torch.testing.assert_close(a.float(), w.float(),
                                   **FLASH_BWD_TOL[dtype], msg=name)


def test_flash_backward_is_deterministic(cuda):
    rng = np.random.default_rng(3)
    q, k, v, do = _flash_bwd_inputs(rng, 2, 512, 512, 32, 8, 64,
                                    torch.bfloat16, cuda)
    o, lse = fa.flash_attention_fwd(q, k, v, scale=0.125)
    first = fa.flash_attention_bwd(q, k, v, o, lse, do, scale=0.125)
    for a, b in zip(first, fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                  scale=0.125)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,kv,hd,window,cap,q_offset", [
    (1, 64, 192, 4, 2, 64, None, None, 128),
    (2, 100, 164, 8, 2, 64, 48, None, 64),
    (1, 77, 205, 4, 4, 80, 64, 30.0, 128),
    (1, 40, 168, 4, 1, 32, None, 50.0, 64),
])
def test_flash_backward_takes_q_offset(cuda, dtype, b, s, t, h, kv, hd,
                                       window, cap, q_offset):
    """Query rows at positions q_offset + i against T > S keys, causal."""
    rng = np.random.default_rng(q_offset + s)
    q, k, v, do = _flash_bwd_inputs(rng, b, s, t, h, kv, hd, dtype, cuda)
    kw = dict(causal=True, window=window, softcap=cap, scale=hd ** -0.5,
              q_offset=q_offset)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    want = ref.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a.float(), w.float(),
                                   **FLASH_BWD_TOL[dtype], msg=name)


def test_flash_kernels_at_the_training_shape(cuda):
    """llama3.2-1b's training attention, (4, 2048, 32, 8, 64) causal bf16:
    the forward with its LSE and the backward against the plain versions."""
    rng = np.random.default_rng(2048)
    q, k, v, do = _flash_bwd_inputs(rng, 4, 2048, 2048, 32, 8, 64,
                                    torch.bfloat16, cuda)
    kw = dict(causal=True, scale=0.125)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    want_o, want_lse = ref.flash_attention_fwd(q, k, v, **kw)
    _close(o, want_o, torch.bfloat16)
    torch.testing.assert_close(lse, want_lse, **TOL[torch.bfloat16])
    del want_o, want_lse
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    want = ref.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a.float(), w.float(),
                                   **FLASH_BWD_TOL[torch.bfloat16], msg=name)


def test_serving_kernels_raise_under_autograd(cuda):
    """decode_attention and mamba_chunk_scan have no backward: under grad
    mode with an input that requires grad they raise, never detach."""
    q = torch.zeros(1, 1, 4, 64, device=cuda, requires_grad=True)
    k = torch.zeros(1, 8, 4, 64, device=cuda)
    lengths = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="detached"):
        da.decode_attention(q, k, k, lengths=lengths)
    args = list(_ssd_inputs(np.random.default_rng(0), 1, 8, 2, 16, 16,
                            torch.float32, cuda))
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="detached"):
        mcs.mamba_chunk_scan(*args)
    with torch.no_grad():  # serving: no graph to cut
        da.decode_attention(q, k, k, lengths=lengths)
        mcs.mamba_chunk_scan(*args)


def test_forward_loss_gradients_on_card_match_cpu(cuda):
    """llama3.2-1b at full width cut to 2 layers, fp32: forward_loss and
    every gradient through the kernels (flash and rmsnorm, forward and
    backward) against the CPU plain path on the same params and batch."""
    from repro_torch import configs
    from repro_torch.models import model
    from repro_torch.models.common import tree_map
    from repro_torch.models.config import uniform_groups
    cfg = configs.get_config("llama3.2-1b")
    cfg = dataclasses.replace(cfg, dtype="float32", remat="full",
                              groups=uniform_groups(2, cfg.groups[0].pattern[0]))
    params = model.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 129)).astype(np.int32))
    res = []
    for dev in ("cpu", cuda):
        p = tree_map(lambda a: a.to(dev).requires_grad_(True), params)
        leaves = []
        tree_map(leaves.append, p)
        loss, _ = model.forward_loss(p, cfg, toks[:, :-1].to(dev),
                                     toks[:, 1:].to(dev))
        grads = torch.autograd.grad(loss, leaves)
        res.append((loss.detach().cpu(), [g.cpu() for g in grads]))
    (l_cpu, g_cpu), (l_gpu, g_gpu) = res
    torch.testing.assert_close(l_gpu, l_cpu, rtol=2e-4, atol=2e-4)
    for a, b in zip(g_gpu, g_cpu):
        assert float((a - b).norm() / b.norm()) < 1e-3
