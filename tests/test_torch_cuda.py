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
