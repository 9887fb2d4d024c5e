"""The port's CUDA kernels and model on the card, against the plain PyTorch
versions.  Marked ``cuda``: they skip without a CUDA device and run on the
card with ``python -m pytest -m cuda tests/test_torch_cuda.py`` (needs no
JAX)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
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
