"""The port's plain attention (repro_torch.kernels.ref / ops on CPU tensors)
against the JAX oracles and the Pallas kernels, on the sweeps of
tests/test_kernels.py.  The CUDA kernels themselves are held against the
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import \
    decode_attention as pallas_decode  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as pallas_flash  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

FLASH_CASES = [
    (2, 256, 4, 2, 64, True, None, None),
    (1, 256, 8, 8, 128, True, None, 50.0),
    (2, 512, 4, 1, 64, True, 128, None),
    (1, 128, 4, 4, 32, False, None, None),
    (1, 384, 6, 2, 64, True, 256, 30.0),
]
DECODE_CASES = [
    (2, 256, 8, 2, 64, None, None),
    (1, 512, 4, 4, 128, 128, None),
    (3, 256, 16, 8, 64, None, 30.0),
    (2, 384, 8, 1, 32, 64, None),
]


def _pair(a: np.ndarray, dtype: str):
    """The same numpy array as a JAX array and a CPU tensor of ``dtype``."""
    return (jnp.asarray(a, JDT[dtype]),
            torch.from_numpy(a.astype(np.float32)).to(TDT[dtype]))


def _inputs(seed, dtype, *shapes):
    rng = np.random.default_rng(seed)
    return [_pair(rng.standard_normal(s).astype(np.float32), dtype)
            for s in shapes]


def _close(got_t, want_j, dtype):
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_j, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,hd,causal,window,cap", FLASH_CASES)
def test_flash_attention_matches_jax_ref(dtype, b, s, h, kv, hd, causal,
                                         window, cap):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        s + h, dtype, (b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))
    kw = dict(causal=causal, window=window, softcap=cap,
              scale=1.0 / np.sqrt(hd))
    _close(ops.flash_attention(qt, kt, vt, **kw),
           jref.flash_attention(qj, kj, vj, **kw), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h,kv,hd,window,cap", DECODE_CASES)
def test_decode_attention_matches_jax_ref(dtype, b, t, h, kv, hd, window,
                                          cap):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        t + h, dtype, (b, 1, h, hd), (b, t, kv, hd), (b, t, kv, hd))
    lengths = np.random.default_rng(t).integers(1, t, size=(b,))
    kw = dict(window=window, softcap=cap, scale=1.0 / np.sqrt(hd))
    got = ops.decode_attention(
        qt, kt, vt, lengths=torch.from_numpy(lengths.astype(np.int32)), **kw)
    want = jref.decode_attention(
        qj, kj, vj, lengths=jnp.asarray(lengths, jnp.int32), **kw)
    _close(got, want, dtype)


def test_flash_attention_matches_pallas_kernel():
    b, s, h, kv, hd = 1, 384, 6, 2, 64
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        7, "float32", (b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))
    kw = dict(causal=True, window=256, softcap=30.0, scale=1.0 / np.sqrt(hd))
    _close(ops.flash_attention(qt, kt, vt, **kw),
           pallas_flash(qj, kj, vj, interpret=True, **kw), "float32")


def test_decode_attention_matches_pallas_kernel():
    b, t, h, kv, hd = 3, 256, 16, 8, 64
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        8, "float32", (b, 1, h, hd), (b, t, kv, hd), (b, t, kv, hd))
    lengths = np.asarray([1, 100, 255], np.int32)
    kw = dict(window=64, softcap=30.0, scale=1.0 / np.sqrt(hd))
    got = ops.decode_attention(qt, kt, vt, lengths=torch.from_numpy(lengths),
                               **kw)
    want = pallas_decode(qj, kj, vj, lengths=jnp.asarray(lengths),
                         interpret=True, **kw)
    _close(got, want, "float32")


@pytest.mark.parametrize("window", [None, 1536])
def test_flash_attention_query_block_loop(window):
    """S > BLOCK_THRESHOLD runs the loop over query blocks with the K/V
    range cut to each block's causal/window support."""
    b, s, h, kv, hd = 1, ref.BLOCK_THRESHOLD + ref.Q_BLOCK, 2, 1, 8
    assert s > ref.BLOCK_THRESHOLD
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        9, "float32", (b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))
    kw = dict(causal=True, window=window, softcap=None, scale=0.35)
    _close(ref.flash_attention(qt, kt, vt, **kw),
           jref.flash_attention(qj, kj, vj, **kw), "float32")


def test_flash_attention_q_offset_matches_jax_ref():
    b, s, t, h, kv, hd = 1, 16, 48, 4, 2, 32
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        10, "float32", (b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd))
    kw = dict(causal=True, window=20, softcap=None, scale=0.2, q_offset=32)
    _close(ops.flash_attention(qt, kt, vt, **kw),
           jref.flash_attention(qj, kj, vj, **kw), "float32")


def test_cpu_dispatch_launches_no_kernel():
    fa.flash_attention.launches = 0
    da.decode_attention.launches = 0
    q = torch.randn(1, 4, 4, 32)
    k = torch.randn(1, 4, 2, 32)
    ops.flash_attention(q, k, k)
    ops.decode_attention(q[:, :1], k, k,
                         lengths=torch.tensor([3], dtype=torch.int32))
    assert fa.flash_attention.launches == 0
    assert da.decode_attention.launches == 0


@pytest.mark.parametrize("wrapper", ["flash", "decode"])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    q = torch.randn(1, 1, 4, 32)
    k = torch.randn(1, 4, 2, 32)
    with pytest.raises(ValueError, match="not CUDA"):
        if wrapper == "flash":
            fa.flash_attention(q, k, k)
        else:
            da.decode_attention(q, k, k, lengths=torch.tensor(
                [3], dtype=torch.int32))
    assert fa.flash_attention.launches == 0
    assert da.decode_attention.launches == 0
