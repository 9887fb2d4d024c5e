"""The port's plain attention (repro_torch.kernels.ref / ops on CPU tensors)
against the JAX oracles and the Pallas kernels, on the sweeps of
tests/test_kernels.py; the kernels' contracts that the CPU can check (the
wrappers' C calls with the library mocked, the SSD kernels' precision
model and the SSD backward's chunked algebra).  The CUDA kernels
themselves are held against the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""
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
# the dense family's shapes: head_dim 256 (gemma-7b), G = 7
# (deepseek-coder-33b's 56/8 heads), gemma2's window, softcap and 1/12
FLASH_DENSE_CASES = [  # (b, s, h, kv, hd, causal, window, cap, scale)
    (1, 96, 4, 4, 256, True, None, None, 1 / 16),
    (2, 80, 4, 2, 256, True, 32, 50.0, 1 / 16),
    (1, 100, 14, 2, 128, True, None, None, 128 ** -0.5),
    (1, 160, 8, 4, 128, True, 64, 50.0, 1 / 12),
]
DECODE_DENSE_CASES = [  # (b, t, h, kv, hd, window, cap)
    (3, 256, 4, 4, 256, None, None),
    (2, 300, 14, 2, 256, 64, 50.0),
    (3, 256, 7, 1, 128, None, None),
    (2, 384, 56, 8, 128, 100, 30.0),
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,hd,causal,window,cap,scale",
                         FLASH_DENSE_CASES)
def test_flash_attention_dense_family_matches_jax_ref(dtype, b, s, h, kv, hd,
                                                      causal, window, cap,
                                                      scale):
    """The plain flash attention (the CPU path and the card's reference)
    at head_dim 256, at G = 7, and at gemma2's window, softcap and scale."""
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        s + h + hd, dtype, (b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))
    kw = dict(causal=causal, window=window, softcap=cap, scale=scale)
    _close(ops.flash_attention(qt, kt, vt, **kw),
           jref.flash_attention(qj, kj, vj, **kw), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h,kv,hd,window,cap", DECODE_DENSE_CASES)
def test_decode_attention_dense_family_matches_jax_ref(dtype, b, t, h, kv, hd,
                                                       window, cap):
    """The plain decode attention at head_dim 256 and at G = 7, with a
    window and a softcap."""
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        t + h + hd, dtype, (b, 1, h, hd), (b, t, kv, hd), (b, t, kv, hd))
    lengths = np.random.default_rng(t + h).integers(1, t, size=(b,))
    kw = dict(window=window, softcap=cap, scale=1.0 / np.sqrt(hd))
    got = ops.decode_attention(
        qt, kt, vt, lengths=torch.from_numpy(lengths.astype(np.int32)), **kw)
    want = jref.decode_attention(
        qj, kj, vj, lengths=jnp.asarray(lengths, jnp.int32), **kw)
    _close(got, want, dtype)


def test_plain_rmsnorm_at_the_dense_widths():
    """The plain rmsnorm at gemma-7b's, gemma2's and deepseek-coder's
    d_model, and over head_dim 256 (a qk_norm), against the JAX oracle."""
    rng = np.random.default_rng(16)
    for rows, d in ((8, 3072), (4, 4608), (3, 7168), (6, 256)):
        x = rng.standard_normal((rows, d)).astype(np.float32)
        scale = (rng.standard_normal(d) * 0.1).astype(np.float32)
        got = ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale))
        want = jref.rmsnorm(jnp.asarray(x), jnp.asarray(scale))
        _close(got, want, "float32")


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


# (b, t, h, kv, hd, window, cap, shards): a cache cut into shards over its
# sequence; the lengths below leave the last shard empty for some rows,
# and the windows cross shard boundaries
DECODE_SHARD_CASES = [
    (4, 256, 8, 2, 64, None, None, 2),
    (4, 256, 8, 2, 64, 100, None, 4),
    (4, 384, 16, 8, 128, 150, 30.0, 4),
    (4, 256, 7, 1, 128, 70, None, 2),
]


@pytest.mark.parametrize("b,t,h,kv,hd,window,cap,shards", DECODE_SHARD_CASES)
def test_decode_attention_lse_over_shards_equals_the_whole(b, t, h, kv, hd,
                                                           window, cap,
                                                           shards):
    """The plain decode with its log-sum-exp on each shard of a cache split
    over its sequence (lengths relative to the shard's first position),
    merged by ``ref.merge_attention``: equal to the whole cache's plain
    decode and to JAX's oracle at 2e-5 in fp32.  A shard with no live key
    (past a row's length, or before its window) gives out 0 and lse
    -inf."""
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        11, "float32", (b, 1, h, hd), (b, t, kv, hd), (b, t, kv, hd))
    n = t // shards
    lengths = np.asarray([1, n - 3, n + 1, t][:b], np.int32)
    kw = dict(window=window, softcap=cap, scale=1.0 / np.sqrt(hd))
    whole, whole_lse = ops.decode_attention_lse(
        qt, kt, vt, lengths=torch.from_numpy(lengths), **kw)
    outs, lses = [], []
    for i in range(shards):
        sl = slice(i * n, (i + 1) * n)
        o, lse = ops.decode_attention_lse(
            qt, kt[:, sl], vt[:, sl],
            lengths=torch.from_numpy(lengths - i * n), **kw)
        assert o.shape == qt.shape and lse.shape == (b, h)
        live = (lengths > i * n) & (window is None
                                    or lengths - window < (i + 1) * n)
        for r in np.flatnonzero(~live):
            assert torch.isneginf(lse[r]).all()
            assert not o[r].any()
        assert live.any()
        outs.append(o)
        lses.append(lse[..., None])
    assert any(torch.isneginf(x).any() for x in lses)  # a row's empty shard
    merged = ref.merge_attention(outs, lses)
    _close(merged, whole, "float32")
    _close(torch.logsumexp(torch.stack(lses), 0)[..., 0], whole_lse,
           "float32")
    _close(whole, ops.decode_attention(qt, kt, vt,
                                       lengths=torch.from_numpy(lengths),
                                       **kw), "float32")
    _close(merged, jref.decode_attention(qj, kj, vj,
                                         lengths=jnp.asarray(lengths), **kw),
           "float32")


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


def test_no_grad_guard_refuses_to_detach():
    """build.check_no_grad: under grad mode an input that requires grad
    raises (a kernel's output would be cut from the graph); under
    no_grad, or with no such input, it passes."""
    from repro_torch.kernels import build
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="detached"):
        build.check_no_grad("k", torch.zeros(2), None, x)
    build.check_no_grad("k", torch.zeros(2), None, x.detach())
    with torch.no_grad():
        build.check_no_grad("k", x)
    with torch.inference_mode():
        build.check_no_grad("k", torch.zeros(2))


@pytest.mark.parametrize("wrapper", ["decode", "ssd", "ssd_bwd", "flash",
                                     "rmsnorm"])
def test_kernel_wrappers_refuse_autograd_inputs(wrapper):
    """The guard runs before any other check, so it shows on the CPU too:
    no wrapper returns a result detached from inputs that require grad."""
    from repro_torch.kernels import mamba_chunk_scan as mcs
    from repro_torch.kernels import rmsnorm as rn
    q = torch.randn(1, 1, 4, 32, requires_grad=True)
    k = torch.randn(1, 4, 2, 32)
    with pytest.raises(RuntimeError, match="detached"):
        if wrapper == "decode":
            da.decode_attention(q, k, k, lengths=torch.tensor(
                [3], dtype=torch.int32))
        elif wrapper == "ssd":
            mcs.mamba_chunk_scan(q[0], q[0, :, :, 0], torch.zeros(4),
                                 q[0, :, 0], q[0, :, 0], torch.zeros(4))
        elif wrapper == "ssd_bwd":
            mcs.mamba_chunk_scan_bwd(q[0], q[0, :, :, 0], torch.zeros(4),
                                     q[0, :, 0], q[0, :, 0], torch.zeros(4),
                                     q[0], None)
        elif wrapper == "flash":
            fa.flash_attention(q, k, k)
        else:
            rn.rmsnorm_fwd(q, torch.zeros(32))


def test_flash_backward_passes_q_offset_where_signatures_declare():
    """The wrapper's call of the C entry point, with the library and the
    CUDA checks mocked out: one argument per declared argtype, q_offset an
    int just before the stream, where ``build.SIGNATURES`` declares it."""
    import ctypes
    from unittest import mock

    from repro_torch.kernels import build
    calls = []

    def entry(name, symbol=None):
        return lambda *args: calls.append((name, args)) or 0

    stream = mock.Mock(cuda_stream=7)
    b, s, t, h, kv, hd = 1, 8, 24, 4, 2, 32
    q, o, do = (torch.zeros(b, s, h, hd) for _ in range(3))
    k, v = (torch.zeros(b, t, kv, hd) for _ in range(2))
    lse = torch.zeros(b, h, s)
    with mock.patch.object(build, "entry", entry), \
            mock.patch.object(build, "check_operand"), \
            mock.patch.object(torch.cuda, "current_stream",
                              return_value=stream):
        fa.flash_attention_bwd(q, k, v, o, lse, do, q_offset=16, window=12)
    ((name, args),) = calls
    sig = build.SIGNATURES[name][name]
    assert name == "flash_attention_bwd" and len(args) == len(sig)
    assert sig[-2] is ctypes.c_int and args[-2] == 16
    assert sig[-1] is ctypes.c_void_p and args[-1] == 7
    assert args[11:18] == (b, s, t, h, kv, hd, 1)  # B .. HD, causal
    assert args[18] == 12                            # window


# ---------------------------------------------------------------------------
# flash: query rows with no live key are refused
# ---------------------------------------------------------------------------

def test_launch_counters_exact_under_concurrent_callers():
    """Four threads launch at once, as a task runtime's executors do: the
    wrappers' counters (``launches``, and rmsnorm's by (rows, d)) lose no
    count.  The library and the CUDA checks are mocked out.  A counter
    whose reads give up the GIL (as a thread switch between the read and
    the write of ``+= 1`` would) shows that ``build.count_launch``
    updates under its lock."""
    import collections
    import threading
    import time
    from unittest import mock

    from repro_torch.kernels import build
    from repro_torch.kernels import rmsnorm as rn

    class Yielding:
        """launches and shapes whose reads sleep(0) before returning."""
        def __init__(self):
            self._n = 0
            self.shapes = YieldingCounter()

        @property
        def launches(self):
            n = self._n
            time.sleep(0)
            return n

        @launches.setter
        def launches(self, n):
            self._n = n

    class YieldingCounter(collections.Counter):
        def __getitem__(self, key):
            n = super().__getitem__(key)
            time.sleep(0)
            return n

    n_threads, n_calls, n_bumps = 4, 50, 300
    stream = mock.Mock(cuda_stream=7)
    x, scale = torch.zeros(6, 64), torch.zeros(64)
    yielding = Yielding()
    rn.rmsnorm_fwd.launches = 0
    rn.rmsnorm_fwd.shapes.clear()
    barrier = threading.Barrier(n_threads)

    def work():
        barrier.wait()
        for _ in range(n_calls):
            rn.rmsnorm_fwd(x, scale, with_rstd=False)
        for _ in range(n_bumps):
            build.count_launch(yielding, (1, 2))

    with mock.patch.object(build, "entry",
                           lambda name, symbol=None: lambda *a: 0), \
            mock.patch.object(build, "check_operand"), \
            mock.patch.object(torch.cuda, "current_stream",
                              return_value=stream):
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert rn.rmsnorm_fwd.launches == n_threads * n_calls
    assert rn.rmsnorm_fwd.shapes == {(6, 64): n_threads * n_calls}
    assert yielding.launches == n_threads * n_bumps
    assert yielding.shapes == {(1, 2): n_threads * n_bumps}
    rn.rmsnorm_fwd.launches = 0
    rn.rmsnorm_fwd.shapes.clear()


@pytest.mark.parametrize("causal", [True, False])
def test_rows_without_keys_matches_the_jax_mask(causal):
    """``rows_without_keys`` is true exactly when some row of the JAX
    oracle's mask (query positions from q_offset) has no True."""
    seen = set()
    for s in (1, 5, 64):
        for t in (1, 7, 64, 130):
            for q_offset in (0, 3, 60, 129, 200):
                for window in (None, 0, 1, 8, 100):
                    m = np.asarray(jref._mask(s, t, causal=causal,
                                              window=window,
                                              q_pos0=q_offset))
                    want = bool((~m.any(axis=1)).any())
                    assert fa.rows_without_keys(s, t, q_offset, window) \
                        == want, (s, t, q_offset, window)
                    seen.add(want)
    assert seen == {True, False}


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_flash_wrappers_refuse_rows_without_keys(direction):
    """Both wrappers raise before any launch on an input with an empty
    row (the CUDA operand checks and the library mocked out), and take
    the neighbouring input whose last row keeps one key."""
    from unittest import mock

    from repro_torch.kernels import build
    calls = []

    def entry(name, symbol=None):
        return lambda *args: calls.append(name) or 0

    b, s, t, h, kv, hd, window = 1, 8, 24, 4, 2, 32, 12
    q, o, do = (torch.zeros(b, s, h, hd) for _ in range(3))
    k, v = (torch.zeros(b, t, kv, hd) for _ in range(2))
    lse = torch.zeros(b, h, s)
    stream = mock.Mock(cuda_stream=7)

    def run(q_offset):
        kw = dict(window=window, q_offset=q_offset)
        if direction == "fwd":
            fa.flash_attention_fwd(q, k, v, **kw)
        else:
            fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)

    with mock.patch.object(build, "entry", entry), \
            mock.patch.object(build, "check_operand"), \
            mock.patch.object(torch.cuda, "current_stream",
                              return_value=stream):
        with pytest.raises(ValueError, match="no live key"):
            run(t + window - s)          # last row at T + window - 1
        assert calls == []
        run(t + window - s - 1)          # last row keeps key T - 1
    assert len(calls) == 1


# ---------------------------------------------------------------------------
# decode: how many ranges the cache is split into
# ---------------------------------------------------------------------------

def test_decode_n_splits_from_shapes():
    """CTAS_PER_SM CTAs a SM over (split, kv, batch), at least
    MIN_SPLIT_LEN positions a split, at most MAX_SPLITS; the slices'
    shapes."""
    assert da.n_splits(8, 8, 1024) == 4      # llama3.2-1b: 256 CTAs
    assert da.n_splits(8, 32, 1024) == 4     # zamba2-2.7b: 1024 CTAs
    assert da.n_splits(64, 8, 1024) == 3
    assert da.n_splits(256, 8, 4096) == 1
    assert da.n_splits(8, 8, 100) == 1       # one short range
    for n in range(1, da.MAX_SPLITS + 1):
        assert da.n_splits(1, 1, n * da.MIN_SPLIT_LEN) == n
    assert da.n_splits(1, 1, 10**6) == da.MAX_SPLITS
    assert da.n_splits(1, 1, 10**6, sms=1) == da.CTAS_PER_SM


def test_decode_wrapper_passes_splits_where_signatures_declare():
    """The wrapper's call of the C entry point, with the library, the CUDA
    checks and the SM count mocked out: n_split from ``n_splits`` just
    before the stream, and fp32 scratch for the partials (m, l, acc) of
    every split, or null with one split."""
    import ctypes
    from unittest import mock

    from repro_torch.kernels import build
    calls = []

    def entry(name, symbol=None):
        return lambda *args: calls.append(args) or 0

    stream = mock.Mock(cuda_stream=7)
    for b, t, h, kv, hd in ((8, 1024, 32, 8, 64), (64, 256, 32, 8, 64)):
        q = torch.zeros(b, 1, h, hd)
        k = torch.zeros(b, t, kv, hd)
        lengths = torch.ones(b, dtype=torch.int32)
        part = mock.Mock(return_value=torch.empty(0))
        with mock.patch.object(build, "entry", entry), \
                mock.patch.object(build, "check_operand"), \
                mock.patch.object(da, "_sm_count", return_value=132), \
                mock.patch.object(torch.cuda, "current_stream",
                                  return_value=stream), \
                mock.patch.object(torch, "empty", part):
            da.decode_attention(q, k, k, lengths=lengths)
        args = calls.pop()
        sig = build.SIGNATURES[da.NAME][da.NAME + "_fwd"]
        n = da.n_splits(b, kv, t, 132)
        assert len(args) == len(sig) and sig[-2] is ctypes.c_int
        assert args[-2] == n and args[-1] == 7
        assert args[6] is None  # the lse pointer: none asked for
        if n > 1:
            part.assert_called_once()
            assert part.call_args.args == (n * b * h * (hd + 2),)
            assert args[5] is not None
        else:
            part.assert_not_called()
            assert args[5] is None


def test_decode_wrapper_passes_lse_when_asked():
    """With ``with_lse`` the wrapper hands the C entry point a (B, H) fp32
    array for the log-sum-exps (null otherwise) and returns it beside the
    output; one launch either way."""
    from unittest import mock

    from repro_torch.kernels import build
    calls = []
    stream = mock.Mock(cuda_stream=7)
    b, t, h, kv, hd = 3, 512, 8, 2, 64
    q, k = torch.zeros(b, 1, h, hd), torch.zeros(b, t, kv, hd)
    with mock.patch.object(build, "entry",
                           lambda *a: lambda *args: calls.append(args) or 0), \
            mock.patch.object(build, "check_operand"), \
            mock.patch.object(da, "_sm_count", return_value=132), \
            mock.patch.object(torch.cuda, "current_stream",
                              return_value=stream):
        n = da.decode_attention.launches
        out, lse = da.decode_attention(q, k, k, lengths=torch.ones(
            b, dtype=torch.int32), with_lse=True)
        assert da.decode_attention.launches == n + 1
    (args,) = calls
    assert out.shape == q.shape and out.dtype == q.dtype
    assert lse.shape == (b, h) and lse.dtype == torch.float32
    assert args[6] == lse.data_ptr() and args[4] == out.data_ptr()
    da.decode_attention.launches = 0


@pytest.mark.parametrize("hd,g", [(hd, g) for hd in (32, 64, 80, 128, 256)
                                  for g in (1, 2, 4, 6, 7, 8, 16)])
def test_decode_wrapper_refuses_pairs_not_built(hd, g):
    """The wrapper (with the library and the CUDA checks mocked out)
    launches every (head_dim, G) pair the kernel is built for, G = 7
    among them, and refuses the one it is not, (256, 16), before any
    launch, with a ValueError that names it."""
    from unittest import mock

    from repro_torch.kernels import build
    calls = []
    stream = mock.Mock(cuda_stream=7)
    q = torch.zeros(2, 1, 2 * g, hd)
    k = torch.zeros(2, 64, 2, hd)
    with mock.patch.object(build, "entry",
                           lambda *a: lambda *args: calls.append(args) or 0), \
            mock.patch.object(build, "check_operand"), \
            mock.patch.object(da, "_sm_count", return_value=132), \
            mock.patch.object(torch.cuda, "current_stream",
                              return_value=stream):
        n = da.decode_attention.launches
        if (hd, g) == (256, 16):
            assert not da.instantiated(hd, g)
            with pytest.raises(ValueError, match="head_dim 256 with group "
                                                 "size 16"):
                da.decode_attention(q, k, k, lengths=torch.ones(
                    2, dtype=torch.int32))
            assert not calls and da.decode_attention.launches == n
        else:
            assert da.instantiated(hd, g)
            da.decode_attention(q, k, k, lengths=torch.ones(
                2, dtype=torch.int32))
            (args,) = calls
            # after q, k, v, lengths, o, partials, lse, dtype, B, T
            assert args[10:13] == (2 * g, 2, hd)   # H, KV, HD
            assert args[6] is None                 # no lse asked for
            assert da.decode_attention.launches == n + 1
    da.decode_attention.launches = 0


@pytest.mark.parametrize("hd", [128, 256])
def test_flash_wrappers_take_head_dim_256_forward_and_backward(hd):
    """head_dim 256 reaches both kernels: the forward's C call and the
    backward's carry the head dim and each wrapper counts one launch
    (library and CUDA checks mocked)."""
    from unittest import mock

    from repro_torch.kernels import build
    calls = []
    stream = mock.Mock(cuda_stream=7)
    q = torch.zeros(1, 64, 4, hd)
    k = torch.zeros(1, 64, 2, hd)
    lse = torch.zeros(1, 4, 64)
    with mock.patch.object(build, "entry",
                           lambda *a: lambda *args: calls.append(args) or 0), \
            mock.patch.object(build, "check_operand"), \
            mock.patch.object(torch.cuda, "current_stream",
                              return_value=stream):
        fa.flash_attention.shapes.clear()
        fa.flash_attention(q, k, k)
        assert calls.pop()[11] == hd
        # the forward's launches by (b, s, t, h, kv, hd, causal, window)
        assert fa.flash_attention.shapes == {
            (1, 64, 64, 4, 2, hd, True, 0): 1}
        fa.flash_attention(q, k, k, causal=False)
        fa.flash_attention(q, k, k, window=16)
        calls.clear()
        assert fa.flash_attention.shapes == {
            (1, 64, 64, 4, 2, hd, True, 0): 1,
            (1, 64, 64, 4, 2, hd, False, 0): 1,
            (1, 64, 64, 4, 2, hd, True, 16): 1}
        n = fa.flash_attention_bwd.launches
        fa.flash_attention_bwd.shapes.clear()
        fa.flash_attention_bwd(q, k, k, q, lse, q)
        assert calls.pop()[16] == hd
        assert not calls and fa.flash_attention_bwd.launches == n + 1
        # the backward's by (b, s, t, h, kv, hd, causal, window)
        assert fa.flash_attention_bwd.shapes == {
            (1, 64, 64, 4, 2, hd, True, 0): 1}
    fa.flash_attention.launches = 0
    fa.flash_attention_bwd.launches = 0
    fa.flash_attention.shapes.clear()
    fa.flash_attention_bwd.shapes.clear()


# ---------------------------------------------------------------------------
# rmsnorm: the launch shapes the host picks, and the wrapper's C call
# ---------------------------------------------------------------------------

# (rows, d): the slices' serving and training shapes, the sweep shapes of
# tests/test_kernels.py as rows x d, and d off the vector or small
RMS_PLAN_SHAPES = [
    (8192, 2048), (512, 2048), (8, 2048),      # llama: training, prefill, step
    (512, 2560), (8, 2560), (512, 5120), (8, 5120),   # zamba2, 2 d gated
    (1024, 2560),                             # packed past FEW_ELEMS
    (4 * 37, 256), (2, 128), (8 * 8, 512),    # (4, 37, 256), (2, 128), ...
    (3, 100), (1, 64),
]


def test_rmsnorm_instances_reach_nvcc(tmp_path):
    """``NPTS`` and ``BUDGET`` reach csrc/rmsnorm.cu as macros of a header
    nvcc includes first (and in the library's hash), and the source keeps
    no list of its own."""
    from pathlib import Path
    from unittest import mock

    from repro_torch.kernels import build
    from repro_torch.kernels import rmsnorm as rn
    assert rn.NVCC_DEFINES == {"RMS_NPTS": "1,2,3,4,5,6,8",
                               "RMS_BUDGET": "8,1024,16,512,64,256"}
    assert build.defines(rn.NAME) == rn.NVCC_DEFINES
    assert build.defines("flash_attention_bwd") == {}
    with mock.patch.object(build, "BUILD_DIR", tmp_path), \
            mock.patch.object(build, "nvcc", return_value="nvcc"), \
            mock.patch.object(build.subprocess, "Popen") as popen:
        out, _ = build._start(rn.NAME)
        (cmd,), _ = popen.call_args
        n = len(build.NVCC_FLAGS)
        assert cmd[:n + 3] == ["nvcc", *build.NVCC_FLAGS, "--pre-include",
                               str(out.with_suffix(".h"))]
        assert out.with_suffix(".h").read_text() == (
            "#define RMS_NPTS 1,2,3,4,5,6,8\n"
            "#define RMS_BUDGET 8,1024,16,512,64,256\n")
        build._start("flash_attention_bwd")
        (cmd,), _ = popen.call_args
        assert "--pre-include" not in cmd
        with mock.patch.object(rn, "NVCC_DEFINES", {"RMS_NPTS": "1"}):
            assert build.library_path(rn.NAME) != out
    src = (Path(rn.__file__).parent / "csrc" / "rmsnorm.cu").read_text()
    assert "NptList<RMS_NPTS>" in src and "budget<RMS_BUDGET>" in src
    assert [rn.max_threads(e) for e in (1, 8, 9, 16, 17, 64, 65)] == [
        1024, 1024, 512, 512, 256, 256, 0]


@pytest.mark.parametrize("rows,d", RMS_PLAN_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("aligned", [True, False])
def test_rmsnorm_launch_shape_covers_every_row_once(rows, d, dtype, backward,
                                                    aligned):
    """Walking the CTAs as csrc/rmsnorm.cu does reaches every row exactly
    once, and each row's threads hold every load of it exactly once, with
    a compiled instance, whole warps a CTA and the register budget kept."""
    from collections import Counter

    from repro_torch.kernels import rmsnorm as rn
    p = rn.launch_shape(rows, d, TDT[dtype], backward=backward,
                        aligned=aligned)
    step = 16 // TDT[dtype].itemsize
    assert p.vec == (step if aligned and d % step == 0 else 1)
    assert p.npt in rn.NPTS and p.tpr in rn.TPRS
    assert p.threads % 32 == 0 and p.threads % p.tpr == 0
    assert p.threads <= rn.max_threads(p.npt * p.vec)
    group = p.threads // p.tpr
    seen = Counter()
    for b in range(p.grid):
        r0 = b * p.rows_per_cta
        r1 = min(rows, r0 + p.rows_per_cta)
        for base in range(r0, r0 + p.rows_per_cta, group):
            seen.update(r for r in range(base, base + group) if r < r1)
    assert seen == Counter(range(rows))
    nv = d // p.vec
    loads = Counter(li + j * p.tpr for li in range(p.tpr)
                    for j in range(p.npt) if li + j * p.tpr < nv)
    assert loads == Counter(range(nv))


def test_rmsnorm_launch_shape_at_the_slices():
    """At the slices' widths (bf16, 8 elements a load): up to FEW_ELEMS
    elements (a decode step's 8 rows, the prefills) each row gets a CTA
    whose threads hold two loads each; beyond (the training step, the
    gated norm's longest prefills) packed rows hold the same number of
    loads in every thread."""
    from repro_torch.kernels import rmsnorm as rn
    bf16 = torch.bfloat16
    for d in (2048, 2560, 5120):
        for rows in (8, 512):
            p = rn.launch_shape(rows, d, bf16)
            if rows * d <= rn.FEW_ELEMS:
                assert (p.vec, p.npt, p.tpr, p.threads, p.rows_per_cta,
                        p.grid) == (8, 2, d // 16, d // 16, 1, rows)
        for rows, backward in ((512, False), (8192, False), (8192, True)):
            p = rn.launch_shape(rows, d, bf16, backward=backward)
            assert p.vec == 8 and p.tpr * p.npt * p.vec == d
            if backward or rows * d > rn.FEW_ELEMS:
                assert p.npt <= (rn.BWD_MOST if backward else rn.FWD_MOST)
                assert p.npt > rn.SPREAD_LOADS or backward
    assert [rn.launch_shape(512, d, bf16).npt for d in (2048, 2560, 5120)] \
        == [2, 2, 5]


@pytest.mark.parametrize("rows,d", RMS_PLAN_SHAPES)
def test_rmsnorm_backward_partition_depends_on_rows_only(rows, d):
    """The backward's CTAs, their rows and so the scratch's n_part (the
    order of dscale's sums) are the same for every dtype and alignment of
    one (rows, d), and at most BWD_CTAS."""
    from repro_torch.kernels import rmsnorm as rn
    parts = {(p.rows_per_cta, p.grid) for p in (
        rn.launch_shape(rows, d, dt, backward=True, aligned=al)
        for dt in (torch.float32, torch.bfloat16) for al in (True, False))}
    ((per, n_part),) = parts
    assert n_part <= rn.BWD_CTAS and (n_part - 1) * per < rows <= \
        n_part * per


def test_rmsnorm_wrappers_pass_rstd_where_signatures_declare():
    """The wrappers' calls of the C entry points, with the library and the
    CUDA checks mocked out: one argument per declared argtype, the launch
    shape of ``launch_shape`` just before the stream; the serving path
    (no grad) passes a null rstd and allocates none, the autograd path a
    real one, which its backward gets; each launch is counted, in all and
    by (rows, d).  ``ops`` dispatches a meta tensor as it does a CUDA
    one."""
    from unittest import mock

    from repro_torch.kernels import build
    from repro_torch.kernels import rmsnorm as rn
    calls = []

    def entry(name, symbol=None):
        return lambda *args: calls.append((symbol, args)) or 0

    stream = mock.Mock(cuda_stream=7)
    sig = build.SIGNATURES[rn.NAME]
    rows, d = 6, 64
    rn.rmsnorm_fwd.shapes.clear()
    rn.rmsnorm_bwd.shapes.clear()
    fwd0, bwd0 = rn.rmsnorm_fwd.launches, rn.rmsnorm_bwd.launches
    with mock.patch.object(build, "entry", entry), \
            mock.patch.object(build, "check_operand"), \
            mock.patch.object(torch.cuda, "current_stream",
                              return_value=stream):
        x, scale = torch.zeros(2, 3, d), torch.zeros(d)
        y, rstd = rn.rmsnorm_fwd(x, scale, with_rstd=False)
        assert rstd is None and y.shape == x.shape
        y, rstd = rn.rmsnorm_fwd(x, scale)
        assert rstd.shape == (2, 3) and rstd.dtype == torch.float32
        (s0, a0), (s1, a1) = calls
        plan = tuple(rn.launch_shape(rows, d, torch.float32))
        for s, a in calls:
            assert s == "rmsnorm_fwd" and len(a) == len(sig[s])
            assert a[-7:] == (*plan, 7) and a[4:9] == (0, rows, d, 1e-6, 1)
        assert a0[3] is None and a1[3] == rstd.data_ptr() != 0
        calls.clear()

        xm = torch.zeros(rows, d, device="meta")
        sm = torch.zeros(d, device="meta").requires_grad_()
        with torch.no_grad():
            ops.rmsnorm(xm, sm)
        assert calls.pop()[1][3] is None
        xg = xm.clone().requires_grad_()
        out = ops.rmsnorm(xg, sm)
        assert calls.pop()[1][3] is not None
        torch.autograd.grad(out, (xg, sm), torch.zeros_like(out))
        ((s, a),) = calls
        assert s == "rmsnorm_bwd" and len(a) == len(sig[s])
        assert a[2] is not None and a[-7:] == (
            *rn.launch_shape(rows, d, torch.float32, backward=True), 7)
    # each launch counted once, and once by its (rows, d)
    assert (rn.rmsnorm_fwd.launches - fwd0, rn.rmsnorm_bwd.launches - bwd0) \
        == (4, 1)
    assert rn.rmsnorm_fwd.shapes == {(rows, d): 4}
    assert rn.rmsnorm_bwd.shapes == {(rows, d): 1}


# ---------------------------------------------------------------------------
# the SSD kernel's precision contract
# ---------------------------------------------------------------------------

def _bf16(t):
    return t.to(torch.bfloat16).float()


def _terms3(t):
    """``t`` as the sum of its three bf16 terms hi + mid + lo, the way the
    tensor-core kernel feeds an fp32 operand to wgmma."""
    hi = _bf16(t)
    mid = _bf16(t - hi)
    return hi + mid + _bf16(t - hi - mid)


def _ssd_emulated(x, dt, a, b, c, d, h0, *, w_op, dx_op, h_op):
    """Plain-torch emulation of csrc/mamba_chunk_scan.cu's bf16 kernel:
    chunks of 64 rows, W^T and the decay formed in fp32, the state kept in
    fp32, and the fp32 operands of the products W x, (decay x)^T B and
    C H^T as ``w_op``, ``dx_op`` and ``h_op`` make them; sums in fp32."""
    xf, bf, cf, dtf = x.float(), b.float(), c.float(), dt.float()
    h = h0.float().clone()
    ys = []
    for t0 in range(0, x.shape[1], 64):
        xs, bs, cs, dts = (u[:, t0:t0 + 64] for u in (xf, bf, cf, dtf))
        n = xs.shape[1]
        f = torch.cumsum(dts * a, dim=1)                        # (B,n,NH)
        tri = torch.tril(torch.ones(n, n, dtype=torch.bool))[None, :, :,
                                                                 None]
        gap = torch.where(tri, f[:, :, None] - f[:, None], 0.0)
        w = torch.where(tri, torch.exp(gap), 0.0) \
            * torch.einsum("btn,bun->btu", cs, bs)[..., None] \
            * dts[:, None]                                      # (B,t,u,NH)
        y = torch.einsum("btuh,buhd->bthd", w_op(w), xs)
        y = y + torch.exp(f)[..., None] * torch.einsum(
            "bhdn,btn->bthd", h_op(h), cs)
        ys.append(y + d[None, None, :, None] * xs)
        dx = (torch.exp(f[:, -1:] - f) * dts)[..., None] * xs
        h = torch.exp(f[:, -1])[..., None, None] * h + torch.einsum(
            "buhd,bun->bhdn", dx_op(dx), bs)
    return torch.cat(ys, dim=1), h


@pytest.mark.parametrize("rounding,within", [
    ("kernel", True),          # W, decay x and H each as three bf16 terms
    ("state_bf16", False),     # ... but H rounded to one bf16 term
    ("one_term", False),       # W and decay x rounded to one bf16 term
])
def test_ssd_precision_model_against_jax(rounding, within):
    """The bf16 kernel's roundings, emulated in plain torch, against the
    JAX sequential oracle at (1, 512, 4, 64, 64) with h0 on bf16 inputs:
    y (bf16) and h_final within the rel. L2 limit the card holds the
    kernel to.  Rounding the state, or W and decay x, to one bf16 term
    each lands past it, which is why the kernel splits them."""
    from repro_torch.kernels import mamba_chunk_scan as mcs
    b, s, nh, hd, ns = 1, 512, 4, 64, 64
    rng = np.random.default_rng(17)
    f32 = np.float32
    x, bm, cm = (rng.standard_normal(sh).astype(f32) for sh in
                 ((b, s, nh, hd), (b, s, ns), (b, s, ns)))
    dt = (np.abs(rng.standard_normal((b, s, nh))) * 0.1 + 0.01).astype(f32)
    a = -(np.abs(rng.standard_normal(nh)) + 0.1).astype(f32)
    d = rng.standard_normal(nh).astype(f32)
    h0 = rng.standard_normal((b, nh, hd, ns)).astype(f32)
    bf = jnp.bfloat16
    want_y, want_h = jref.mamba_chunk_scan(
        jnp.asarray(x, bf), jnp.asarray(dt), jnp.asarray(a),
        jnp.asarray(bm, bf), jnp.asarray(cm, bf), jnp.asarray(d),
        h0=jnp.asarray(h0))
    t = {k: torch.from_numpy(v) for k, v in
         dict(x=x, dt=dt, a=a, b=bm, c=cm, d=d, h0=h0).items()}
    for k in ("x", "b", "c"):
        t[k] = _bf16(t[k])
    ops_of = {"kernel": (_terms3, _terms3, _terms3),
              "state_bf16": (_terms3, _terms3, _bf16),
              "one_term": (_bf16, _bf16, _terms3)}[rounding]
    y, h = _ssd_emulated(t["x"], t["dt"], t["a"], t["b"], t["c"], t["d"],
                         t["h0"], w_op=ops_of[0], dx_op=ops_of[1],
                         h_op=ops_of[2])
    wy = torch.from_numpy(np.array(want_y, f32))
    wh = torch.from_numpy(np.array(want_h, f32))
    rel_y = float((_bf16(y) - wy).norm() / wy.norm())
    rel_h = float((h - wh).norm() / wh.norm())
    worst = max(rel_y, rel_h)
    assert (worst <= mcs.SSD_REL_L2_BF16) == within, (rel_y, rel_h)


# ---------------------------------------------------------------------------
# the SSD backward kernel's chunked form
# ---------------------------------------------------------------------------

def _ssd_bwd_chunked(x, dt, a, b, c, d, dy, dhf, h0, q):
    """Plain-torch emulation of csrc/mamba_chunk_scan_bwd.cu's algorithm
    (its header's formulas), per (batch, head): a forward pass for the
    state entering each chunk of ``q`` rows, then the chunks in reverse
    carrying dH; db and dc as per-head partials summed over heads."""
    bs, s, nh, hd = x.shape
    ns = b.shape[-1]
    pad = -s % q
    p = lambda t: torch.cat([t, t.new_zeros(  # noqa: E731
        (t.shape[0], pad, *t.shape[2:]))], 1)
    x, dt, b, c, dy = map(p, (x, dt, b, c, dy))
    nc = x.shape[1] // q
    dx, ddt = torch.zeros_like(x), torch.zeros_like(dt)
    db, dc = torch.zeros_like(b), torch.zeros_like(c)
    da, dd = torch.zeros_like(a), torch.zeros_like(a)
    dh0 = torch.zeros(bs, nh, hd, ns, dtype=x.dtype)
    tri = torch.tril(torch.ones(q, q, dtype=torch.bool))
    for bi in range(bs):
        for h in range(nh):
            def chunk(k):
                sl = slice(k * q, k * q + q)
                cx, cdt = x[bi, sl, h], dt[bi, sl, h]
                f = torch.cumsum(cdt * a[h], 0)
                return (sl, cx, cdt, b[bi, sl], c[bi, sl], dy[bi, sl, h], f,
                        cdt * torch.exp(f[-1] - f))
            hs = [torch.zeros(hd, ns, dtype=x.dtype) if h0 is None
                  else h0[bi, h]]
            for k in range(nc - 1):
                _, cx, _, cb, _, _, f, dec = chunk(k)
                hs.append(torch.exp(f[-1]) * hs[-1] + (dec[:, None] * cx).T
                          @ cb)
            dh = dhf[bi, h].clone()
            for k in reversed(range(nc)):
                sl, cx, cdt, cb, cc, cdy, f, dec = chunk(k)
                e = torch.where(tri, torch.exp(f[:, None] - f[None]), 0.0)
                sm, pm = cc @ cb.T, cdy @ cx.T
                w, pd, tm = sm * e * cdt, pm * e * cdt, sm * e * pm
                bdh = cb @ dh.T
                qv = (cx * bdh).sum(1)
                dx[bi, sl, h] = dec[:, None] * bdh + w.T @ cdy + d[h] * cdy
                db[bi, sl] += dec[:, None] * (cx @ dh) + pd.T @ cc
                dyh = cdy @ hs[k]
                dc[bi, sl] += torch.exp(f)[:, None] * dyh + pd @ cb
                col = tm.sum(0)
                df = (torch.exp(f) * (dyh * cc).sum(1) + (tm * cdt).sum(1)
                      - cdt * col - dec * qv)
                df[-1] += (torch.exp(f[-1]) * (dh * hs[k]).sum()
                           + (dec * qv).sum())
                dl = torch.flip(torch.cumsum(torch.flip(df, [0]), 0), [0])
                ddt[bi, sl, h] = a[h] * dl + col + torch.exp(f[-1] - f) * qv
                da[h] += (cdt * dl).sum()
                dd[h] += (cdy * cx).sum()
                dh = torch.exp(f[-1]) * dh + (torch.exp(f)[:, None] * cdy).T \
                    @ cc
            dh0[bi, h] = dh
    return (dx[:, :s], ddt[:, :s], da, db[:, :s], dc[:, :s], dd, dh0)


@pytest.mark.parametrize("q", [32, 64])
@pytest.mark.parametrize("s", [20, 64, 150])   # ragged, one chunk, several
def test_ssd_bwd_chunked_form_matches_plain(q, s):
    """The backward kernel's chunked algebra, in float64, against the
    plain reverse recurrence (ref.mamba_chunk_scan_bwd), to rounding."""
    gen = torch.Generator().manual_seed(s + q)
    bs, nh, hd, ns = 1, 2, 4, 3
    r = lambda *sh: torch.randn(sh, dtype=torch.float64,  # noqa: E731
                                generator=gen)
    x, b, c, d, dy = r(bs, s, nh, hd), r(bs, s, ns), r(bs, s, ns), r(nh), \
        r(bs, s, nh, hd)
    dt = torch.rand(bs, s, nh, dtype=torch.float64, generator=gen) * 0.3 \
        + 0.01
    a = -torch.rand(nh, dtype=torch.float64, generator=gen) - 0.1
    h0, dhf = r(bs, nh, hd, ns), r(bs, nh, hd, ns)
    got = _ssd_bwd_chunked(x, dt, a, b, c, d, dy, dhf, h0, q)
    want = ref.mamba_chunk_scan_bwd(x, dt, a, b, c, d, dy, dhf, h0=h0)
    for name, g, w in zip(("dx", "ddt", "da", "db", "dc", "dd", "dh0"), got,
                          want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10, msg=name)


def _ssd_bwd_segmented(x, dt, a, b, c, d, dy, dhf, h0, q, group, segment,
                       op=None):
    """Plain-torch emulation of the bf16 backward kernels of
    csrc/mamba_chunk_scan_bwd.cu: chunks of ``q`` rows in segments of
    ``segment`` chunks; each segment's two walks from zero (P and T, Q
    and U), the scans over segments, each chunk's H_in and dH from its
    segment's boundary state; then the chunk-local pass with S = C B^T
    once a chunk, db and dc summed over each group of ``group`` heads in
    head order, then over groups.  ``op`` maps an fp32 operand of a
    product (wt, pdt, pd: W^T, Pd^T, Pd; dh, hin: the states; decx, efdy:
    the walks' dec x and exp(F) dy) to its rounding; the rest is exact in
    the inputs' dtype."""
    op = op or {}
    r = lambda k, t: op.get(k, lambda u: u)(t)  # noqa: E731
    bs, s, nh, hd = x.shape
    ns = b.shape[-1]
    pad = -s % q
    p = lambda t: torch.cat([t, t.new_zeros(  # noqa: E731
        (t.shape[0], pad, *t.shape[2:]))], 1)
    x, dt, b, c, dy = map(p, (x, dt, b, c, dy))
    nc = x.shape[1] // q
    xc, dyc = (t.reshape(bs, nc, q, nh, hd) for t in (x, dy))
    dtc = dt.reshape(bs, nc, q, nh)
    bc, cc = (t.reshape(bs, nc, q, ns) for t in (b, c))
    f = torch.cumsum(dtc * a, 2)
    fq = f[:, :, -1:]
    dec, ef, efq = dtc * torch.exp(fq - f), torch.exp(f), torch.exp(fq[:, :, 0])
    hloc = torch.einsum("zcthd,zctn->zchdn", r("decx", dec[..., None] * xc),
                        bc)
    gloc = torch.einsum("zcthd,zctn->zchdn", r("efdy", ef[..., None] * dyc),
                        cc)
    zero = x.new_zeros(bs, nh, hd, ns)
    hin, dh = [None] * nc, [None] * nc
    segs = [range(k0, min(nc, k0 + segment)) for k0 in range(0, nc, segment)]
    tot_h, tot_g = [], []
    for seg in segs:  # the walks inside each segment, from zero
        run = zero
        for ci in seg:
            hin[ci] = run
            run = efq[:, ci, :, None, None] * run + hloc[:, ci]
        tot_h.append(run)
        run = zero
        for ci in reversed(seg):
            dh[ci] = run
            run = efq[:, ci, :, None, None] * run + gloc[:, ci]
        tot_g.append(run)
    dseg = [torch.exp(fq[:, list(seg), 0].sum(1)) for seg in segs]
    cur = zero if h0 is None else h0
    for k, seg in enumerate(segs):  # the scans over segments
        for ci in seg:
            pre = torch.exp(fq[:, seg[0]:ci, 0].sum(1))
            hin[ci] = pre[..., None, None] * cur + hin[ci]
        cur = dseg[k][..., None, None] * cur + tot_h[k]
    cur = zero if dhf is None else dhf
    for k in reversed(range(len(segs))):
        for ci in segs[k]:
            post = torch.exp(fq[:, ci + 1:segs[k][-1] + 1, 0].sum(1))
            dh[ci] = post[..., None, None] * cur + dh[ci]
        cur = dseg[k][..., None, None] * cur + tot_g[k]
    hin, dh = torch.stack(hin, 1), torch.stack(dh, 1)
    tri = torch.tril(torch.ones(q, q, dtype=torch.bool))[:, :, None]
    e = torch.where(tri, torch.exp(f[:, :, :, None] - f[:, :, None]), 0.0)
    sm = torch.einsum("zcsn,zcun->zcsu", cc, bc)           # once a chunk
    pm = torch.einsum("zcshd,zcuhd->zcsuh", dyc, xc)
    dtu = dtc[:, :, None]
    w, pd, tm = sm[..., None] * e * dtu, pm * e * dtu, sm[..., None] * e * pm
    bdh = torch.einsum("zcun,zchdn->zcuhd", bc, r("dh", dh))
    qv = (xc * bdh).sum(-1)
    dx = (dec[..., None] * bdh + d[:, None] * dyc
          + torch.einsum("zcsuh,zcshd->zcuhd", r("wt", w), dyc))
    dbh = (dec[..., None] * torch.einsum("zcthd,zchdn->zcthn", xc,
                                         r("dh", dh))
           + torch.einsum("zcsuh,zcsn->zcuhn", r("pdt", pd), cc))
    dyh = torch.einsum("zcshd,zchdn->zcshn", dyc, r("hin", hin))
    dch = (ef[..., None] * dyh
           + torch.einsum("zcsuh,zcun->zcshn", r("pd", pd), bc))

    def hsum(t):  # heads in order within a group, then groups in order
        out = 0
        for g0 in range(0, nh, group):
            acc = t[:, :, :, g0]
            for h in range(g0 + 1, min(nh, g0 + group)):
                acc = acc + t[:, :, :, h]
            out = out + acc
        return out
    col = tm.sum(2)
    df = (ef * (dyh * cc[:, :, :, None]).sum(-1) + (tm * dtu).sum(3)
          - dtc * col - dec * qv)
    df[:, :, -1] += efq * (dh * hin).sum((-2, -1)) + (dec * qv).sum(2)
    dl = torch.flip(torch.cumsum(torch.flip(df, [2]), 2), [2])
    ddt = a * dl + col + torch.exp(fq - f) * qv
    un = lambda t: t.reshape(bs, nc * q, *t.shape[3:])[:, :s]  # noqa: E731
    return (un(dx), un(ddt), (dtc * dl).sum(2).sum((0, 1)), un(hsum(dbh)),
            un(hsum(dch)), (dyc * xc).sum((2, 4)).sum((0, 1)),
            None if h0 is None else cur)


@pytest.mark.parametrize("q,s,group,segment", [
    (64, 150, 3, 8),    # ragged S, one segment longer than the sequence
    (64, 300, 2, 2),    # 5 chunks: segments of 2, 2, 1
    (32, 300, 1, 3),    # 10 chunks: segments of 3, 3, 3, 1
    (16, 100, 3, 1),    # one chunk a segment: the plain chunk scan
    (16, 64, 2, 4),     # whole segments
])
@pytest.mark.parametrize("with_h0", [True, False])
def test_ssd_bwd_segmented_form_matches_plain(q, s, group, segment,
                                              with_h0):
    """The bf16 backward kernels' decomposition (segments of chunks,
    boundary states, C B^T shared across heads, db and dc summed in head
    groups), in float64, against the plain reverse recurrence
    (ref.mamba_chunk_scan_bwd) to 1e-10."""
    gen = torch.Generator().manual_seed(s + q + segment)
    bs, nh, hd, ns = 2, 3, 4, 3
    rn = lambda *sh: torch.randn(sh, dtype=torch.float64,  # noqa: E731
                                 generator=gen)
    x, b, c, d, dy = rn(bs, s, nh, hd), rn(bs, s, ns), rn(bs, s, ns), \
        rn(nh), rn(bs, s, nh, hd)
    dt = torch.rand(bs, s, nh, dtype=torch.float64, generator=gen) * 0.3 \
        + 0.01
    a = -torch.rand(nh, dtype=torch.float64, generator=gen) - 0.1
    h0 = rn(bs, nh, hd, ns) if with_h0 else None
    dhf = rn(bs, nh, hd, ns)
    got = _ssd_bwd_segmented(x, dt, a, b, c, d, dy, dhf, h0, q, group,
                             segment)
    want = ref.mamba_chunk_scan_bwd(x, dt, a, b, c, d, dy, dhf, h0=h0)
    for name, g, w in zip(("dx", "ddt", "da", "db", "dc", "dd", "dh0"), got,
                          want):
        if w is None:
            assert g is None
            continue
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10, msg=name)


SSD_BWD_OPERANDS = ("wt", "pdt", "pd", "dh", "hin", "decx", "efdy")


@pytest.mark.parametrize("one_term", [None, *SSD_BWD_OPERANDS])
def test_ssd_bwd_precision_model(one_term):
    """The bf16 backward kernels' roundings, emulated in plain torch at
    (1, 512, 4, 64, 64) with h0 and dh_final on bf16 inputs, against the
    plain backward: with every fp32 operand of a product as three bf16
    terms, every output (dx, db, dc rounded to bf16) within
    SSD_BWD_REL_L2_BF16; with any one of them rounded to one bf16 term,
    some output lands past it, which is why the kernels split them."""
    from repro_torch.kernels import mamba_chunk_scan as mcs
    b, s, nh, hd, ns = 1, 512, 4, 64, 64
    rng = np.random.default_rng(17)
    f32 = np.float32
    x, bm, cm, dy = (rng.standard_normal(sh).astype(f32) for sh in
                     ((b, s, nh, hd), (b, s, ns), (b, s, ns), (b, s, nh, hd)))
    dt = (np.abs(rng.standard_normal((b, s, nh))) * 0.1 + 0.01).astype(f32)
    a = -(np.abs(rng.standard_normal(nh)) + 0.1).astype(f32)
    d = rng.standard_normal(nh).astype(f32)
    h0, dhf = (rng.standard_normal((b, nh, hd, ns)).astype(f32)
               for _ in range(2))
    t = {k: torch.from_numpy(v) for k, v in
         dict(x=x, dt=dt, a=a, b=bm, c=cm, d=d, dy=dy).items()}
    for k in ("x", "b", "c", "dy"):
        t[k] = _bf16(t[k])
    h0, dhf = torch.from_numpy(h0), torch.from_numpy(dhf)
    bf = {k: t[k].bfloat16() for k in ("x", "b", "c", "dy")}
    want = ref.mamba_chunk_scan_bwd(bf["x"], t["dt"], t["a"], bf["b"],
                                    bf["c"], t["d"], bf["dy"], dhf, h0=h0)
    rounds = {k: _terms3 for k in SSD_BWD_OPERANDS}
    if one_term is not None:
        rounds[one_term] = _bf16
    got = _ssd_bwd_segmented(t["x"], t["dt"], t["a"], t["b"], t["c"], t["d"],
                             t["dy"], dhf, h0, mcs.BWD_Q,
                             mcs.bwd_group(nh, hd, ns), mcs.BWD_SEGMENT,
                             rounds)
    rel = {}
    for name, g, w in zip(("dx", "ddt", "da", "db", "dc", "dd", "dh0"), got,
                          want):
        g = g.bfloat16() if name in ("dx", "db", "dc") else g
        rel[name] = float((g.float() - w.float()).norm() / w.float().norm())
    worst = max(rel.values())
    assert (worst <= mcs.SSD_BWD_REL_L2_BF16) == (one_term is None), rel


def test_ssd_bwd_wrapper_passes_what_the_signature_declares():
    """The backward wrapper's call of its C entry point, with the library
    and the CUDA checks mocked out: one argument per declared argtype, in
    the order of csrc/mamba_chunk_scan_bwd.cu; null h0, dh_final and dh0
    where none is given; in fp32 the chunk length of ``bwd_chunk``, one
    head a group and one chunk a segment; in bf16 64-row chunks,
    ``bwd_group`` heads a group, ``BWD_SEGMENT`` chunks a segment and fp32
    scratch of the documented shapes; one launch counted a call.  Through
    ``ops`` a meta tensor dispatches as a CUDA one: the forward kernel
    runs under autograd and the backward kernel in the backward."""
    from unittest import mock

    from repro_torch.kernels import build
    from repro_torch.kernels import mamba_chunk_scan as mcs
    calls = []

    def entry(name, symbol=None):
        return lambda *args: calls.append((name, args)) or 0

    stream = mock.Mock(cuda_stream=7)
    bs, s, nh, hd, ns = 2, 100, 3, 128, 128
    x = torch.zeros(bs, s, nh, hd, device="meta")
    dt = torch.zeros(bs, s, nh, device="meta")
    a = torch.zeros(nh, device="meta")
    bm = torch.zeros(bs, s, ns, device="meta")
    n0 = mcs.mamba_chunk_scan_bwd.launches
    with mock.patch.object(build, "entry", entry), \
            mock.patch.object(build, "check_operand"), \
            mock.patch.object(torch.cuda, "current_stream",
                              return_value=stream):
        out = mcs.mamba_chunk_scan_bwd(x, dt, a, bm, bm, a, x, None)
        ((name, args),) = calls
        assert name == mcs.BWD_NAME
        assert len(args) == len(build.SIGNATURES[name][name])
        assert args[6] is None and args[8] is None and args[15] is None
        assert args[21:] == (0, bs, s, nh, hd, ns, 32, 1, 1, 7)
        assert out[-1] is None and out[0].shape == x.shape
        assert out[1].shape == dt.shape and out[3].shape == bm.shape
        calls.clear()
        xg = x.clone().requires_grad_(True)
        y, _ = ops.mamba_chunk_scan(xg, dt, a, bm, bm, a)
        assert [n for n, _ in calls] == [mcs.NAME]
        torch.autograd.grad(y, xg, torch.zeros_like(y))
        assert [n for n, _ in calls] == [mcs.NAME, mcs.BWD_NAME]
        # bf16, zamba2's widths, 10 chunks: 2 segments, 10 groups of 8
        calls.clear()
        bs, s, nh, hd, ns = 2, 600, 80, 64, 64
        nc, nseg, ng = 10, 2, 10
        xb = torch.zeros(bs, s, nh, hd, dtype=torch.bfloat16, device="meta")
        bb = torch.zeros(bs, s, ns, dtype=torch.bfloat16, device="meta")
        dt = torch.zeros(bs, s, nh, device="meta")
        a = torch.zeros(nh, device="meta")
        h0 = torch.zeros(bs, nh, hd, ns, device="meta")
        real, scratch = torch.empty, []

        def empty(*shape, **kw):
            t = real(*shape, **kw)
            scratch.append(tuple(t.shape))
            return t
        with mock.patch.object(torch, "empty", empty):
            out = mcs.mamba_chunk_scan_bwd(xb, dt, a, bb, bb, a, xb, h0, h0)
        ((name, args),) = calls
        assert len(args) == len(build.SIGNATURES[name][name])
        assert args[15] is not None and out[-1].shape == h0.shape
        assert args[21:] == (1, bs, s, nh, hd, ns, mcs.BWD_Q,
                             mcs.bwd_group(nh, hd, ns), mcs.BWD_SEGMENT, 7)
        assert (mcs.BWD_Q, mcs.bwd_group(nh, hd, ns), mcs.BWD_SEGMENT) == (
            64, 8, 8)
        assert {(2, bs, nh, nc + nseg, hd, ns), (2, bs, ng, s, ns),
                (2, bs, nc, nh)} <= set(scratch)
    assert mcs.mamba_chunk_scan_bwd.launches - n0 == 3


def test_ops_flash_attention_gives_the_kernels_contiguous_operands():
    """A fused QKV projection's q, k and v are strided views of one
    output; ops.flash_attention hands the kernel wrappers (which refuse a
    strided operand) contiguous ones, with and without autograd.  A meta
    tensor dispatches as a CUDA one."""
    from unittest import mock
    seen = []

    def fwd(q, k, v, **kw):
        seen.append(all(t.is_contiguous() for t in (q, k, v)))
        b, s, h, _ = q.shape
        return (torch.empty_like(q),
                torch.empty((b, h, s), device=q.device))

    qkv = torch.zeros(2, 8, 3 * 4 * 16, device="meta")
    q, k, v = (t.unflatten(-1, (4, 16)) for t in qkv.split(64, dim=-1))
    assert not v.is_contiguous()
    with mock.patch.object(fa, "flash_attention",
                           lambda *a, **kw: fwd(*a, **kw)[0]), \
            mock.patch.object(fa, "flash_attention_fwd", fwd):
        ops.flash_attention(q, k, v)
        ops.flash_attention(q, k, v.requires_grad_(True))
    assert seen == [True, True]
