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
    (1, 200, 200, 16, 16, 256, True, None, None, 0),  # gemma-7b's hd 256
    (2, 77, 130, 4, 2, 256, True, 40, 50.0, 53),
    (1, 129, 129, 4, 1, 256, False, None, 30.0, 0),
    (1, 1, 1, 2, 2, 256, True, None, None, 0),
    (1, 150, 150, 14, 2, 128, True, None, None, 0),  # G = 7 (deepseek)
    (1, 300, 300, 8, 4, 128, True, 96, 50.0, 0),     # gemma2's window, cap
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
    (8, 1024, 16, 16, 256, None, None),              # gemma-7b
    (8, 1024, 56, 8, 128, None, None),               # deepseek-coder, G 7
    (3, 700, 32, 16, 128, 256, 50.0),                # gemma2, local layer
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


# decode shapes for the log-sum-exp output (b, t, h, kv, hd, window, cap):
# llama3.2-1b, gemma-7b and deepseek-coder-33b's decode steps, and a
# softcapped window
DECODE_LSE_CASES = [
    (8, 1024, 32, 8, 64, None, None),
    (8, 1024, 16, 16, 256, None, None),
    (8, 1024, 56, 8, 128, None, None),
    (3, 700, 32, 16, 128, 256, 50.0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,kv,hd,window,cap", DECODE_LSE_CASES)
def test_decode_kernel_lse_matches_plain(cuda, dtype, b, t, h, kv, hd,
                                         window, cap):
    """The kernel's log-sum-exp output (with_lse) and its output against
    ``ref.decode_attention_lse`` at TOL (in bf16 the plain version rounds
    each score to bf16 before its fp32 sum), and its output bit-equal to
    the call without it.  A row of length 0 gives lse -inf and output
    0."""
    rng = np.random.default_rng(t + hd)
    q = _randn(rng, (b, 1, h, hd), dtype, cuda)
    k = _randn(rng, (b, t, kv, hd), dtype, cuda)
    v = _randn(rng, (b, t, kv, hd), dtype, cuda)
    lengths = rng.integers(1, t + 1, size=(b,)).astype(np.int32)
    lengths[0] = 0
    kw = dict(lengths=torch.from_numpy(lengths).to(cuda), window=window,
              softcap=cap, scale=hd ** -0.5)
    out, lse = da.decode_attention(q, k, v, with_lse=True, **kw)
    plain = da.decode_attention(q, k, v, **kw)
    want, want_lse = ref.decode_attention_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32 and lse.shape == (b, h)
    assert torch.equal(out, plain)
    assert torch.isneginf(lse[0]).all() and not out[0].any()
    _close(out[1:], want[1:], dtype)
    _close(lse[1:], want_lse[1:], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("window", [None, 300])
def test_decode_kernel_shards_merge_to_the_whole(cuda, dtype, shards,
                                                 window):
    """llama3.2-1b's decode step (8, 1024, 32, 8, 64) over a cache cut
    into ``shards`` pieces over its sequence: the kernel with its
    log-sum-exp on each piece (lengths relative to its first position,
    one past its end keeping the window's start), merged by
    ``ref.merge_attention``, against the kernel on the whole cache and the
    plain version.  Lengths leave the last shard empty for most rows and
    the window crosses shard boundaries."""
    b, t, h, kv, hd = 8, 1024, 32, 8, 64
    rng = np.random.default_rng(shards)
    q = _randn(rng, (b, 1, h, hd), dtype, cuda)
    k = _randn(rng, (b, t, kv, hd), dtype, cuda)
    v = _randn(rng, (b, t, kv, hd), dtype, cuda)
    n = t // shards
    lengths = np.asarray([1, 31, n - 1, n, n + 1, n + 150, 2 * n + 7,
                          t - n - 5], np.int32)
    kw = dict(window=window, scale=hd ** -0.5)
    whole = da.decode_attention(q, k, v, lengths=torch.from_numpy(
        lengths).to(cuda), **kw)
    outs, lses = [], []
    for i in range(shards):
        sl = slice(i * n, (i + 1) * n)
        o, lse = da.decode_attention(
            q, k[:, sl].contiguous(), v[:, sl].contiguous(),
            lengths=torch.from_numpy(lengths - i * n).to(cuda),
            with_lse=True, **kw)
        outs.append(o)
        lses.append(lse[..., None])
    torch.cuda.synchronize()
    assert torch.isneginf(lses[-1]).any()
    merged = ref.merge_attention(outs, lses)
    _close(merged, whole, dtype)
    _close(merged, ref.decode_attention(
        q, k, v, lengths=torch.from_numpy(lengths).to(cuda), **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("n_split", range(1, da.MAX_SPLITS + 1))
def test_decode_kernel_every_split(cuda, dtype, window, n_split):
    """Each n_split the host can pick (B = 7 sequences over T = 256 n_split
    positions, one kv head), lengths 0, 1, 31, 32, 33, T - 1 and T: a
    window of 40 leaves all but the last one or two splits empty.  No NaN,
    length 0 gives exactly 0 (the Pallas kernel's answer; the oracle
    gives the mean of V), the rest match the plain version, and two calls
    are bit-equal."""
    b, t, h, kv, hd = 7, da.MIN_SPLIT_LEN * n_split, 4, 1, 64
    assert da.n_splits(b, kv, t, da._sm_count(cuda.index or 0)) == n_split
    rng = np.random.default_rng(n_split)
    q = _randn(rng, (b, 1, h, hd), dtype, cuda)
    k = _randn(rng, (b, t, kv, hd), dtype, cuda)
    v = _randn(rng, (b, t, kv, hd), dtype, cuda)
    lengths = torch.tensor([0, 1, 31, 32, 33, t - 1, t], dtype=torch.int32,
                           device=cuda)
    kw = dict(lengths=lengths, window=window, scale=hd ** -0.5)
    got = da.decode_attention(q, k, v, **kw)
    again = da.decode_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert not torch.isnan(got).any()
    assert torch.equal(got, again)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    _close(got[1:], ref.decode_attention(q, k, v, **kw)[1:], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,g", [(256, g) for g in da.GROUP_SIZES
                                  if da.instantiated(256, g)]
                         + [(hd, 7) for hd in (32, 64, 80, 128)])
def test_decode_kernel_every_dense_pair(cuda, dtype, hd, g):
    """Head dim 256 at each G the wrapper takes, and G = 7 at every head
    dim, through 1 and 4 splits, with a window and a softcap: within
    tolerance of the plain version, free of NaN and bit-equal twice."""
    rng = np.random.default_rng(hd + g)
    for b, t in ((2, 200), (8, 1024)):
        q = _randn(rng, (b, 1, 2 * g, hd), dtype, cuda)
        k = _randn(rng, (b, t, 2, hd), dtype, cuda)
        v = _randn(rng, (b, t, 2, hd), dtype, cuda)
        lengths = torch.from_numpy(rng.integers(
            1, t + 1, size=(b,)).astype(np.int32)).to(cuda)
        kw = dict(lengths=lengths, window=150, softcap=50.0,
                  scale=hd ** -0.5)
        got = da.decode_attention(q, k, v, **kw)
        again = da.decode_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert not torch.isnan(got).any()
        assert torch.equal(got, again)
        _close(got, ref.decode_attention(q, k, v, **kw), dtype)


def test_decode_wrapper_takes_the_pairs_the_switch_builds(cuda):
    """``instantiated`` (the wrapper's rule) agrees with the C launch
    switch (``decode_attention_built``) on every head dim and G up to 16,
    in both dtypes: the wrapper never passes a pair the switch refuses."""
    from repro_torch.kernels import build
    built = build.entry(da.NAME, da.NAME + "_built")
    for dtype in ("float32", "bfloat16"):
        for hd in (16, *build.HEAD_DIMS, 96):
            for g in range(1, 17):
                c = bool(built(build.DTYPE_CODES[dtype], hd, g))
                assert c == (da.instantiated(hd, g)), (dtype, hd, g)


def test_dense_kernels_refuse_what_is_not_built(cuda):
    """Decode is not built for (256, 16): its wrapper raises a ValueError
    naming it, and launches nothing."""
    k = torch.zeros(1, 64, 2, 256, dtype=torch.bfloat16, device=cuda)
    q = torch.zeros(1, 1, 32, 256, dtype=torch.bfloat16, device=cuda)
    n = da.decode_attention.launches
    with pytest.raises(ValueError, match="group size 16"):
        da.decode_attention(q, k, k, lengths=torch.ones(
            1, dtype=torch.int32, device=cuda))
    assert da.decode_attention.launches == n


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


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("s", [1, 63, 65, 2048])
def test_ssd_kernel_precision_with_initial_state(cuda, hd, s):
    """bf16 with h0, HD = NS: y and h_final within the rel. L2 limit of
    the plain version (SSD_REL_L2_BF16), and two calls bit-equal."""
    rng = np.random.default_rng(s + hd)
    args = _ssd_inputs(rng, 1, s, 4, hd, hd, torch.bfloat16, cuda)
    h0 = _randn(rng, (1, 4, hd, hd), torch.float32, cuda)
    y, h = mcs.mamba_chunk_scan(*args, h0=h0)
    y2, h2 = mcs.mamba_chunk_scan(*args, h0=h0)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(h, h2)
    want_y, want_h = ref.mamba_chunk_scan(*args, h0=h0)
    for got, want in ((y, want_y), (h, want_h)):
        rel = float((got.float() - want.float()).norm() / want.float().norm())
        assert rel <= mcs.SSD_REL_L2_BF16


SSD_BWD_NAMES = ("dx", "ddt", "da", "db", "dc", "dd", "dh0")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,nh,hd,ns,with_h0", [
    (2, 128, 3, 32, 16, True),
    (1, 64, 4, 16, 8, False),     # one chunk
    (1, 512, 80, 64, 64, True),   # zamba2-2.7b's widths
    (2, 200, 3, 64, 64, False),   # ragged S
    (1, 37, 4, 128, 128, True),   # ragged single chunk, Q = 32
    (1, 300, 2, 128, 64, False),  # HD 128 at Q = 64
])
def test_ssd_bwd_kernel_matches_plain(cuda, dtype, b, s, nh, hd, ns,
                                      with_h0):
    """The backward kernel against ref.mamba_chunk_scan_bwd: every output
    within rel. L2 1e-5 (fp32; exact FMAs, another summation order) or
    SSD_BWD_REL_L2_BF16 (bf16), two calls bit-equal, one launch each."""
    rng = np.random.default_rng(s + hd)
    args = _ssd_inputs(rng, b, s, nh, hd, ns, dtype, cuda)
    h0 = _randn(rng, (b, nh, hd, ns), torch.float32, cuda) if with_h0 \
        else None
    dy = _randn(rng, (b, s, nh, hd), dtype, cuda)
    dhf = _randn(rng, (b, nh, hd, ns), torch.float32, cuda)
    n = mcs.mamba_chunk_scan_bwd.launches
    got = mcs.mamba_chunk_scan_bwd(*args, dy, dhf, h0=h0)
    again = mcs.mamba_chunk_scan_bwd(*args, dy, dhf, h0=h0)
    torch.cuda.synchronize()
    assert mcs.mamba_chunk_scan_bwd.launches == n + 2
    want = ref.mamba_chunk_scan_bwd(*args, dy, dhf, h0=h0)
    limit = 1e-5 if dtype == torch.float32 else mcs.SSD_BWD_REL_L2_BF16
    assert (got[-1] is None) == (h0 is None)
    for name, g, g2, w in zip(SSD_BWD_NAMES, got, again, want):
        if w is None:
            continue
        assert g.dtype == w.dtype and torch.equal(g, g2), name
        rel = float((g.float() - w.float()).norm() / w.float().norm())
        assert rel <= limit, (name, rel)


@pytest.mark.parametrize("b,s,nh,hd,ns,with_h0,with_dhf", [
    (1, 300, 80, 64, 64, True, True),    # zamba2's widths: 5 chunks, one
                                         # segment shorter than BWD_SEGMENT
    (2, 1000, 80, 64, 64, True, True),   # 16 chunks, the last ragged
    (1, 700, 12, 64, 64, True, True),    # 11 chunks in segments of 8 + 3,
                                         # 12 heads in groups of 8 + 4
    (1, 700, 12, 64, 128, True, True),   # NS 128: one head a group
    (1, 50, 8, 64, 64, True, True),      # one ragged chunk
    (2, 1000, 80, 64, 64, False, False),  # as the training step calls it
    (1, 700, 12, 64, 64, False, False),
])
def test_ssd_bwd_kernel_segments_and_groups(cuda, b, s, nh, hd, ns, with_h0,
                                            with_dhf):
    """The bf16 backward at shapes whose chunks do not fill the last
    segment (``BWD_SEGMENT``) or whose heads do not fill the last group
    (``bwd_group``), with and without h0 and dh_final: every output
    within SSD_BWD_REL_L2_BF16 of ref.mamba_chunk_scan_bwd, two calls
    bit-equal."""
    rng = np.random.default_rng(s + nh + ns)
    args = _ssd_inputs(rng, b, s, nh, hd, ns, torch.bfloat16, cuda)
    h0 = _randn(rng, (b, nh, hd, ns), torch.float32, cuda) if with_h0 \
        else None
    dy = _randn(rng, (b, s, nh, hd), torch.bfloat16, cuda)
    dhf = _randn(rng, (b, nh, hd, ns), torch.float32, cuda) if with_dhf \
        else None
    got = mcs.mamba_chunk_scan_bwd(*args, dy, dhf, h0=h0)
    again = mcs.mamba_chunk_scan_bwd(*args, dy, dhf, h0=h0)
    torch.cuda.synchronize()
    want = ref.mamba_chunk_scan_bwd(*args, dy, dhf, h0=h0)
    assert (got[-1] is None) == (h0 is None)
    for name, g, g2, w in zip(SSD_BWD_NAMES, got, again, want):
        if w is None:
            continue
        assert torch.equal(g, g2), name
        rel = float((g.float() - w.float()).norm() / w.float().norm())
        assert rel <= mcs.SSD_BWD_REL_L2_BF16, (name, rel)


def test_zamba2_gradients_on_card_match_cpu(cuda):
    """A small zamba2-shaped model (head_dim 80, remat "full"), fp32:
    forward_loss and every gradient through the kernels (the SSD forward
    and backward, flash, rmsnorm) against the CPU plain path on the same
    params and batch; the SSD forward runs twice a mamba layer (remat),
    the backward once."""
    from repro_torch import configs
    from repro_torch.models import model
    from repro_torch.models.common import tree_leaves, tree_map
    cfg = dataclasses.replace(configs.get_config("zamba2-2.7b", smoke=True),
                              d_model=128, num_heads=2, num_kv_heads=2,
                              head_dim=80, d_ff=256, remat="full")
    params = model.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 100)).astype(np.int32))
    n_mamba = sum(sum(s.kind == "mamba2" for s in g.pattern) * g.repeat
                  for g in cfg.groups)
    res = []
    for dev in ("cpu", cuda):
        p = tree_map(lambda a: a.to(dev).requires_grad_(True), params)
        n = (mcs.mamba_chunk_scan.launches, mcs.mamba_chunk_scan_bwd.launches)
        loss, _ = model.forward_loss(p, cfg, toks[:, :-1].to(dev),
                                     toks[:, 1:].to(dev))
        grads = torch.autograd.grad(loss, tree_leaves(p))
        res.append((loss.detach().cpu(), [g.cpu() for g in grads]))
        launched = (mcs.mamba_chunk_scan.launches - n[0],
                    mcs.mamba_chunk_scan_bwd.launches - n[1])
    assert launched == (2 * n_mamba, n_mamba)
    (l_cpu, g_cpu), (l_gpu, g_gpu) = res
    torch.testing.assert_close(l_gpu, l_cpu, rtol=2e-4, atol=2e-4)
    for a, b in zip(g_gpu, g_cpu):
        assert float((a - b).norm() / b.norm()) < 1e-3


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_flash_kernels_refuse_rows_without_keys(cuda, direction):
    """A window with q_offset + S >= T + window leaves the last query row
    with no live key: both wrappers raise, and launch nothing."""
    s, t, window = 64, 128, 32
    q = torch.zeros(1, s, 4, 64, dtype=torch.bfloat16, device=cuda)
    k = torch.zeros(1, t, 2, 64, dtype=torch.bfloat16, device=cuda)
    lse = torch.zeros(1, 4, s, device=cuda)
    kw = dict(window=window, q_offset=t + window - s)
    wrapper = (fa.flash_attention if direction == "fwd"
               else fa.flash_attention_bwd)
    n = wrapper.launches
    with pytest.raises(ValueError, match="no live key"):
        if direction == "fwd":
            fa.flash_attention_fwd(q, k, k, **kw)
        else:
            fa.flash_attention_bwd(q, k, k, q, lse, q, **kw)
    assert wrapper.launches == n
    kw["q_offset"] -= 1  # the last row keeps key T - 1
    if direction == "fwd":
        fa.flash_attention_fwd(q, k, k, **kw)
    else:
        fa.flash_attention_bwd(q, k, k, q, lse, q, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == n + 1


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


@pytest.mark.parametrize("arch,widths", [
    # gemma2: post-norms, window 8 on every other layer, both softcaps
    ("gemma2-27b", dict(d_model=128, num_heads=4, num_kv_heads=2,
                        head_dim=32, d_ff=256, attn_scale=1 / 12)),
    ("gemma-7b", dict(d_model=128, num_heads=2, num_kv_heads=2,
                      head_dim=256, d_ff=256)),           # head_dim 256
    ("deepseek-coder-33b", dict(d_model=128, num_heads=14, num_kv_heads=2,
                                head_dim=32, d_ff=256)),  # G = 7
])
def test_dense_family_on_card_matches_cpu(cuda, arch, widths):
    """Small dense-family models: prefill + decode logits through the
    kernels match the CPU plain path, and each prefill and decode step
    launched flash, decode and rmsnorm as the layers ask (gemma2: four
    norms a layer)."""
    from repro_torch import configs
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.models import model
    from repro_torch.models.common import tree_map
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True), **widths)
    params = model.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    params = tree_map(lambda a: a + 0.05 * torch.randn_like(a)
                      if a.dim() == 1 else a, params)  # norm scales not 0
    params_gpu = tree_map(lambda a: a.to(cuda), params)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 41)).astype(np.int32))
    layers = sum(len(g.pattern) * g.repeat for g in cfg.groups)
    norms = 1 + sum((2 + 2 * s.post_norms) * g.repeat
                    for g in cfg.groups for s in g.pattern)
    outs = []
    for dev, p in (("cpu", params), (cuda, params_gpu)):
        cache = model.init_cache(cfg, 2, 48, device=dev)
        n = (fa.flash_attention.launches, da.decode_attention.launches,
             rn.rmsnorm_fwd.launches)
        pre, cache = model.prefill(p, cfg, toks[:, :-1].to(dev), cache)
        dec, _ = model.decode_step(p, cfg, toks[:, -1:].to(dev), cache,
                                   torch.full((2,), 40, dtype=torch.int32,
                                              device=dev))
        launched = (fa.flash_attention.launches - n[0],
                    da.decode_attention.launches - n[1],
                    rn.rmsnorm_fwd.launches - n[2])
        outs.append((pre.cpu(), dec.cpu()))
    assert launched == (layers, layers, 2 * norms)
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
    (8, 2048), (8, 2560), (8, 5120),          # decode steps: a row a CTA
    (512, 2048),                              # llama's prefill
    (1024, 2560),                             # packed past FEW_ELEMS
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(37, 2560), (8, 2048), (300, 512)])
def test_rmsnorm_kernels_take_unaligned_rows(cuda, dtype, shape):
    """x, g and dx views one element into their buffers: no row is 16-byte
    aligned, so the kernels load an element at a time, and stay right."""
    from repro_torch.kernels import rmsnorm as rn
    rng = np.random.default_rng(shape[0])
    n = int(np.prod(shape))

    def offset(t):
        buf = torch.empty(n + 1, dtype=dtype, device=cuda)
        view = buf[1:].view(shape)
        view.copy_(t)
        return view

    x = offset(_randn(rng, shape, dtype, cuda))
    g = offset(_randn(rng, shape, dtype, cuda))
    scale = _randn(rng, (shape[-1],), dtype, cuda) * 0.1
    assert x.data_ptr() % 16 and g.data_ptr() % 16
    plan = rn.launch_shape(shape[0], shape[-1], dtype, aligned=False)
    assert plan.vec == 1
    y, rstd = rn.rmsnorm_fwd(x, scale)
    dx, dscale = rn.rmsnorm_bwd(x, scale, rstd, g)
    torch.cuda.synchronize()
    _close(y, ref.rmsnorm(x, scale), dtype)
    want_dx, want_ds = ref.rmsnorm_bwd(x, scale, g)
    torch.testing.assert_close(dx.float(), want_dx.float(),
                               **RMS_BWD_TOL[dtype])
    torch.testing.assert_close(dscale.float(), want_ds.float(),
                               **RMS_BWD_TOL[dtype])


@pytest.mark.parametrize("shape", [(8, 2560), (512, 5120), (8192, 2048)])
def test_rmsnorm_forward_without_rstd(cuda, shape):
    """The serving form writes no rstd, and the same y bits."""
    from repro_torch.kernels import rmsnorm as rn
    rng = np.random.default_rng(7)
    x = _randn(rng, shape, torch.bfloat16, cuda)
    scale = _randn(rng, (shape[-1],), torch.bfloat16, cuda) * 0.1
    y, rstd = rn.rmsnorm_fwd(x, scale)
    y2, none = rn.rmsnorm_fwd(x, scale, with_rstd=False)
    assert none is None and rstd is not None
    assert torch.equal(y, y2)


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
    # the training cells' shapes, cut in batch and heads: head dim 256
    # (gemma-7b; ragged, and with a window and a cap), G 6 with grok's cap
    # 30, G 7 (deepseek-coder), gemma2's window 4096 at S = 8192 with its
    # cap 50, and the VLM's non-causal cross-attention S = T = 2048
    (2, 300, 300, 4, 2, 256, True, None, None),
    (1, 129, 129, 2, 2, 256, True, 64, 50.0),
    (1, 1, 1, 2, 1, 256, True, None, None),
    (1, 300, 300, 12, 2, 128, True, None, 30.0),
    (1, 200, 200, 14, 2, 128, True, None, None),
    (1, 8192, 8192, 2, 1, 128, True, 4096, 50.0),
    (1, 2048, 2048, 8, 1, 128, False, None, None),
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
    """The decode_attention and mamba_chunk_scan wrappers called directly
    (decode has no backward; the SSD's gradient goes through
    ops.mamba_chunk_scan): under grad mode with an input that requires
    grad they raise, never detach."""
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


# ---------------------------------------------------------------------------
# xlstm-350m and musicgen-medium: their kernel shapes (flash and decode at
# head_dim 64 with G = 1, rmsnorm at d 1024, 1536 and 2048) and small
# models of both families, kernel path against plain path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s", [(4, 2048), (8, 512)])
def test_flash_kernels_at_musicgen_shapes(cuda, b, s):
    """musicgen-medium's attention, 24/24 heads at head_dim 64 (G = 1),
    bf16: its training shape and its 512-frame prefill, the forward with
    its LSE and the backward against the plain versions."""
    rng = np.random.default_rng(s)
    q, k, v, do = _flash_bwd_inputs(rng, b, s, s, 24, 24, 64,
                                    torch.bfloat16, cuda)
    kw = dict(causal=True, scale=0.125)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    want_o, want_lse = ref.flash_attention_fwd(q, k, v, **kw)
    _close(o, want_o, torch.bfloat16)
    _close(fa.flash_attention(q, k, v, **kw), want_o, torch.bfloat16)
    torch.testing.assert_close(lse, want_lse, **TOL[torch.bfloat16])
    del want_o, want_lse
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    want = ref.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a.float(), w.float(),
                                   **FLASH_BWD_TOL[torch.bfloat16], msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_at_musicgen_shape(cuda, dtype):
    """A musicgen-medium decode step: 8 slots over 1024 positions, 24/24
    heads at head_dim 64, lengths from 1 to 1024; twice bit-equal."""
    rng = np.random.default_rng(1024)
    q = _randn(rng, (8, 1, 24, 64), dtype, cuda)
    k = _randn(rng, (8, 1024, 24, 64), dtype, cuda)
    v = _randn(rng, (8, 1024, 24, 64), dtype, cuda)
    lengths = torch.tensor([1, 255, 256, 257, 513, 700, 1000, 1024],
                           dtype=torch.int32, device=cuda)
    kw = dict(lengths=lengths, scale=0.125)
    got = da.decode_attention(q, k, v, **kw)
    assert torch.equal(got, da.decode_attention(q, k, v, **kw))
    _close(got, ref.decode_attention(q, k, v, **kw), dtype)


@pytest.mark.parametrize("rows", [8, 512, 8192])
@pytest.mark.parametrize("d", [1024, 1536, 2048])
def test_rmsnorm_kernels_at_xlstm_and_musicgen_widths(cuda, rows, d):
    """xlstm-350m's norms (d 1024, and its mLSTM inner norm at 2048) and
    musicgen-medium's (1536), bf16, at a decode step's, a prefill's and
    a training step's rows: the forward with and without rstd and the
    backward against the plain versions."""
    from repro_torch.kernels import rmsnorm as rn
    rng = np.random.default_rng(rows + d)
    x = _randn(rng, (rows, d), torch.bfloat16, cuda)
    scale = _randn(rng, (d,), torch.bfloat16, cuda) * 0.1
    g = _randn(rng, (rows, d), torch.bfloat16, cuda)
    y, rstd = rn.rmsnorm_fwd(x, scale)
    y2, _ = rn.rmsnorm_fwd(x, scale, with_rstd=False)
    assert torch.equal(y, y2)
    _close(y, ref.rmsnorm(x, scale), torch.bfloat16)
    dx, dscale = rn.rmsnorm_bwd(x, scale, rstd, g)
    want_dx, want_ds = ref.rmsnorm_bwd(x, scale, g)
    torch.testing.assert_close(dx.float(), want_dx.float(),
                               **RMS_BWD_TOL[torch.bfloat16])
    torch.testing.assert_close(dscale.float(), want_ds.float(),
                               **RMS_BWD_TOL[torch.bfloat16])


def _small(arch):
    """A small fp32 model of ``arch``'s family at head dims the kernels
    take: xlstm-350m's smoke config (no attention), musicgen-medium's with
    head_dim 64."""
    from repro_torch import configs
    cfg = configs.get_config(arch, smoke=True)
    if cfg.num_codebooks:
        cfg = dataclasses.replace(cfg, d_model=128, num_heads=2,
                                  num_kv_heads=2, head_dim=64, d_ff=256)
    return cfg


@pytest.mark.parametrize("arch", ["xlstm-350m", "musicgen-medium"])
def test_xlstm_and_musicgen_on_card_match_cpu(cuda, arch):
    """Prefill (37 tokens: the mLSTM pads its last chunk) + one decode
    step through the kernels against the CPU plain path, with every
    norm on the rmsnorm kernel (and musicgen's attention on flash and
    decode), and forward_loss's gradients likewise."""
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.models import model
    from repro_torch.models.common import tree_leaves, tree_map
    cfg = _small(arch)
    params = model.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    params = tree_map(lambda a: a + 0.05 * torch.randn_like(a)
                      if a.dim() == 1 else a, params)  # norm scales not 0
    k = cfg.num_codebooks
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 38, k) if k else (2, 38)).astype(np.int32))
    n_attn = sum(sum(s.kind == "attn" for s in g.pattern) * g.repeat
                 for g in cfg.groups)
    outs, launched = [], None
    for dev in ("cpu", cuda):
        p = tree_map(lambda a: a.to(dev, copy=True), params)
        cache = model.init_cache(cfg, 2, 48, device=dev)
        n = (fa.flash_attention.launches, da.decode_attention.launches,
             rn.rmsnorm_fwd.launches)
        pre, cache = model.prefill(p, cfg, toks[:, :-1].to(dev), cache)
        dec, _ = model.decode_step(p, cfg, toks[:, -1:].to(dev), cache,
                                   torch.full((2,), 37, dtype=torch.int32,
                                              device=dev))
        launched = (fa.flash_attention.launches - n[0],
                    da.decode_attention.launches - n[1],
                    rn.rmsnorm_fwd.launches - n[2])
        p = tree_map(lambda a: a.requires_grad_(True), p)
        loss, _ = model.forward_loss(p, cfg, toks[:, :-1].to(dev),
                                     toks[:, 1:].to(dev))
        grads = torch.autograd.grad(loss, tree_leaves(p))
        outs.append((pre.cpu(), dec.cpu(), loss.detach().cpu(),
                     [g.cpu() for g in grads]))
    norms = 1 + sum(((s.kind != "none") + (s.mlp != "none")
                     + (s.kind == "mlstm") + (s.kind == "slstm")) * g.repeat
                    for g in cfg.groups for s in g.pattern)
    assert launched == (n_attn, n_attn, 2 * norms)
    (pre_c, dec_c, loss_c, g_c), (pre_g, dec_g, loss_g, g_g) = outs
    torch.testing.assert_close(pre_g, pre_c, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(dec_g, dec_c, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(loss_g, loss_c, rtol=2e-4, atol=2e-4)
    for a, b in zip(g_g, g_c):
        assert float((a - b).norm() / b.norm()) < 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("b,t,h,kv,window", [
    (8, 1024, 48, 8, None),                          # grok-1's decode step
    (3, 300, 12, 2, 100),
])
def test_decode_kernel_at_g6(cuda, dtype, cap, b, t, h, kv, window):
    """G = 6 (grok-1's 48 query heads over 8 kv heads) at head dim 128,
    with and without grok-1's softcap 30: within tolerance of the plain
    version, free of NaN and bit-equal twice."""
    hd = 128
    rng = np.random.default_rng(t + h)
    q = _randn(rng, (b, 1, h, hd), dtype, cuda)
    k = _randn(rng, (b, t, kv, hd), dtype, cuda)
    v = _randn(rng, (b, t, kv, hd), dtype, cuda)
    lengths = torch.from_numpy(rng.integers(1, t + 1, size=(b,)).astype(
        np.int32)).to(cuda)
    kw = dict(lengths=lengths, window=window, softcap=cap, scale=hd ** -0.5)
    got = da.decode_attention(q, k, v, **kw)
    again = da.decode_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert not torch.isnan(got).any()
    assert torch.equal(got, again)
    _close(got, ref.decode_attention(q, k, v, **kw), dtype)


def test_decode_g6_is_built(cuda):
    """The wrapper's rule and the C switch both take (128, 6)."""
    from repro_torch.kernels import build
    built = build.entry(da.NAME, da.NAME + "_built")
    assert da.instantiated(128, 6)
    for dtype in ("float32", "bfloat16"):
        assert built(build.DTYPE_CODES[dtype], 128, 6) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,kv,causal,cap", [
    (1, 300, 300, 48, 8, True, 30.0),    # grok-1's prefill: G = 6, cap 30
    (2, 77, 77, 12, 2, True, 30.0),
    (2, 1, 2048, 64, 8, False, None),    # cross-attention, a decode step
    (1, 512, 2048, 64, 8, False, None),  # cross-attention, a prefill
])
def test_flash_kernel_at_g6_and_cross_attention(cuda, dtype, b, s, t, h, kv,
                                                causal, cap):
    """The flash forward at G = 6 with a softcap, and non-causal at S = 1
    and S = 512 queries against T = 2048 image tokens, head dim 128."""
    hd = 128
    rng = np.random.default_rng(s + t)
    q = _randn(rng, (b, s, h, hd), dtype, cuda)
    k = _randn(rng, (b, t, kv, hd), dtype, cuda)
    v = _randn(rng, (b, t, kv, hd), dtype, cuda)
    kw = dict(causal=causal, softcap=cap, scale=hd ** -0.5)
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    _close(got, ref.flash_attention(q, k, v, **kw), dtype)


@pytest.mark.parametrize("arch,widths", [
    ("grok-1-314b", dict(d_model=128, num_heads=12, num_kv_heads=2,
                         head_dim=128, d_ff=256)),          # G = 6, cap 30
    ("deepseek-v3-671b", {}),          # MLA in plain torch, its norms
    ("llama-3.2-vision-90b", dict(d_model=128, num_heads=4, num_kv_heads=2,
                                  head_dim=128, d_ff=256)),
])
def test_moe_mla_vlm_on_card_match_cpu(cuda, arch, widths):
    """Small fp32 models of the three families (a nonzero router bias and
    cross-attention gate): prefill (with image embeddings for the VLM) and
    one decode step through the kernels match the CPU plain path, with
    one flash a causal attention layer at the prefill and one decode a
    step, and one non-causal flash a cross-attention layer in each."""
    from repro_torch import configs
    from repro_torch.models import model
    from repro_torch.models.common import tree_map, tree_paths
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True), **widths)
    params = model.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    gen = torch.Generator().manual_seed(1)
    for path, a in tree_paths(params):
        if a.dim() <= 1:  # norm scales, biases and gates: not 0
            a.add_(torch.rand(a.shape, generator=gen) + 0.5)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 41)).astype(
        np.int32))
    img = (torch.from_numpy(rng.standard_normal(
        (2, cfg.num_image_tokens, cfg.vision_dim)).astype(np.float32))
        if cfg.vision_dim else None)
    n = {kind: sum(sum(s.kind == kind for s in g.pattern) * g.repeat
                   for g in cfg.groups) for kind in ("attn", "cross_attn")}
    outs, launched = [], []
    for dev in ("cpu", cuda):
        p = tree_map(lambda a: a.to(dev, copy=True), params)
        cache = model.init_cache(cfg, 2, 48, device=dev)
        c0 = (fa.flash_attention.launches, da.decode_attention.launches)
        pre, cache = model.prefill(p, cfg, toks[:, :-1].to(dev), cache,
                                   None if img is None else img.to(dev))
        dec, _ = model.decode_step(p, cfg, toks[:, -1:].to(dev), cache,
                                   torch.full((2,), 40, dtype=torch.int32,
                                              device=dev))
        launched.append((fa.flash_attention.launches - c0[0],
                         da.decode_attention.launches - c0[1]))
        outs.append((pre.cpu(), dec.cpu()))
    assert launched[1] == (n["attn"] + 2 * n["cross_attn"], n["attn"])
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, rtol=2e-4, atol=2e-4)


def _pinned_routes(record, replay=None):
    """A patch of ``ref.topk_gating`` that appends each MoE router call's
    choices to ``record`` and, with ``replay`` (another run's record),
    makes that run's choices instead, in call order, weighted from this
    run's own logits as ``topk_gating`` weights them (softmax routers)."""
    from unittest import mock
    real = ref.topk_gating
    pinned = None if replay is None else iter(replay)

    def topk_gating(logits, k, *, router="softmax", bias=None):
        if pinned is None:
            w, idx = real(logits, k, router=router, bias=bias)
        else:
            idx = next(pinned).to(logits.device)
            w = torch.softmax(torch.gather(logits, -1, idx).float(), dim=-1)
        record.append(idx.cpu())
        return w, idx

    return mock.patch.object(ref, "topk_gating", topk_gating)


@pytest.mark.parametrize("arch,widths", [
    ("gemma2-27b", dict(d_model=128, num_heads=4, num_kv_heads=2,
                        head_dim=32, d_ff=256, attn_scale=1 / 12)),
    ("gemma-7b", dict(d_model=128, num_heads=2, num_kv_heads=2,
                      head_dim=256, d_ff=256)),           # head_dim 256
    ("deepseek-coder-33b", dict(d_model=128, num_heads=14, num_kv_heads=2,
                                head_dim=32, d_ff=256)),  # G = 7
    ("grok-1-314b", dict(d_model=128, num_heads=12, num_kv_heads=2,
                         head_dim=128, d_ff=256)),          # G = 6, cap 30
    ("llama-3.2-vision-90b", dict(d_model=128, num_heads=4, num_kv_heads=2,
                                  head_dim=128, d_ff=256)),
])
def test_trained_families_gradients_on_card_match_cpu(cuda, arch, widths):
    """Small fp32 models of the five families that train on the card, remat
    "full": forward_loss and every gradient through the kernels (flash and
    rmsnorm, forward and backward; the VLM with image embeddings and a
    nonzero gate, grok's MoE with its router choices pinned to the CPU
    run's) against the CPU plain path, with one flash backward an
    attention or cross-attention layer."""
    from repro_torch import configs
    from repro_torch.models import model
    from repro_torch.models.common import tree_leaves, tree_map, tree_paths
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              dtype="float32", remat="full", **widths)
    params = model.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    gen = torch.Generator().manual_seed(1)
    for _, a in tree_paths(params):
        if a.dim() <= 1:  # norm scales, biases and gates: not 0
            a.add_(torch.rand(a.shape, generator=gen) + 0.5)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 41)).astype(
        np.int32))
    img = (torch.from_numpy(rng.standard_normal(
        (2, cfg.num_image_tokens, cfg.vision_dim)).astype(np.float32))
        if cfg.vision_dim else None)
    n_attn = sum(sum(s.kind in ("attn", "cross_attn") for s in g.pattern)
                 * g.repeat for g in cfg.groups)
    assert n_attn
    res, routes, launched = [], [], 0
    for dev in ("cpu", cuda):
        p = tree_map(lambda a: a.to(dev, copy=True).requires_grad_(True),
                     params)
        leaves = tree_leaves(p)
        record = []
        with _pinned_routes(record, routes[0] if routes else None):
            n = fa.flash_attention_bwd.launches
            loss, _ = model.forward_loss(
                p, cfg, toks[:, :-1].to(dev), toks[:, 1:].to(dev),
                None if img is None else img.to(dev))
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            launched = fa.flash_attention_bwd.launches - n
        routes.append(record)
        res.append((loss.detach().cpu(),
                    [None if g is None else g.cpu() for g in grads]))
    assert launched == n_attn
    assert bool(routes[0]) == (cfg.moe is not None)
    (l_cpu, g_cpu), (l_gpu, g_gpu) = res
    torch.testing.assert_close(l_gpu, l_cpu, rtol=2e-4, atol=2e-4)
    for a, b in zip(g_gpu, g_cpu):
        assert (a is None) == (b is None)
        if b is not None:
            assert float((a - b).norm()) <= 1e-3 * max(float(b.norm()), 1e-30)

