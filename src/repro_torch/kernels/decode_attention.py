"""Wrapper of the CUDA decode-attention kernel (``csrc/decode_attention.cu``).

Counterpart of :mod:`repro.kernels.decode_attention`.  Takes CUDA tensors
only; :mod:`repro_torch.kernels.ops` sends CPU tensors to the plain
version in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build

NAME = "decode_attention"
GROUP_SIZES = (1, 2, 4, 6, 7, 8, 16)  # H/KV values the kernel is built for
# fp32 accumulators a lane holds for its G query rows: a (head_dim, G)
# pair is built where G * head_dim / 32 <= MAX_ACC (every pair of
# build.HEAD_DIMS and GROUP_SIZES but (256, 16)).  The source of the rule
# is PvLayout::BUILT in csrc/decode_attention.cu; its exported
# decode_attention_built answers for the C switch, and the card's tests
# hold ``instantiated`` to it
MAX_ACC = 64
MAX_SPLITS = 16        # most ranges the cache's positions are split into
MIN_SPLIT_LEN = 256    # fewest positions a split covers: 32 for each warp
CTAS_PER_SM = 8        # 256-thread CTAs that fill an SM's 2048 threads


def n_splits(b: int, kv: int, t: int, sms: int = 132) -> int:
    """How many ranges the kernel splits the allocated T into: enough
    (split, kv, b) CTAs to fill the card's ``sms`` SMs ``CTAS_PER_SM``
    deep, each split at least ``MIN_SPLIT_LEN`` positions, at most
    ``MAX_SPLITS``.  From the shapes alone, never from the lengths (on the
    device), so the launch needs no sync."""
    want = -(-CTAS_PER_SM * sms // (b * kv))
    return max(1, min(want, -(-t // MIN_SPLIT_LEN), MAX_SPLITS))


def instantiated(hd: int, g: int) -> bool:
    """Whether the kernel is built for head dim ``hd`` and group size
    ``g`` (the same pairs in both dtypes)."""
    return (hd in build.HEAD_DIMS and g in GROUP_SIZES
            and g * hd <= 32 * MAX_ACC)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     lengths: torch.Tensor, window: int | None = None,
                     softcap: float | None = None, scale: float = 1.0,
                     with_lse: bool = False):
    """q: (B,1,H,hd); k,v: (B,T,KV,hd); lengths: (B,) int32 -> (B,1,H,hd),
    and with ``with_lse`` also each row's fp32 log-sum-exp (B,H) of its
    scaled (and soft-capped) scores, for merging shards of a cache split
    over its sequence.  Serving only: it has no backward, and raises under
    autograd.  A sequence with length 0 (or no live key in the window)
    gets 0 and a log-sum-exp of -inf, as the Pallas kernel gives it the 0
    (the oracle, ``ref.decode_attention``, gives the mean of V)."""
    build.check_no_grad(NAME, q, k, v)
    for arg, t in (("q", q), ("k", k), ("v", v)):
        build.check_operand(NAME, arg, t, 4, None if arg == "q" else q.dtype)
    build.check_operand(NAME, "lengths", lengths, 1, torch.int32)
    b, one, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    if (one != 1 or k.shape != v.shape or k.shape[0] != b
            or k.shape[3] != hd or lengths.shape[0] != b):
        raise ValueError(f"{NAME}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, lengths "
                         f"{tuple(lengths.shape)} do not match")
    if hd not in build.HEAD_DIMS:
        raise ValueError(f"{NAME}: head_dim {hd} not in {build.HEAD_DIMS}")
    if kv == 0 or h % kv or h // kv not in GROUP_SIZES:
        raise ValueError(f"{NAME}: {h} query heads over {kv} kv heads; "
                         f"group size must be one of {GROUP_SIZES}")
    if not instantiated(hd, h // kv):
        raise ValueError(f"{NAME}: head_dim {hd} with group size {h // kv} "
                         f"is not built (G * head_dim / 32 > {MAX_ACC} "
                         f"accumulators a lane)")
    if b == 0 or t == 0:
        raise ValueError(f"{NAME}: empty input")
    out = torch.empty_like(q)
    n = n_splits(b, kv, t, _sm_count(q.device.index))
    # fp32 partials (m, l, acc) of each split, merged by a second kernel
    part = (torch.empty(n * b * h * (hd + 2), dtype=torch.float32,
                        device=q.device) if n > 1 else None)
    lse = (torch.empty((b, h), dtype=torch.float32, device=q.device)
           if with_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = build.entry(NAME, NAME + "_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(),
        None if lse is None else lse.data_ptr(),
        build.DTYPE_CODES[str(q.dtype).removeprefix("torch.")],
        b, t, h, kv, hd, int(window or 0), float(scale),
        float(softcap or 0.0), n, stream)
    build.launch_check(NAME, err)
    build.count_launch(decode_attention)
    return (out, lse) if with_lse else out


decode_attention.launches = 0
