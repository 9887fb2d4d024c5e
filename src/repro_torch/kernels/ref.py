"""Plain PyTorch versions of the kernels.

These are the semantics contract, as :mod:`repro.kernels.ref` is for the
JAX package: the CUDA kernels must match them within tolerance, and a
CPU tensor given to :mod:`repro_torch.kernels.ops` runs them directly.
The dtype points follow the JAX oracles: attention scores are computed in
the input dtype, then softmax in fp32, and the probabilities are cast back
to ``v.dtype`` before the PV product; the SSD scan runs in fp32 and casts
``y`` to ``x.dtype``.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(sq: int, st: int, *, causal: bool, window: int | None,
          q_pos0: int = 0, kv_pos0: int = 0,
          device=None) -> torch.Tensor:
    """(sq, st) boolean attend-mask with absolute position offsets."""
    qi = torch.arange(sq, device=device)[:, None] + q_pos0
    ti = torch.arange(st, device=device)[None, :] + kv_pos0
    m = torch.ones((sq, st), dtype=torch.bool, device=device)
    if causal:
        m &= qi >= ti
    if window is not None and window > 0:
        m &= qi - ti < window
    return m


def _expand_kv(k: torch.Tensor, h: int) -> torch.Tensor:
    """(B,T,KV,hd) -> (B,T,H,hd); kv head = q head // (H/KV)."""
    kv = k.shape[2]
    if kv == h:
        return k
    return torch.repeat_interleave(k, h // kv, dim=2)


def _attend_dense(q, k, v, *, causal, window, softcap, scale,
                  q_pos0=0, kv_pos0=0):
    s, h = q.shape[1], q.shape[2]
    t = k.shape[1]
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    scores = torch.einsum("bshd,bthd->bhst", q, k).float() * scale
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    m = _mask(s, t, causal=causal, window=window, q_pos0=q_pos0,
              kv_pos0=kv_pos0, device=q.device)
    scores = torch.where(m[None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", p, v)


# Above this query length, attention runs as a loop over query blocks with
# the K/V range sliced to the causal/window support of each block, which
# bounds the transient score memory to O(B*H*QB*T_blk).
BLOCK_THRESHOLD = 8192
Q_BLOCK = 1024


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None, scale: float = 1.0,
                    q_offset: int = 0) -> torch.Tensor:
    """Grouped-query attention. q: (B,S,H,hd); k,v: (B,T,KV,hd)."""
    s = q.shape[1]
    t = k.shape[1]
    if s <= BLOCK_THRESHOLD:
        return _attend_dense(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale, q_pos0=q_offset)
    if s % Q_BLOCK:
        raise ValueError(f"query length {s} is not a multiple of {Q_BLOCK}")
    outs = []
    for i in range(s // Q_BLOCK):
        qs = i * Q_BLOCK
        lo = 0
        hi = t
        if causal:
            hi = min(t, q_offset + qs + Q_BLOCK)
        if window is not None and window > 0:
            lo = max(0, q_offset + qs - window + 1)
        outs.append(_attend_dense(
            q[:, qs:qs + Q_BLOCK], k[:, lo:hi], v[:, lo:hi],
            causal=causal, window=window, softcap=softcap, scale=scale,
            q_pos0=q_offset + qs, kv_pos0=lo))
    return torch.cat(outs, dim=1)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     lengths: torch.Tensor, window: int | None = None,
                     softcap: float | None = None,
                     scale: float = 1.0) -> torch.Tensor:
    """Single-token decode. q: (B,1,H,hd); k,v: (B,T,KV,hd); lengths: (B,)."""
    h = q.shape[2]
    t = k.shape[1]
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    scores = torch.einsum("bshd,bthd->bhst", q, k).float() * scale
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    ti = torch.arange(t, device=q.device)[None, :]
    lengths = lengths.to(q.device)
    valid = ti < lengths[:, None]
    if window is not None and window > 0:
        valid &= ti >= (lengths[:, None] - window)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", p, v)


def mamba_chunk_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor, d: torch.Tensor, *,
                     chunk: int = 256, h0: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD, sequential reference (exact recurrence).

    x:  (B, S, NH, HD)   inputs per head
    dt: (B, S, NH)       softplus-ed step sizes (already positive)
    a:  (NH,)            negative decay rates (A = -exp(a_log))
    b:  (B, S, NS)       input matrix (single group)
    c:  (B, S, NS)       output matrix
    d:  (NH,)            skip connection
    h0: (B, NH, HD, NS)  initial state (zeros if None)
    Returns (y: (B,S,NH,HD) in x.dtype, h_final: (B,NH,HD,NS) fp32).
    ``chunk`` is accepted for the kernels' signature; the recurrence does
    not depend on it.
    """
    bs, s, nh, hd = x.shape
    ns = b.shape[-1]
    h = (torch.zeros((bs, nh, hd, ns), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    a, d = a.float(), d.float()
    ys = []
    for t in range(s):
        dtt = dtf[:, t]                                    # (B, NH)
        decay = torch.exp(dtt * a[None])
        dbx = torch.einsum("bh,bn,bhd->bhdn", dtt, bf[:, t], xf[:, t])
        h = h * decay[..., None, None] + dbx
        ys.append(torch.einsum("bhdn,bn->bhd", h, cf[:, t])
                  + d[None, :, None] * xf[:, t])
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros(x.shape)
    return y.to(x.dtype), h
