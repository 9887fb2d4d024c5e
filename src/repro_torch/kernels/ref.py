"""Plain PyTorch versions of the kernels.

These are the semantics contract, as :mod:`repro.kernels.ref` is for the
JAX package: the CUDA kernels must match them within tolerance, and a
CPU tensor given to :mod:`repro_torch.kernels.ops` runs them directly.
The dtype points follow the JAX oracles: attention scores are computed in
the input dtype, then softmax in fp32, and the probabilities are cast back
to ``v.dtype`` before the PV product; RMSNorm statistics are fp32; the SSD
scan runs in fp32 and casts ``y`` to ``x.dtype``.  "fp32" means at least
fp32: float64 inputs stay float64, so ``torch.autograd.gradcheck`` can
hold the backward versions against finite differences.

The backward versions (``rmsnorm_bwd``, ``flash_attention_bwd``,
``mamba_chunk_scan_bwd``) are the contract of the CUDA backward kernels.
The JAX package has no backward kernels: it differentiates its jnp
oracles, and the tests hold these functions against ``jax.vjp`` of those.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in fp32, or in float64 if it is float64."""
    return t if t.dtype == torch.float64 else t.float()


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


def _scores(q, k, *, causal, window, softcap, scale, q_pos0=0, kv_pos0=0):
    """Masked fp32 scores (B,H,S,T) and the pre-cap tanh (or None).  k is
    already expanded to the H query heads."""
    s, t = q.shape[1], k.shape[1]
    scores = _f32(torch.einsum("bshd,bthd->bhst", q, k)) * scale
    tanh = None
    if softcap:
        tanh = torch.tanh(scores / softcap)
        scores = softcap * tanh
    m = _mask(s, t, causal=causal, window=window, q_pos0=q_pos0,
              kv_pos0=kv_pos0, device=q.device)
    return torch.where(m[None, None], scores, NEG_INF), m, tanh


def _attend_dense(q, k, v, *, causal, window, softcap, scale,
                  q_pos0=0, kv_pos0=0):
    """(out (B,S,H,hd) in v.dtype, lse (B,H,S) fp32)."""
    h = q.shape[2]
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    scores, _, _ = _scores(q, k, causal=causal, window=window,
                           softcap=softcap, scale=scale, q_pos0=q_pos0,
                           kv_pos0=kv_pos0)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    return (torch.einsum("bhst,bthd->bshd", p, v),
            torch.logsumexp(scores, dim=-1))


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
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale,
                               q_offset=q_offset)[0]


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        softcap: float | None = None, scale: float = 1.0,
                        q_offset: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention` and the log-sum-exp of each query row's
    masked scores, fp32 (B,H,S), which the backward needs."""
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
    return (torch.cat([o for o, _ in outs], dim=1),
            torch.cat([lse for _, lse in outs], dim=2))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        softcap: float | None = None, scale: float = 1.0,
                        q_offset: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of :func:`flash_attention`, in the dtypes of
    q, k and v, from its output ``o``, log-sum-exp ``lse`` (B,H,S) and the
    output gradient ``do``.  P is recomputed from the LSE; the products run
    in fp32; D = rowsum(dO * O); the softcap's derivative 1 - tanh^2 is
    applied to dS; dk and dv are summed over the H/KV query heads of each
    kv head.  Dense over the whole (S, T) score matrix."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    qf, kf, vf, of, dof = (_f32(x) for x in (q, k, v, o, do))
    ke, ve = _expand_kv(kf, h), _expand_kv(vf, h)
    scores, m, tanh = _scores(q, _expand_kv(k, h), causal=causal,
                              window=window, softcap=softcap, scale=scale,
                              q_pos0=q_offset)
    p = torch.exp(scores - _f32(lse)[..., None])               # (B,H,S,T)
    dv = torch.einsum("bhst,bshd->bthd", p, dof)
    dp = torch.einsum("bshd,bthd->bhst", dof, ve)
    d = (dof * of).sum(-1).transpose(1, 2)                     # (B,H,S)
    ds = p * (dp - d[..., None])
    if softcap:
        ds = ds * (1 - tanh * tanh)
    ds = torch.where(m[None, None], ds, 0.0) * scale
    dq = torch.einsum("bhst,bthd->bshd", ds, ke)
    dk = torch.einsum("bhst,bshd->bthd", ds, qf)
    g = h // kv
    dk = dk.reshape(b, t, kv, g, hd).sum(3)
    dv = dv.reshape(b, t, kv, g, hd).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def decode_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, lengths: torch.Tensor, window: int | None = None,
                         softcap: float | None = None, scale: float = 1.0
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The decode kernel's function with its log-sum-exp: (out (B,1,H,hd)
    in q's dtype, lse (B,H) fp32).  Positions t < lengths[b] (and within
    ``window`` of it) are live, lengths taken as given: one past T still
    places the window's start, as a shard of a cache split over its
    sequence needs with lengths relative to its first position.  A row
    with no live key gets out 0 and lse -inf, so that a merge of shards by
    their log-sum-exps gives it weight 0."""
    h, t = q.shape[2], k.shape[1]
    k, v = _expand_kv(k, h), _expand_kv(v, h)
    scores = torch.einsum("bshd,bthd->bhst", q, k).float() * scale
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    ti = torch.arange(t, device=q.device)[None, :]
    lengths = lengths.to(q.device)
    valid = ti < lengths[:, None]
    if window is not None and window > 0:
        valid &= ti >= (lengths[:, None] - window)
    scores = torch.where(valid[:, None, None, :], scores, float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)                    # (B,H,1)
    p = torch.exp(scores - torch.where(torch.isinf(lse), 0.0,
                                       lse)[..., None])
    out = torch.einsum("bhst,bthd->bshd", p, v.float())
    return out.to(q.dtype), lse[..., 0]


def merge_attention(outs, lses) -> torch.Tensor:
    """Attention over a key set from its shards' outputs ``outs`` (each
    (B,S,H,hd)) and log-sum-exps ``lses`` (each (B,H,S)), in one process:
    each shard weighted by exp(lse - max lse), fp32.  The sharded route
    (``sharded._merge``) computes the same with all-reduces over ranks; a
    shard with lse -inf (no live key) gets weight 0."""
    lse = torch.stack(lses)
    top = lse.max(0).values
    w = torch.exp(lse - top)                               # (n,B,H,S)
    o = sum(oi.float() * wi.transpose(1, 2)[..., None]
            for oi, wi in zip(outs, w))
    return o / w.sum(0).transpose(1, 2)[..., None]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
            zero_centered: bool = True) -> torch.Tensor:
    """Over the last dim: x * rsqrt(mean(x^2) + eps) * (1 + scale) (or
    * scale), statistics in fp32, output in x.dtype."""
    xf = _f32(x)
    xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    sc = _f32(scale)
    sc = 1.0 + sc if zero_centered else sc
    return (xf * sc).to(x.dtype)


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, *,
                eps: float = 1e-6, zero_centered: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradients (dx in x.dtype, dscale in scale.dtype) of :func:`rmsnorm`
    for the output gradient ``g``: with r = rsqrt(mean(x^2) + eps),
    xh = x r and w = 1 + scale (or scale),
    dx = r (g w - xh mean(g w xh)) and dscale = sum over rows of g xh."""
    xf, gf = _f32(x), _f32(g)
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    xh = xf * r
    w = _f32(scale)
    w = 1.0 + w if zero_centered else w
    gw = gf * w
    dx = r * (gw - xh * (gw * xh).mean(dim=-1, keepdim=True))
    dscale = (gf * xh).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


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
    xf, dtf, bf, cf = _f32(x), _f32(dt), _f32(b), _f32(c)
    a, d = _f32(a), _f32(d)
    h = (torch.zeros((bs, nh, hd, ns), dtype=xf.dtype, device=x.device)
         if h0 is None else _f32(h0))
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


def mamba_chunk_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                         b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                         dy: torch.Tensor, dh_final: torch.Tensor | None,
                         h0: torch.Tensor | None = None):
    """Gradients of :func:`mamba_chunk_scan` for the output gradients ``dy``
    (B,S,NH,HD) and ``dh_final`` (B,NH,HD,NS; None for zeros), by the
    exact reverse recurrence.  With l_t = dt_t a, h_t = e^{l_t} h_{t-1} +
    dt_t x_t (x) B_t and y_t = h_t C_t + D x_t, per (batch, head):

      g_t   = dy_t (x) C_t + e^{l_{t+1}} g_{t+1}   (dh_final added at S)
      dx_t  = dt_t g_t B_t + D dy_t
      dB_t  = sum_h dt_t g_t^T x_t,     dC_t = sum_h h_t^T dy_t
      dl_t  = e^{l_t} <g_t, h_{t-1}>,   ddt_t = a dl_t + x_t^T g_t B_t
      da    = sum_{b,t} dt_t dl_t,      dD = sum_{b,t} <dy_t, x_t>
      dh0   = e^{l_1} g_1

    Returns (dx, ddt, da, db, dc, dd, dh0): dx, db and dc in x.dtype, the
    rest fp32; dh0 is None when ``h0`` is None.  The states h_t are
    recomputed forward first and kept, (S, B, NH, HD, NS) of them."""
    bs, s, nh, hd = x.shape
    ns = b.shape[-1]
    xf, dtf, bf, cf, dyf = (_f32(t) for t in (x, dt, b, c, dy))
    af, df = _f32(a), _f32(d)
    h = (torch.zeros((bs, nh, hd, ns), dtype=xf.dtype, device=x.device)
         if h0 is None else _f32(h0))
    decay = torch.exp(dtf * af)                            # (B, S, NH)
    states = [h]                                           # h_{t-1} at t
    for t in range(s):
        h = h * decay[:, t, :, None, None] + torch.einsum(
            "bh,bn,bhd->bhdn", dtf[:, t], bf[:, t], xf[:, t])
        states.append(h)
    g = torch.zeros_like(h) if dh_final is None else _f32(dh_final).clone()
    dx, ddt, dl, db, dc = (torch.empty_like(t) for t in (xf, dtf, dtf, bf,
                                                         cf))
    for t in reversed(range(s)):
        g = g + torch.einsum("bhd,bn->bhdn", dyf[:, t], cf[:, t])
        gb = torch.einsum("bhdn,bn->bhd", g, bf[:, t])      # g_t B_t
        dx[:, t] = dtf[:, t, :, None] * gb + df[None, :, None] * dyf[:, t]
        db[:, t] = torch.einsum("bh,bhdn,bhd->bn", dtf[:, t], g, xf[:, t])
        dc[:, t] = torch.einsum("bhdn,bhd->bn", states[t + 1], dyf[:, t])
        dl[:, t] = decay[:, t] * (g * states[t]).sum((-2, -1))
        ddt[:, t] = af * dl[:, t] + (xf[:, t] * gb).sum(-1)
        g = g * decay[:, t, :, None, None]
    da = (dtf * dl).sum((0, 1))
    dd = (dyf * xf).sum((0, 1, 3))
    return (dx.to(x.dtype), ddt, da, db.to(x.dtype), dc.to(x.dtype), dd,
            None if h0 is None else g)


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_gate: torch.Tensor, f_gate: torch.Tensor, *,
                    eps: float = 1e-6) -> torch.Tensor:
    """xLSTM mLSTM, fully quadratic stabilised reference (the oracle the
    chunked model path of :mod:`repro_torch.models.xlstm` is held to; no
    Pallas kernel computes it).

    q,k,v: (B, S, NH, HD); i_gate,f_gate: (B, S, NH) pre-activations.
    Returns (B, S, NH, HD) in v.dtype.  With D[t,u] = sum_{j=u+1..t}
    log sigmoid(f_j) + i_u for u <= t and m_t = max_u D[t,u]:
    y_t = sum_u (q_t.k_u / sqrt(HD)) e^{D[t,u] - m_t} v_u over
    max(|sum_u (q_t.k_u / sqrt(HD)) e^{D[t,u] - m_t}|, e^{-m_t}) + eps."""
    s, hd = q.shape[1], q.shape[-1]
    logf = torch.nn.functional.logsigmoid(_f32(f_gate))       # (B,S,NH)
    logf_cum = torch.cumsum(logf, dim=1)
    dmat = (logf_cum[:, :, None] - logf_cum[:, None, :]
            + _f32(i_gate)[:, None, :, :])                     # (B,S,S,NH)
    tri = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    dmat = torch.where(tri[None, :, :, None], dmat, -torch.inf)
    m = dmat.amax(dim=2, keepdim=True).clamp(min=-1e30)       # (B,S,1,NH)
    dexp = torch.exp(dmat - m)
    scores = torch.einsum("bsnh,bunh->bsun", _f32(q), _f32(k)) / hd ** 0.5
    w = scores * dexp
    norm = torch.maximum(w.sum(dim=2).abs(), torch.exp(-m[:, :, 0]))
    y = torch.einsum("bsun,bunh->bsnh", w, _f32(v))
    return (y / (norm[..., None] + eps)).to(v.dtype)


def topk_gating(logits: torch.Tensor, k: int, *, router: str = "softmax",
                bias: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE router.  logits: (T, E) -> (weights (T,k) fp32, idx (T,k)).

    ``bias`` (DeepSeek-V3's aux-loss-free routing) moves the selection
    only: the weights come from the unbiased logits.  Softmax weights are
    normalised over the k chosen logits; sigmoid weights are renormalised
    to sum to 1 (+1e-20), as :func:`repro.kernels.ref.topk_gating`."""
    sel = logits if bias is None else logits + bias[None]
    idx = torch.topk(sel, k, dim=-1).indices
    gathered = _f32(torch.gather(logits, -1, idx))
    if router == "sigmoid":
        w = torch.sigmoid(gathered)
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    else:
        w = torch.softmax(gathered, dim=-1)
    return w, idx
