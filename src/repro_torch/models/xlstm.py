"""xLSTM blocks: mLSTM (matrix memory, chunk-parallel) and sLSTM (scalar
memory, a sequential recurrence with block-diagonal recurrent weights);
the counterpart of :mod:`repro.models.xlstm`.

The mLSTM's chunked path is the JAX version's arithmetic: intra-chunk
products with the unstabilised ``exp(gap)``, chunk-state contributions,
and gate pre-activations soft-capped at ``GATE_CAP`` so the inter-chunk
exponentials stay in fp32 range (held against the stabilised quadratic
oracle ``kernels.ref.mlstm_chunkwise``).  Three things are written for
torch: the three-operand products run as a scaled operand and one batched
product, so no per-position (HD, HD) tensor is formed; the associative
scan over the chunks' (C, n) states is a loop over the chunks; and the
intra-chunk mask is applied before the exponential (the same values; the
masked entries above the diagonal, which overflow at long chunks, then
give the backward zeros instead of ``0 * inf``).  The sLSTM keeps a
Python loop over time, as the JAX version keeps ``lax.scan``.  Neither
has a Pallas kernel; both run in plain torch on either device, with the
RMSNorms on ``ops.rmsnorm``.  Caches are written in place.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.common import (dense_init, rmsnorm, rmsnorm_init,
                                       soft_cap)
from repro_torch.models.config import ModelConfig, dtype_of

Params = Any
GATE_CAP = 15.0


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mdims(cfg: ModelConfig):
    d_inner = int(cfg.xlstm.proj_factor * cfg.d_model)
    nh = cfg.num_heads
    return d_inner, nh, d_inner // nh


def init_mlstm(gen: torch.Generator, cfg: ModelConfig, spec,
               device: torch.device) -> Params:
    dt = dtype_of(cfg)
    d_inner, nh, _ = _mdims(cfg)
    return {
        "up": dense_init(gen, cfg.d_model, (2 * d_inner,), dt, device),
        "wq": dense_init(gen, d_inner, (d_inner,), dt, device),
        "wk": dense_init(gen, d_inner, (d_inner,), dt, device),
        "wv": dense_init(gen, d_inner, (d_inner,), dt, device),
        "w_gates": dense_init(gen, d_inner, (2 * nh,), dt, device),
        "norm": rmsnorm_init(d_inner, dt, device),
        "down": dense_init(gen, d_inner, (cfg.d_model,), dt, device),
    }


def init_mlstm_cache(cfg: ModelConfig, spec, batch: int, max_len: int,
                     dtype: torch.dtype, device: torch.device) -> Params:
    _, nh, hd = _mdims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, nh, hd, hd), **f32),
            "n": torch.zeros((batch, nh, hd), **f32)}


def _mlstm_chunked(q, k, v, ig, fg, c0, n0, chunk: int, eps: float = 1e-6):
    """q,k,v: (B,S,NH,HD); ig,fg: (B,S,NH) soft-capped pre-activations;
    c0: (B,NH,HD,HD), n0: (B,NH,HD) fp32.  Returns (y, c_final,
    n_final)."""
    bsz, s, nh, hd = q.shape
    qq = min(chunk, s)
    assert s % qq == 0
    nc = s // qq
    shp = (bsz, nc, qq, nh)
    qr = (q.reshape(*shp, hd) / (hd ** 0.5)).float()
    kr = k.reshape(*shp, hd).float()
    vr = v.reshape(*shp, hd).float()
    igr = ig.reshape(shp).float()
    logf = F.logsigmoid(fg.reshape(shp).float())
    fcum = torch.cumsum(logf, dim=2)                      # (B,NC,Q,NH)
    ftot = fcum[:, :, -1]

    # intra-chunk: w[t,u] = q_t.k_u * exp(F_t - F_u + i_u), u <= t
    gap = fcum[:, :, :, None, :] - fcum[:, :, None, :, :] \
        + igr[:, :, None, :, :]
    tri = torch.ones((qq, qq), dtype=torch.bool, device=q.device).tril()
    dmat = torch.exp(torch.where(tri[None, None, :, :, None], gap,
                                 -torch.inf))
    scores = torch.einsum("bcqnh,bcunh->bcqun", qr, kr) * dmat
    y_num = torch.einsum("bcqun,bcunh->bcqnh", scores, vr)
    y_den = scores.sum(dim=3)                             # (B,NC,Q,NH)

    # chunk state contributions: decay_u scales k before one product
    decay_u = torch.exp(ftot[:, :, None] - fcum + igr)   # (B,NC,Q,NH)
    dc = torch.einsum("bcunh,bcund->bcnhd", kr * decay_u[..., None],
                      vr)                                 # (B,NC,NH,HD,HD)
    dn = torch.einsum("bcun,bcunh->bcnh", decay_u, kr)   # (B,NC,NH,HD)
    adec = torch.exp(ftot)                                # (B,NC,NH)

    # the states entering each chunk, and after the last
    c, n = c0, n0
    c_in, n_in = [], []
    for ci in range(nc):
        c_in.append(c)
        n_in.append(n)
        c = adec[:, ci, :, None, None] * c + dc[:, ci]
        n = adec[:, ci, :, None] * n + dn[:, ci]
    c_in, n_in = torch.stack(c_in, dim=1), torch.stack(n_in, dim=1)

    w_in = torch.exp(fcum)                                # (B,NC,Q,NH)
    y_num = y_num + torch.einsum("bcqnh,bcnhd->bcqnd", qr,
                                 c_in) * w_in[..., None]
    y_den = y_den + torch.einsum("bcqnh,bcnh->bcqn", qr, n_in) * w_in
    y = y_num / (y_den.abs().clamp(min=1.0)[..., None] + eps)
    return y.reshape(bsz, s, nh, hd), c, n


def apply_mlstm(params: Params, cfg: ModelConfig, spec, x: torch.Tensor,
                cache: Params | None = None
                ) -> tuple[torch.Tensor, Params | None]:
    bsz, s, _ = x.shape
    d_inner, nh, hd = _mdims(cfg)
    xi, z = (x @ params["up"]).chunk(2, dim=-1)
    q = (xi @ params["wq"]).reshape(bsz, s, nh, hd)
    k = (xi @ params["wk"]).reshape(bsz, s, nh, hd)
    v = (xi @ params["wv"]).reshape(bsz, s, nh, hd)
    ig, fg = soft_cap(xi @ params["w_gates"], GATE_CAP).chunk(
        2, dim=-1)                                        # (B,S,NH)

    if s == 1 and cache is not None:  # decode
        c0, n0 = cache["c"], cache["n"]
        logf = F.logsigmoid(fg[:, 0].float())
        iexp = torch.exp(ig[:, 0].float())
        fexp = torch.exp(logf)
        kf, vf = k[:, 0].float(), v[:, 0].float()
        kv = torch.einsum("bnh,bnd->bnhd", kf, vf)
        c1 = fexp[..., None, None] * c0 + iexp[..., None, None] * kv
        n1 = fexp[..., None] * n0 + iexp[..., None] * kf
        qf = q[:, 0].float() / (hd ** 0.5)
        num = torch.einsum("bnh,bnhd->bnd", qf, c1)
        den = torch.einsum("bnh,bnh->bn", qf, n1)
        y = (num / (den.abs().clamp(min=1.0)[..., None] + 1e-6)
             ).reshape(bsz, 1, d_inner)
        cf, nf = c1, n1
    else:
        if cache is not None:
            c0, n0 = cache["c"], cache["n"]
        else:
            c0 = x.new_zeros((bsz, nh, hd, hd), dtype=torch.float32)
            n0 = x.new_zeros((bsz, nh, hd), dtype=torch.float32)
        # pad to a chunk multiple with inert gates: i = -30 (no input),
        # f = +30 (decay ~1), so the carried state is untouched
        qq = min(cfg.xlstm.chunk, s)
        pad = (-s) % qq
        if pad:
            def p3(a, val):
                return F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad),
                             value=val)
            q, k, v = p3(q, 0.0), p3(k, 0.0), p3(v, 0.0)
            ig, fg = p3(ig, -30.0), p3(fg, 30.0)
        y, cf, nf = _mlstm_chunked(q, k, v, ig, fg, c0, n0,
                                   cfg.xlstm.chunk)
        y = y[:, :s].reshape(bsz, s, d_inner)
    if cache is not None:
        cache["c"].copy_(cf)
        cache["n"].copy_(nf)

    y = rmsnorm(params["norm"], y.to(x.dtype), eps=cfg.norm_eps)
    y = y * F.silu(z)
    return y @ params["down"], cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _sdims(cfg: ModelConfig):
    nh = cfg.num_heads
    return cfg.d_model, nh, cfg.d_model // nh


def init_slstm(gen: torch.Generator, cfg: ModelConfig, spec,
               device: torch.device) -> Params:
    dt = dtype_of(cfg)
    d, nh, hd = _sdims(cfg)
    d_up = int(d * cfg.xlstm.slstm_proj_factor)
    return {
        "w_in": dense_init(gen, d, (4 * d,), dt, device),   # i,f,z,o
        "r": (torch.randn((4, nh, hd, hd), generator=gen, device=device)
              / (hd ** 0.5)).to(dt),                        # block-diag
        "norm": rmsnorm_init(d, dt, device),
        "up_gate": dense_init(gen, d, (2 * d_up,), dt, device),
        "down": dense_init(gen, d_up, (d,), dt, device),
    }


def init_slstm_cache(cfg: ModelConfig, spec, batch: int, max_len: int,
                     dtype: torch.dtype, device: torch.device) -> Params:
    _, nh, hd = _sdims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, nh, hd), **f32),
            "c": torch.zeros((batch, nh, hd), **f32),
            "n": torch.zeros((batch, nh, hd), **f32),
            "m": torch.full((batch, nh, hd), -1e30, **f32)}


def _slstm_scan(pre, r, state):
    """pre: (B,S,4,NH,HD) input pre-activations; r: (4,NH,HD,HD); state:
    (h, c, n, m), each (B,NH,HD).  Returns (h_t for every t (B,S,NH,HD),
    the final state).

    The loop carries head-major (NH,B,HD) states, so each step's four
    gates are one batched product over the heads, the step's input added
    in the product's epilogue (``baddbmm``, r laid out as (NH, HD, 4 HD));
    the two accumulations are ``addcmul``s.  A step is 19 ops, each a
    launch on the card."""
    nh, hd = r.shape[1], r.shape[-1]
    rr = r.permute(1, 2, 0, 3).reshape(nh, hd, 4 * hd)
    pre_t = pre.float().permute(1, 3, 0, 2, 4).flatten(3)   # (S,NH,B,4HD)
    h, c, n, m = (t.transpose(0, 1) for t in state)       # (NH,B,HD)
    ys = []
    for p_t in pre_t:
        zi, zf, zz, zo = torch.baddbmm(p_t, h, rr).unflatten(
            -1, (4, hd)).unbind(dim=2)
        logf = F.logsigmoid(zf)
        lm = logf + m
        m_new = torch.maximum(lm, zi)
        i = torch.exp(zi - m_new)
        f = torch.exp(lm - m_new)
        c = torch.addcmul(f * c, i, torch.tanh(zz))
        n = torch.addcmul(i, f, n)
        h = torch.sigmoid(zo) * c / n.clamp(min=1e-6)
        m = m_new
        ys.append(h)
    ys = torch.stack(ys, dim=0).permute(2, 0, 1, 3)       # (B,S,NH,HD)
    return ys, tuple(t.transpose(0, 1) for t in (h, c, n, m))


def apply_slstm(params: Params, cfg: ModelConfig, spec, x: torch.Tensor,
                cache: Params | None = None
                ) -> tuple[torch.Tensor, Params | None]:
    bsz, s, d = x.shape
    _, nh, hd = _sdims(cfg)
    pre = (x @ params["w_in"]).reshape(bsz, s, 4, nh, hd)
    if cache is not None:
        state = (cache["h"], cache["c"], cache["n"], cache["m"])
    else:
        zero = x.new_zeros((bsz, nh, hd), dtype=torch.float32)
        state = (zero, zero, zero, torch.full_like(zero, -1e30))
    ys, new = _slstm_scan(pre, params["r"].float(), state)
    if cache is not None:
        for key, t in zip("hcnm", new):
            cache[key].copy_(t)
    y = ys.reshape(bsz, s, d).to(x.dtype)
    y = rmsnorm(params["norm"], y, eps=cfg.norm_eps)
    a, b = (y @ params["up_gate"]).chunk(2, dim=-1)
    y = F.gelu(a, approximate="tanh") * b
    return y @ params["down"], cache
