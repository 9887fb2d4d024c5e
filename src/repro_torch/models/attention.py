"""Attention variants: GQA (full / sliding-window / soft-capped), DeepSeek
MLA, and gated cross-attention (VLM image layers).

Three execution modes share one code path, as in
:mod:`repro.models.attention`:
  * train:   full sequence, causal mask, no cache.
  * prefill: full sequence, causal mask, writes the KV cache.
  * decode:  q_len == 1 against a pre-filled cache at ``pos``.

Unlike the JAX version, prefill and decode write the KV cache in place and
return the same cache dict.  ``cfg.fuse_qkv`` keeps one (D, (H + 2 KV) hd)
projection ``wqkv`` in place of ``wq``/``wk``/``wv``, as the JAX version
does.  ``spec.qk_norm`` adds an RMSNorm over head_dim on q and k (leaves
``q_norm``, ``k_norm``) after the projections and before RoPE.

MLA computes its attention in plain torch, as the JAX version does in
jnp; its caches hold the normed latent ``ckv`` and the rotated shared
``krope``.  Cross-attention attends to the image embeddings through the
non-causal flash kernel; its cache holds the image keys and values,
written at prefill and read by every decode step.
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models.common import dense_init, rmsnorm, rmsnorm_init
from repro_torch.models.config import LayerSpec, ModelConfig, dtype_of
from repro_torch.parallel.annotate import hint, local_matmul, matmul

Params = Any


def init_attn(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
              device: torch.device) -> Params:
    dt = dtype_of(cfg)
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cfg.fuse_qkv:
        p = {"wqkv": dense_init(gen, d, ((h + 2 * kv) * hd,), dt, device),
             "wo": dense_init(gen, h * hd, (d,), dt, device)}
    else:
        p = {
            "wq": dense_init(gen, d, (h * hd,), dt, device),
            "wk": dense_init(gen, d, (kv * hd,), dt, device),
            "wv": dense_init(gen, d, (kv * hd,), dt, device),
            "wo": dense_init(gen, h * hd, (d,), dt, device),
        }
    if spec.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dt, device)
        p["k_norm"] = rmsnorm_init(hd, dt, device)
    return p


def init_attn_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                    max_len: int, dtype: torch.dtype,
                    device: torch.device) -> Params:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _attn_scale(cfg: ModelConfig) -> float:
    if cfg.attn_scale > 0:
        return cfg.attn_scale
    return 1.0 / math.sqrt(cfg.head_dim)


def apply_attn(params: Params, cfg: ModelConfig, spec: LayerSpec,
               x: torch.Tensor, positions: torch.Tensor,
               cache: Params | None = None
               ) -> tuple[torch.Tensor, Params | None]:
    """x: (B, S, D); positions: (B, S) absolute positions.

    When ``cache`` is given and S > 1 this is prefill (cache written at
    [0, S)); when S == 1 it is a decode step at ``positions[:, 0]``.
    """
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if "wqkv" in params:  # one projection matmul instead of three
        q, k, v = torch.split(
            matmul(x, hint(params["wqkv"], "wt_d", "heads_out")),
            [h * hd, kv * hd, kv * hd], dim=-1)
    else:
        q = matmul(x, hint(params["wq"], "wt_d", "heads_out"))
        k = matmul(x, hint(params["wk"], "wt_d", "kv_out"))
        v = matmul(x, hint(params["wv"], "wt_d", "kv_out"))
    q = hint(q.reshape(b, s, h, hd), "batch", "attn_seq", "heads", None)
    k = hint(k.reshape(b, s, kv, hd), "batch", "seq", "kv_heads", None)
    v = hint(v.reshape(b, s, kv, hd), "batch", "seq", "kv_heads", None)
    if spec.qk_norm:
        q = rmsnorm(params["q_norm"], q, eps=cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, eps=cfg.norm_eps)
    q = common.apply_rope(q, positions, theta=cfg.rope_theta)
    k = common.apply_rope(k, positions, theta=cfg.rope_theta)

    scale = _attn_scale(cfg)
    softcap = cfg.attn_softcap or None
    window = spec.window or None

    if cache is None or s > 1:  # train, or prefill
        if cache is not None:
            _write_prefix(cache["k"], k)
            _write_prefix(cache["v"], v)
        out = ops.flash_attention(q, k, v, causal=True, window=window,
                                  softcap=softcap, scale=scale)
        return _out_proj(params, out, b, s), cache

    # decode: write (k, v) at pos then attend to the whole cache with a
    # validity mask (<= pos, > pos - window).
    pos = positions[:, 0]  # (B,)
    _scatter_time(cache["k"], k[:, 0], pos)
    _scatter_time(cache["v"], v[:, 0], pos)
    out = ops.decode_attention(q, cache["k"], cache["v"],
                               lengths=(pos + 1).to(torch.int32),
                               window=window, softcap=softcap, scale=scale)
    return _out_proj(params, out, b, s), cache


def _out_proj(params: Params, out: torch.Tensor, b: int,
              s: int) -> torch.Tensor:
    out = hint(out, "batch", "attn_seq", "heads", None).reshape(b, s, -1)
    wo = hint(params["wo"], "heads_out", "wt_d")
    if isinstance(out, DTensor):  # back in the residual stream's layout
        return hint(local_matmul(out, wo), "batch", "seq", "embed")
    return out @ wo


def _write_prefix(buf: torch.Tensor, val: torch.Tensor) -> None:
    """buf: (B, T, ...), val: (B, S, ...) with S <= T: writes val at
    positions [0, S) in place.  A DTensor buf sharded on T is written shard
    by shard (DTensor would slice a copy of it): val, placed as buf but
    whole on S, gives each rank the rows of its positions."""
    if not isinstance(buf, DTensor):
        buf[:, :val.shape[1]].copy_(val)
        return
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = buf.device_mesh
    pls = tuple(Replicate() if p.is_shard(1) else p for p in buf.placements)
    if not isinstance(val, DTensor):
        val = DTensor.from_local(val, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    if tuple(val.placements) != pls:
        val = val.redistribute(mesh, pls)
    shape, off = compute_local_shape_and_global_offset(
        buf.shape, mesh, buf.placements)
    lo, hi = off[1], min(off[1] + shape[1], val.shape[1])
    if hi > lo:
        buf.to_local()[:, :hi - lo].copy_(val.to_local()[:, lo:hi])


def _scatter_time(buf: torch.Tensor, val: torch.Tensor,
                  pos: torch.Tensor) -> None:
    """buf: (B, S, ...), val: (B, ...), pos: (B,): writes val at pos in
    place (the JAX version returns an updated copy).  A DTensor buf is
    written shard by shard: each rank writes the rows whose position falls
    in its shard of S (val and pos are first placed to match buf)."""
    from torch.distributed.tensor import DTensor
    if isinstance(buf, DTensor):
        return _scatter_time_sharded(buf, val, pos)
    b = buf.shape[0]
    buf[torch.arange(b, device=buf.device), pos] = val.to(buf.dtype)


def _scatter_time_sharded(buf, val, pos) -> None:
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = buf.device_mesh

    def like(p):  # buf's placement of a dim, for val (B, ...) without S
        if p.is_shard() and p.dim != 1:
            return Shard(p.dim - 1 if p.dim > 1 else 0)
        return Replicate()

    def placed(t, pls):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t if tuple(t.placements) == tuple(pls) else \
            t.redistribute(mesh, pls)

    val = placed(val, [like(p) for p in buf.placements])
    pos = placed(pos, [p if p == Shard(0) else Replicate()
                       for p in buf.placements])
    shape, off = compute_local_shape_and_global_offset(
        buf.shape, mesh, buf.placements)
    bl, vl, pl = buf.to_local(), val.to_local(), pos.to_local() - off[1]
    rows = torch.arange(bl.shape[0], device=bl.device)
    mine = (pl >= 0) & (pl < shape[1])
    at = torch.where(mine, pl, 0)
    old = bl[rows, at]
    bl[rows, at] = torch.where(
        mine.reshape(-1, *([1] * (vl.dim() - 1))), vl.to(bl.dtype), old)


# ---------------------------------------------------------------------------
# DeepSeek-V3 Multi-head Latent Attention (MLA)
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
             device: torch.device) -> Params:
    dt = dtype_of(cfg)
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qd = m.nope_head_dim + m.rope_head_dim
    return {
        "wq_a": dense_init(gen, d, (m.q_lora_rank,), dt, device),
        "q_norm": rmsnorm_init(m.q_lora_rank, dt, device),
        "wq_b": dense_init(gen, m.q_lora_rank, (h * qd,), dt, device),
        "wkv_a": dense_init(gen, d, (m.kv_lora_rank + m.rope_head_dim,), dt,
                            device),
        "kv_norm": rmsnorm_init(m.kv_lora_rank, dt, device),
        "wk_b": dense_init(gen, m.kv_lora_rank, (h * m.nope_head_dim,), dt,
                           device),
        "wv_b": dense_init(gen, m.kv_lora_rank, (h * m.v_head_dim,), dt,
                           device),
        "wo": dense_init(gen, h * m.v_head_dim, (d,), dt, device),
    }


def init_mla_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                   max_len: int, dtype: torch.dtype,
                   device: torch.device) -> Params:
    m = cfg.mla
    return {"ckv": torch.zeros((batch, max_len, m.kv_lora_rank),
                               dtype=dtype, device=device),
            "krope": torch.zeros((batch, max_len, m.rope_head_dim),
                                 dtype=dtype, device=device)}


def _mla_attend_block(cfg: ModelConfig, q_nope, q_rope, ckv, krope,
                      wk_b, wv_b, mask, absorbed: bool) -> torch.Tensor:
    """One dense block of latent attention.

    q_nope: (B,S,H,dn)  q_rope: (B,S,H,dr)  ckv: (B,T,r)  krope: (B,T,dr)
    mask: broadcastable to (B,S,T), True where a query attends.

    ``absorbed`` folds wk_b / wv_b into the query and output sides, so
    the per-position work stays in the latent space; otherwise K and V
    are expanded per head (DeepSeek's naive form).
    """
    m = cfg.mla
    h = cfg.num_heads
    scale = 1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim)
    if absorbed:
        wk = wk_b.reshape(m.kv_lora_rank, h, m.nope_head_dim)
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope, wk)
        scores = torch.einsum("bshr,btr->bhst", q_lat, ckv)
        scores = scores + torch.einsum("bshr,btr->bhst", q_rope, krope)
        scores = scores.float() * scale
        scores = torch.where(mask[:, None], scores, -1e30)
        p = torch.softmax(scores, dim=-1).to(ckv.dtype)
        ctx = torch.einsum("bhst,btr->bshr", p, ckv)  # latent context
        wv = wv_b.reshape(m.kv_lora_rank, h, m.v_head_dim)
        return torch.einsum("bshr,rhv->bshv", ctx, wv)
    b, t = ckv.shape[:2]
    k_nope = (ckv @ wk_b).reshape(b, t, h, m.nope_head_dim)
    value = (ckv @ wv_b).reshape(b, t, h, m.v_head_dim)
    scores = torch.einsum("bshn,bthn->bhst", q_nope, k_nope)
    scores = scores + torch.einsum("bshr,btr->bhst", q_rope, krope)
    scores = scores.float() * scale
    scores = torch.where(mask[:, None], scores, -1e30)
    p = torch.softmax(scores, dim=-1).to(value.dtype)
    return torch.einsum("bhst,bthv->bshv", p, value)


_MLA_BLOCK_THRESHOLD = 8192
_MLA_Q_BLOCK = 1024


def _mla_attend_causal(cfg: ModelConfig, q_nope, q_rope, ckv, krope,
                       wk_b, wv_b, absorbed: bool) -> torch.Tensor:
    """Causal latent attention; past ``_MLA_BLOCK_THRESHOLD`` queries it
    runs in blocks of ``_MLA_Q_BLOCK``, each against the keys up to its
    last query, so the (S, T) scores never materialise whole."""
    s, t = q_nope.shape[1], ckv.shape[1]
    dev = q_nope.device
    if s <= _MLA_BLOCK_THRESHOLD:
        mask = (torch.arange(s, device=dev)[:, None]
                >= torch.arange(t, device=dev)[None, :])[None]
        return _mla_attend_block(cfg, q_nope, q_rope, ckv, krope, wk_b,
                                 wv_b, mask, absorbed)
    assert s % _MLA_Q_BLOCK == 0
    outs = []
    for qs in range(0, s, _MLA_Q_BLOCK):
        hi = min(t, qs + _MLA_Q_BLOCK)
        mask = ((torch.arange(_MLA_Q_BLOCK, device=dev)[:, None] + qs)
                >= torch.arange(hi, device=dev)[None, :])[None]
        outs.append(_mla_attend_block(
            cfg, q_nope[:, qs:qs + _MLA_Q_BLOCK],
            q_rope[:, qs:qs + _MLA_Q_BLOCK], ckv[:, :hi], krope[:, :hi],
            wk_b, wv_b, mask, absorbed))
    return torch.cat(outs, dim=1)


def _mla_sharded(cfg: ModelConfig, q_nope, q_rope, ckv, krope, wk_b, wv_b,
                 *rest):
    """MLA's attention on DTensors, each rank on its own batch rows and
    query heads (``local_map``): the latents ``ckv``/``krope`` (and the
    decode mask) whole on every rank that holds heads (a cache whose
    latent dim is sharded is gathered), the up-projections ``wk_b``/
    ``wv_b`` sharded by the same heads.  DTensor's own einsums would
    flatten a batch and a head dim sharded on two mesh dims, which
    PyTorch before 2.13 refuses.  ``rest``: (absorbed,) for the causal
    form, (mask, absorbed) for a decode step."""
    import dataclasses

    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh, qpl = q_nope.device_mesh, tuple(q_nope.placements)
    if any(p.is_shard() and p.dim not in (0, 2) for p in qpl):
        raise NotImplementedError(f"MLA on DTensors: q placed {qpl}")
    rows = tuple(p if p == Shard(0) else Replicate() for p in qpl)
    cols = tuple(Shard(1) if p == Shard(2) else Replicate() for p in qpl)

    def placed(t, pls):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t if tuple(t.placements) == pls else t.redistribute(mesh, pls)

    q_rope = placed(q_rope, qpl)
    ckv, krope = placed(ckv, rows), placed(krope, rows)
    wk_b, wv_b = placed(wk_b, cols), placed(wv_b, cols)
    heads = q_nope.to_local().shape[2]
    lcfg = dataclasses.replace(cfg, num_heads=heads)
    g_rows = tuple(Partial() if p == Shard(2) else p for p in rows)
    g_cols = tuple(Partial() if p == Shard(0) else c
                   for p, c in zip(qpl, cols))
    args = [q_nope, q_rope, ckv, krope, wk_b, wv_b]
    pls, gpls = [qpl, qpl, rows, rows, cols, cols], \
        [qpl, qpl, g_rows, g_rows, g_cols, g_cols]
    if len(rest) == 2:  # a decode step's mask (B,1,T)
        args.append(placed(rest[0], rows))
        pls.append(rows)
        gpls.append(rows)
        attend = _mla_attend_block
    else:
        attend = _mla_attend_causal
    absorbed = rest[-1]
    return local_map(lambda *t: attend(lcfg, *t, absorbed),
                     out_placements=list(qpl), in_placements=tuple(pls),
                     in_grad_placements=tuple(gpls),
                     device_mesh=mesh)(*args)


def apply_mla(params: Params, cfg: ModelConfig, spec: LayerSpec,
              x: torch.Tensor, positions: torch.Tensor,
              cache: Params | None = None, *,
              absorbed: bool = False) -> tuple[torch.Tensor, Params | None]:
    """Train, prefill or decode as :func:`apply_attn`; the cache (``ckv``,
    ``krope``) is written in place."""
    b, s, _ = x.shape
    m = cfg.mla
    h = cfg.num_heads
    q = rmsnorm(params["q_norm"], x @ hint(params["wq_a"], "wt_d", None),
                eps=cfg.norm_eps)
    q = (q @ hint(params["wq_b"], None, "heads_out")).reshape(
        b, s, h, m.nope_head_dim + m.rope_head_dim)
    q = hint(q, "batch", "attn_seq", "heads", None)
    q_nope, q_rope = torch.split(q, [m.nope_head_dim, m.rope_head_dim],
                                 dim=-1)
    q_rope = common.apply_rope(q_rope, positions, theta=cfg.rope_theta)

    ckv, krope = torch.split(x @ hint(params["wkv_a"], "wt_d", None),
                             [m.kv_lora_rank, m.rope_head_dim], dim=-1)
    ckv = rmsnorm(params["kv_norm"], ckv, eps=cfg.norm_eps)
    krope = common.apply_rope(krope[:, :, None], positions,
                              theta=cfg.rope_theta)[:, :, 0]

    if cache is None or s > 1:  # train, or prefill
        if cache is not None:
            _write_prefix(cache["ckv"], ckv)
            _write_prefix(cache["krope"], krope)
        attend = (_mla_sharded if isinstance(q_nope, DTensor)
                  else _mla_attend_causal)
        out = attend(cfg, q_nope, q_rope, ckv, krope,
                     hint(params["wk_b"], None, "heads_out"),
                     hint(params["wv_b"], None, "heads_out"), absorbed)
        return out.reshape(b, s, -1) @ hint(params["wo"], "heads_out",
                                            "wt_d"), cache

    pos = positions[:, 0]
    _scatter_time(cache["ckv"], ckv[:, 0], pos)
    _scatter_time(cache["krope"], krope[:, 0], pos)
    t = cache["ckv"].shape[1]
    mask = torch.arange(t, device=x.device)[None, None, :] \
        <= pos[:, None, None]                                   # (B,1,T)
    attend = (_mla_sharded if isinstance(q_nope, DTensor)
              else _mla_attend_block)
    out = attend(cfg, q_nope, q_rope, cache["ckv"], cache["krope"],
                 params["wk_b"], params["wv_b"], mask, absorbed)
    return out.reshape(b, s, -1) @ hint(params["wo"], "heads_out",
                                        "wt_d"), cache


# ---------------------------------------------------------------------------
# Gated cross-attention (VLM image layers; the vision frontend is a stub)
# ---------------------------------------------------------------------------

def init_cross_attn(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
                    device: torch.device) -> Params:
    dt = dtype_of(cfg)
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, d, (h * hd,), dt, device),
        "wk": dense_init(gen, cfg.vision_dim, (kv * hd,), dt, device),
        "wv": dense_init(gen, cfg.vision_dim, (kv * hd,), dt, device),
        "wo": dense_init(gen, h * hd, (d,), dt, device),
        "gate": torch.zeros((), dtype=dt, device=device),
        "q_norm": rmsnorm_init(hd, dt, device),
        "k_norm": rmsnorm_init(hd, dt, device),
    }


def init_cross_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, dtype: torch.dtype,
                     device: torch.device) -> Params:
    shape = (batch, cfg.num_image_tokens, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "filled": torch.zeros((), dtype=torch.int32, device=device)}


def apply_cross_attn(params: Params, cfg: ModelConfig, spec: LayerSpec,
                     x: torch.Tensor, image_embeds: torch.Tensor | None,
                     cache: Params | None = None
                     ) -> tuple[torch.Tensor, Params | None]:
    """x: (B,S,D); image_embeds: (B, N_img, vision_dim), or None at a
    decode step, which reads K/V from the cache that prefill filled (in
    place).  The output is gated by tanh(gate).  K and V are projected in
    the promoted dtype of the embeddings and the weights, as JAX's einsum
    does (a training batch carries fp32 embeddings), then cast to x's
    dtype: the flash kernel takes one dtype."""
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = matmul(x, hint(params["wq"], "wt_d", "heads_out")).reshape(
        b, s, h, hd)
    q = hint(q, "batch", "attn_seq", "heads", None)
    q = rmsnorm(params["q_norm"], q, eps=cfg.norm_eps)

    if image_embeds is not None:
        def project(w):
            dt = torch.promote_types(image_embeds.dtype, w.dtype)
            return (image_embeds.to(dt) @ w.to(dt)).to(x.dtype).reshape(
                b, -1, kv, hd)
        k = rmsnorm(params["k_norm"],
                    project(hint(params["wk"], "wt_d", "kv_out")),
                    eps=cfg.norm_eps)
        v = project(hint(params["wv"], "wt_d", "kv_out"))
        if cache is not None:
            cache["k"].copy_(k)
            cache["v"].copy_(v)
            cache["filled"].fill_(1)
    else:
        assert cache is not None, "decode cross-attn needs a filled cache"
        k, v = cache["k"], cache["v"]

    out = ops.flash_attention(q, k, v, causal=False, window=None,
                              softcap=None, scale=1.0 / math.sqrt(hd))
    out = _out_proj(params, out, b, s)
    gate = torch.tanh(params["gate"].float()).to(out.dtype)
    return out * gate, cache
