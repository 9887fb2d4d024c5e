"""Top-level LM: embeddings -> layer groups -> final norm -> head(s).

Exposes the execution paths of :mod:`repro.models.model`:
  * ``forward``      - training forward (full sequence, no cache)
  * ``forward_loss`` - training forward + token cross-entropy
  * ``prefill``      - fill caches for a prompt, return last-token logits
  * ``decode_step``  - one token against the cache

``init_params`` and ``init_cache`` run on the CUDA card unless ``device``
is given.  The cache is a list (one entry per group) of per-slot trees
stacked over the repeat axis: attention slots hold ``k``/``v``, mamba2
slots ``conv`` and the fp32 ``ssm`` state, mLSTM slots the fp32 ``c``/``n``
and sLSTM slots the fp32 ``h``/``c``/``n``/``m``.  Caches are updated in
place: ``prefill`` and ``decode_step`` return the cache they were given.
MusicGen-style multi-codebook streams (``num_codebooks`` K): tokens are
(B,S,K), the embeddings (K,V,D) are summed over the codebooks, the head
(K,D,V) gives (B,S,K,V) logits and the loss averages over the K streams.
VLM image embeddings (B, N_img, vision_dim), the output of a stubbed
vision frontend, go to the cross-attention layers through ``forward``,
``forward_loss`` and ``prefill``; a decode step reads their keys and
values from the cache (``k``/``v``, with ``filled``).  MLA slots cache
``ckv``/``krope``; ``mla_absorbed`` picks MLA's weight-absorbed form.
The aux dict holds the MoE layers' ``moe_aux_loss`` and ``moe_dropped``
summed over every layer (zeros without MoE).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import resolve
from repro_torch.models import blocks
from repro_torch.models.common import (dense_init, embed_init, rmsnorm,
                                       rmsnorm_init, soft_cap)
from repro_torch.models.config import ModelConfig, dtype_named, dtype_of
from repro_torch.parallel.annotate import hint, matmul

Params = Any


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device: torch.device | str | None = None) -> Params:
    """Random params from ``gen``, which must live on ``device``."""
    device = resolve(device)
    dt = dtype_of(cfg)
    k = cfg.num_codebooks

    def per_codebook(init):  # (K, ...) with K codebooks, else one
        return torch.stack([init() for _ in range(k)]) if k else init()

    p = {
        "embed": per_codebook(lambda: embed_init(
            gen, cfg.vocab_size, cfg.d_model, dt, device)),
        "groups": [blocks.init_group(gen, cfg, g, device)
                   for g in cfg.groups],
        "final_norm": rmsnorm_init(cfg.d_model, dt, device),
    }
    if not cfg.tie_embeddings:
        p["head"] = per_codebook(lambda: dense_init(
            gen, cfg.d_model, (cfg.vocab_size,), dt, device))
    return p


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device: torch.device | str | None = None) -> Params:
    device = resolve(device)
    dtype = dtype or dtype_of(cfg)
    return [blocks.init_group_cache(cfg, g, batch, max_len, dtype, device)
            for g in cfg.groups]


def abstract_params(cfg: ModelConfig) -> Params:
    """The param tree on the ``meta`` device: shapes and dtypes, nothing
    allocated (JAX's ``eval_shape`` of ``init_params``)."""
    return init_params(torch.Generator(), cfg, "meta")


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=None) -> Params:
    """The cache tree of :func:`init_cache` on the ``meta`` device."""
    return init_cache(cfg, batch, max_len, dtype, "meta")


def _embed(params: Params, cfg: ModelConfig,
           tokens: torch.Tensor) -> torch.Tensor:
    if cfg.num_codebooks and is_dtensor(params["embed"]):
        x = sum(_rows(params["embed"][i], tokens[..., i])
                for i in range(cfg.num_codebooks))
    elif cfg.num_codebooks:
        # tokens (B,S,K): the sum of the K codebooks' embeddings
        book = torch.arange(cfg.num_codebooks, device=tokens.device)
        x = params["embed"][book, tokens].sum(dim=2)
    else:
        x = _rows(params["embed"], tokens)
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return hint(x, "batch", "seq", "embed")


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``; a DTensor table goes through ``F.embedding``, which
    DTensor takes with the vocab (rows) sharded: each rank looks up its
    rows and an all-reduce sums the masked results (here, at once: the
    masked partial sum cannot be saved for the backward)."""
    if is_dtensor(table):
        out = torch.nn.functional.embedding(idx, table)
        from torch.distributed.tensor import Replicate
        return out.redistribute(out.device_mesh, [
            Replicate() if p.is_partial() else p for p in out.placements])
    return table[idx]


def _logsumexp(x: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last dim.  Over a DTensor whose last dim (the
    vocab) is sharded, each rank takes the logsumexp of its shard
    (``local_map``), and the logsumexp of those partial ones (one value a
    shard and token) is taken across the shards: no logit leaves its
    rank."""
    if not is_dtensor(x):
        return torch.logsumexp(x, dim=-1)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    last = x.ndim - 1
    if any(p.is_partial() for p in x.placements):
        x = x.redistribute(x.device_mesh, [
            Replicate() if p.is_partial() else p for p in x.placements])
    part = local_map(
        lambda xl: torch.logsumexp(xl, dim=-1, keepdim=True),
        out_placements=[Shard(last) if p.is_shard(last) else p
                        for p in x.placements],
        in_placements=(x.placements,), device_mesh=x.device_mesh)(x)
    top = part.amax(dim=-1, keepdim=True).detach()
    return (top + torch.log(torch.exp(part - top).sum(
        dim=-1, keepdim=True))).squeeze(-1)


def _head(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    # a plain matmul outside any kernel, as the JAX model leaves it to XLA
    if cfg.num_codebooks:  # (B,S,K,V)
        w = params["head"] if "head" in params else \
            params["embed"].transpose(1, 2)                  # (K,D,V)
        if is_dtensor(w):  # a product a codebook: the einsum would
            # flatten (K, V) with V sharded, which PyTorch 2.11 refuses
            logits = torch.stack([matmul(x, w[i])
                                  for i in range(w.shape[0])], dim=2)
        else:
            logits = torch.einsum("bsd,kdv->bskv", x, w)
    elif "head" in params:
        logits = matmul(x, params["head"])
    else:
        logits = matmul(x, params["embed"].T)
    axes = (("batch", "seq", None, "vocab") if cfg.num_codebooks
            else ("batch", "seq", "vocab"))
    return soft_cap(hint(logits, *axes), cfg.final_softcap or None)


def _run(params: Params, cfg: ModelConfig, x: torch.Tensor, ctx: dict,
         caches: list | None):
    """The groups and the final norm: (x, caches, aux), aux the sums of
    every layer's MoE statistics (``blocks.ZERO_AUX``'s floats where the
    model has no MoE)."""
    aux = dict(blocks.ZERO_AUX)
    for gi, gspec in enumerate(cfg.groups):
        c = None if caches is None else caches[gi]
        x, _, ga = blocks.apply_group(params["groups"][gi], cfg, gspec, x,
                                      ctx, c)
        aux = {k: aux[k] + ga[k] for k in aux}
    x = rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)
    return x, caches, aux


def _aux_tensors(aux: dict, device) -> dict:
    """The MoE statistics as fp32 scalars on ``device``, zeros where the
    model has no MoE, as the JAX model returns them."""
    return {k: v if torch.is_tensor(v) else
            torch.zeros((), dtype=torch.float32, device=device)
            for k, v in aux.items()}


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            image_embeds: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, dict]:
    """Training forward. tokens: (B,S) or (B,S,K). Returns (logits,
    aux)."""
    b, s = tokens.shape[:2]
    x = _embed(params, cfg, tokens)
    ctx = {"positions": _positions(b, s, x.device),
           "image_embeds": image_embeds, "moe_stats": True}
    x, _, aux = _run(params, cfg, x, ctx, None)
    return _head(params, cfg, x), _aux_tensors(aux, x.device)


def forward_loss(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 labels: torch.Tensor,
                 image_embeds: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, dict]:
    """Training forward + mean token cross-entropy.  tokens, labels: (B,S),
    or (B,S,K) with K codebooks (the mean runs over the streams too).

    As in the JAX model, only the logsumexp (over logits cast to
    ``cfg.loss_dtype``) reads the full (B,S,V) or (B,S,K,V) logits; the
    gold logit is the label's head row dotted with the final hidden state
    in fp32, not a gather over the vocab axis."""
    b, s = tokens.shape[:2]
    x = _embed(params, cfg, tokens)
    ctx = {"positions": _positions(b, s, x.device),
           "image_embeds": image_embeds, "moe_stats": True}
    x, _, aux = _run(params, cfg, x, ctx, None)
    logits = _head(params, cfg, x)
    lse = _logsumexp(logits.to(dtype_named(cfg.loss_dtype))).float()
    if cfg.num_codebooks:
        w = params["head"].transpose(1, 2) if "head" in params \
            else params["embed"]                                 # (K,V,D)
        if is_dtensor(w):
            rows = torch.stack([_rows(w[i], labels[..., i])
                                for i in range(cfg.num_codebooks)], dim=2)
        else:
            book = torch.arange(cfg.num_codebooks, device=labels.device)
            rows = w[book, labels]                               # (B,S,K,D)
        gold = (x.float()[:, :, None] * rows.float()).sum(-1)   # (B,S,K)
    else:
        w = params["head"].T if "head" in params else params["embed"]
        rows = _rows(w, labels)                                  # (B,S,D)
        gold = (x.float() * rows.float()).sum(-1)
    if cfg.final_softcap:
        gold = soft_cap(gold, cfg.final_softcap)
    return (lse - gold).mean(), _aux_tensors(aux, x.device)


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: list, image_embeds: torch.Tensor | None = None,
            mla_absorbed: bool = False) -> tuple[torch.Tensor, list]:
    """Fill the cache with a prompt; returns (last-token logits, cache)."""
    b, s = tokens.shape[:2]
    x = _embed(params, cfg, tokens)
    ctx = {"positions": _positions(b, s, x.device),
           "image_embeds": image_embeds, "mla_absorbed": mla_absorbed}
    x, cache, _ = _run(params, cfg, x, ctx, cache)
    return _head(params, cfg, x[:, -1:]), cache


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: list, pos: torch.Tensor,
                mla_absorbed: bool = False) -> tuple[torch.Tensor, list]:
    """tokens: (B,1) or (B,1,K); pos: (B,) absolute position of the
    token."""
    x = _embed(params, cfg, tokens)
    ctx = {"positions": pos[:, None], "image_embeds": None,
           "mla_absorbed": mla_absorbed}
    x, cache, _ = _run(params, cfg, x, ctx, cache)
    return _head(params, cfg, x), cache
