"""Top-level LM: embeddings -> layer groups -> final norm -> head.

Exposes the execution paths of :mod:`repro.models.model`:
  * ``forward``      - training forward (full sequence, no cache)
  * ``forward_loss`` - training forward + token cross-entropy
  * ``prefill``      - fill caches for a prompt, return last-token logits
  * ``decode_step``  - one token against the cache

``init_params`` and ``init_cache`` run on the CUDA card unless ``device``
is given.  The cache is a list (one entry per group) of per-slot trees
stacked over the repeat axis: attention slots hold ``k``/``v``, mamba2
slots ``conv`` and the fp32 ``ssm`` state.  Caches are updated in place:
``prefill`` and ``decode_step`` return the cache they were given.  Not ported yet: multi-codebook streams
(musicgen) and image embeddings (VLM).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import resolve
from repro_torch.models import blocks
from repro_torch.models.common import (dense_init, embed_init, rmsnorm,
                                       rmsnorm_init, soft_cap)
from repro_torch.models.config import ModelConfig, dtype_named, dtype_of

Params = Any


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.num_codebooks:
        raise NotImplementedError("multi-codebook models: not ported yet")
    if cfg.vision_dim:
        raise NotImplementedError("image-embedding models: not ported yet")


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device: torch.device | str | None = None) -> Params:
    """Random params from ``gen``, which must live on ``device``."""
    _check_supported(cfg)
    device = resolve(device)
    dt = dtype_of(cfg)
    p = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt, device),
        "groups": [blocks.init_group(gen, cfg, g, device)
                   for g in cfg.groups],
        "final_norm": rmsnorm_init(cfg.d_model, dt, device),
    }
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, cfg.d_model, (cfg.vocab_size,), dt,
                               device)
    return p


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device: torch.device | str | None = None) -> Params:
    device = resolve(device)
    dtype = dtype or dtype_of(cfg)
    return [blocks.init_group_cache(cfg, g, batch, max_len, dtype, device)
            for g in cfg.groups]


def _embed(params: Params, cfg: ModelConfig,
           tokens: torch.Tensor) -> torch.Tensor:
    _check_supported(cfg)
    x = params["embed"][tokens]
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _head(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    # a plain matmul outside any kernel, as the JAX model leaves it to XLA
    if "head" in params:
        logits = torch.matmul(x, params["head"])
    else:
        logits = torch.matmul(x, params["embed"].T)
    return soft_cap(logits, cfg.final_softcap or None)


def _run(params: Params, cfg: ModelConfig, x: torch.Tensor, ctx: dict,
         caches: list | None):
    for gi, gspec in enumerate(cfg.groups):
        c = None if caches is None else caches[gi]
        x, _ = blocks.apply_group(params["groups"][gi], cfg, gspec, x, ctx, c)
    x = rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)
    return x, caches


def _aux(device) -> dict:
    # the MoE statistics of the JAX model; no ported layer produces them
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return {"moe_aux_loss": zero, "moe_dropped": zero.clone()}


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor
            ) -> tuple[torch.Tensor, dict]:
    """Training forward. tokens: (B,S). Returns (logits, aux)."""
    b, s = tokens.shape[:2]
    x = _embed(params, cfg, tokens)
    ctx = {"positions": _positions(b, s, x.device)}
    x, _ = _run(params, cfg, x, ctx, None)
    return _head(params, cfg, x), _aux(x.device)


def forward_loss(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 labels: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Training forward + mean token cross-entropy.  tokens, labels: (B,S).

    As in the JAX model, only the logsumexp (over logits cast to
    ``cfg.loss_dtype``) reads the full (B,S,V) logits; the gold logit is
    the label's head row dotted with the final hidden state in fp32, not a
    gather over the vocab axis."""
    b, s = tokens.shape[:2]
    x = _embed(params, cfg, tokens)
    ctx = {"positions": _positions(b, s, x.device)}
    x, _ = _run(params, cfg, x, ctx, None)
    logits = _head(params, cfg, x)
    lse = torch.logsumexp(logits.to(dtype_named(cfg.loss_dtype)),
                          dim=-1).float()
    w = params["head"].T if "head" in params else params["embed"]  # (V,D)
    rows = w[labels]                                             # (B,S,D)
    gold = (x.float() * rows.float()).sum(-1)
    if cfg.final_softcap:
        gold = soft_cap(gold, cfg.final_softcap)
    return (lse - gold).mean(), _aux(x.device)


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: list) -> tuple[torch.Tensor, list]:
    """Fill the cache with a prompt; returns (last-token logits, cache)."""
    b, s = tokens.shape[:2]
    x = _embed(params, cfg, tokens)
    ctx = {"positions": _positions(b, s, x.device)}
    x, cache = _run(params, cfg, x, ctx, cache)
    return _head(params, cfg, x[:, -1:]), cache


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: list, pos: torch.Tensor) -> tuple[torch.Tensor, list]:
    """tokens: (B,1); pos: (B,) absolute position of the token."""
    x = _embed(params, cfg, tokens)
    ctx = {"positions": pos[:, None]}
    x, cache = _run(params, cfg, x, ctx, cache)
    return _head(params, cfg, x), cache
