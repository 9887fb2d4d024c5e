"""The ``attn`` mixer: q, k, v projections, rotary embedding (rotate-half,
angles ``pos * theta^(-2i/hd)``), causal softmax of ``q k^T / sqrt(hd)``
with kv head ``h // (H / KV)``, output projection."""
from __future__ import annotations

import math

import torch

from perfbench.reference.lm import Ops


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); pos: (S,)."""
    hd = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = pos.float()[:, None] * freqs                   # (S, hd/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# query rows a block of the reference's attention (bounds its scores)
Q_BLOCK = 1024


def forward(p: dict, m: dict, x: torch.Tensor, ops: Ops) -> torch.Tensor:
    b, s, _ = x.shape
    h, kv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    q = ops.mm(x, p["wq"]).reshape(b, s, h, hd)
    k = ops.mm(x, p["wk"]).reshape(b, s, kv, hd)
    v = ops.mm(x, p["wv"]).reshape(b, s, kv, hd)
    pos = torch.arange(s, device=x.device)
    theta = m.get("rope_theta", 10000.0)
    q, k = rope(q, pos, theta), rope(k, pos, theta)
    k = k.repeat_interleave(h // kv, dim=2).permute(0, 2, 3, 1)  # B,H,hd,S
    v = v.repeat_interleave(h // kv, dim=2).transpose(1, 2)      # B,H,S,hd
    q = q.transpose(1, 2)                                        # B,H,S,hd
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for q0 in range(0, s, Q_BLOCK):
        q1 = min(q0 + Q_BLOCK, s)
        sc = ops.mm(q[:, :, q0:q1], k) * scale                 # B,H,q,S
        live = (torch.arange(q0, q1, device=x.device)[:, None]
                >= torch.arange(s, device=x.device)[None])
        sc = sc.masked_fill(~live, float("-inf"))
        outs.append(ops.mm(torch.softmax(sc, dim=-1), v))
    o = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, s, h * hd)
    return ops.mm(o, p["wo"])
