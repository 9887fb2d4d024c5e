"""The ``mamba2`` mixer: ``in_proj`` to ``[z, x, B, C, dt]``; ``dt =
softplus(dt + dt_bias)``, ``A = -exp(a_log)``; causal depthwise conv
(width ``d_conv``) and SiLU over ``[x, B, C]``; the SSD recurrence ``h_t =
exp(dt_t A) h_{t-1} + dt_t B_t x_t``, ``y_t = C_t h_t + D x_t`` (one B, C
group; computed chunkwise, which is the same sum); ``y * silu(z)``,
RMSNorm, ``out_proj``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.lm import Ops, rmsnorm


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., L) -> (..., L, L): sum of a over (j, i] below the diagonal,
    -inf above it."""
    n = a.shape[-1]
    rep = a[..., None].expand(*a.shape, n)                 # [..., i, j] = a_i
    low = torch.tril(torch.ones(n, n, dtype=torch.bool, device=a.device),
                     -1)
    ss = torch.cumsum(rep.masked_fill(~low, 0.0), dim=-2)
    keep = torch.tril(torch.ones(n, n, dtype=torch.bool, device=a.device))
    return ss.masked_fill(~keep, float("-inf"))


def ssd(x, dt, a, bmat, cmat, chunk: int) -> torch.Tensor:
    """The SSD recurrence of the module docstring, chunkwise, with no
    initial state: x (B, S, NH, P), dt (B, S, NH), a (NH,), bmat and cmat
    (B, S, N) -> y (B, S, NH, P) without the D skip."""
    bs, s, nh, hp = x.shape
    pad = (-s) % chunk
    if pad:  # inert rows: dt = 0 (no decay), x = 0 (no input)
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    c, L = (s + pad) // chunk, chunk
    xd = (x * dt[..., None]).reshape(bs, c, L, nh, hp)
    A = (dt * a).reshape(bs, c, L, nh).permute(0, 3, 1, 2)   # B,NH,C,L
    Bc = bmat.reshape(bs, c, L, -1)
    Cc = cmat.reshape(bs, c, L, -1)
    A_cum = torch.cumsum(A, dim=-1)
    # within a chunk
    decay = torch.exp(_segsum(A))                           # B,NH,C,L,L
    cb = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    y = torch.einsum("bhcls,bcshp->bclhp", cb[:, None] * decay, xd)
    # each chunk's final state, then carried across chunks
    to_end = torch.exp(A_cum[..., -1:] - A_cum)             # B,NH,C,L
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, to_end, xd)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    across = torch.exp(_segsum(F.pad(A_cum[..., -1], (1, 0))))  # B,NH,C+1,C+1
    states = torch.einsum("bhzc,bchpn->bzhpn", across, states)[:, :-1]
    y = y + torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, states,
                         torch.exp(A_cum))
    return y.reshape(bs, c * L, nh, hp)[:, :s]


def forward(p: dict, m: dict, x: torch.Tensor, ops: Ops) -> torch.Tensor:
    mc = m["mamba"]
    b, s, d = x.shape
    di = mc["expand"] * d
    hp, ns = mc["head_dim"], mc["d_state"]
    nh = di // hp
    proj = ops.mm(x, p["in_proj"])
    z, xi, bm, cm, dt = torch.split(proj, [di, di, ns, ns, nh], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    conv_in = torch.cat([xi, bm, cm], dim=-1)
    w, k = p["conv_w"], p["conv_w"].shape[0]
    xp = F.pad(conv_in, (0, 0, k - 1, 0))
    conv = sum(xp[:, i:i + s] * w[i] for i in range(k)) + p["conv_b"]
    xi, bm, cm = torch.split(F.silu(conv), [di, ns, ns], dim=-1)
    xh = xi.reshape(b, s, nh, hp)
    y = ssd(xh, dt, a, bm, cm, mc.get("ref_chunk", 128))
    y = (y + p["d_skip"][:, None] * xh).reshape(b, s, di)
    y = rmsnorm(y * F.silu(z), p["norm"]["scale"], m["norm_eps"])
    return ops.mm(y, p["out_proj"])
