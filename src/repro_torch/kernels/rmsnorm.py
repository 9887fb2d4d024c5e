"""Wrappers of the CUDA RMSNorm kernels, forward and backward
(``csrc/rmsnorm.cu``).

Counterpart of :mod:`repro.kernels.rmsnorm` (forward); the JAX package has
no backward kernel.  Takes CUDA tensors only; :mod:`repro_torch.kernels.ops`
sends CPU tensors to the plain versions in :mod:`repro_torch.kernels.ref`
and wires both directions into autograd.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NAME = "rmsnorm"
BWD_CTAS = 256  # most CTAs of the backward's first pass (csrc/rmsnorm.cu)


def _check(kernel: str, x: torch.Tensor, scale: torch.Tensor) -> int:
    """Check x (..., d) and scale (d,); return the row count."""
    build.check_operand(kernel, "x", x, max(x.dim(), 1), aligned=False)
    build.check_operand(kernel, "scale", scale, 1, x.dtype, aligned=False)
    d = x.shape[-1] if x.dim() else 0
    if scale.shape != (d,) or d == 0 or x.numel() == 0:
        raise ValueError(f"{kernel}: x {tuple(x.shape)}, scale "
                         f"{tuple(scale.shape)}: empty or not matching")
    return x.numel() // d


def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
                zero_centered: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (..., d); scale: (d,) in x.dtype -> (y in x.dtype, rstd (...)
    fp32, the per-row rsqrt(mean(x^2) + eps) the backward takes)."""
    build.check_no_grad(NAME, x, scale)
    rows = _check(NAME, x, scale)
    y = torch.empty_like(x)
    rstd = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build.entry(NAME, "rmsnorm_fwd")(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(), rstd.data_ptr(),
        build.DTYPE_CODES[str(x.dtype).removeprefix("torch.")], rows,
        x.shape[-1], float(eps), int(zero_centered), stream)
    build.launch_check(NAME, err)
    rmsnorm_fwd.launches += 1
    return y, rstd


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, rstd: torch.Tensor,
                g: torch.Tensor, *, zero_centered: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradients (dx in x.dtype, dscale in scale.dtype) for the output
    gradient ``g`` (x's shape and dtype) and the forward's ``rstd``."""
    build.check_no_grad(NAME, x, scale, rstd, g)
    rows = _check(NAME, x, scale)
    build.check_operand(NAME, "g", g, x.dim(), x.dtype, aligned=False)
    build.check_operand(NAME, "rstd", rstd, x.dim() - 1, torch.float32,
                        aligned=False)
    if g.shape != x.shape or rstd.shape != x.shape[:-1]:
        raise ValueError(f"{NAME}: x {tuple(x.shape)}, g {tuple(g.shape)}, "
                         f"rstd {tuple(rstd.shape)} do not match")
    d = x.shape[-1]
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    part = torch.empty((min(rows, BWD_CTAS), d), dtype=torch.float32,
                       device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build.entry(NAME, "rmsnorm_bwd")(
        x.data_ptr(), scale.data_ptr(), rstd.data_ptr(), g.data_ptr(),
        dx.data_ptr(), dscale.data_ptr(), part.data_ptr(),
        build.DTYPE_CODES[str(x.dtype).removeprefix("torch.")], rows, d,
        int(zero_centered), stream)
    build.launch_check(NAME, err)
    rmsnorm_bwd.launches += 1
    return dx, dscale


rmsnorm_fwd.launches = 0
rmsnorm_bwd.launches = 0
