"""Wrapper of the CUDA Mamba-2 SSD kernel (``csrc/mamba_chunk_scan.cu``).

Counterpart of :mod:`repro.kernels.mamba_chunk_scan`.  Takes CUDA tensors
only; :mod:`repro_torch.kernels.ops` sends CPU tensors to the plain
version in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NAME = "mamba_chunk_scan"
MAX_DIM = 128  # largest head dim and state size the kernel takes
# Rel. L2 of the bf16 kernel's y and h_final against the plain version
# that the card checks hold it to: twice the largest value that the fp32
# CUDA-core kernel (the first design, now the fp32 path) reached over
# chip_smoke.py's bf16 SSD cases, 5.924e-05 (y at (1, 128, 80, 64, 64)
# with h0; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6).
SSD_REL_L2_BF16 = 1.185e-4


def mamba_chunk_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor, d: torch.Tensor, *,
                     chunk: int = 256, h0: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,NH,HD); dt: (B,S,NH) fp32; a, d: (NH,) fp32; b, c: (B,S,NS)
    in x.dtype; h0: (B,NH,HD,NS) fp32 or None -> (y (B,S,NH,HD) in x.dtype,
    h_final (B,NH,HD,NS) fp32).  ``chunk`` is accepted for the signature of
    the JAX kernel; the CUDA kernel picks its own chunk length.  Serving
    only: it has no backward, and raises under autograd.  In bf16 the
    head dim and state size must be multiples of 8 (the tensor-core
    kernel's 16-byte rows)."""
    build.check_no_grad(NAME, x, dt, a, b, c, d, h0)
    f32 = torch.float32
    bf16 = x.dtype == torch.bfloat16
    build.check_operand(NAME, "x", x, 4, aligned=bf16)
    build.check_operand(NAME, "dt", dt, 3, f32, aligned=False)
    for arg, t in (("a", a), ("d", d)):
        build.check_operand(NAME, arg, t, 1, f32, aligned=False)
    for arg, t in (("b", b), ("c", c)):
        build.check_operand(NAME, arg, t, 3, x.dtype, aligned=bf16)
    bs, s, nh, hd = x.shape
    ns = b.shape[-1]
    if (dt.shape != (bs, s, nh) or a.shape != (nh,) or d.shape != (nh,)
            or b.shape != (bs, s, ns) or c.shape != b.shape):
        raise ValueError(f"{NAME}: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"a {tuple(a.shape)}, b {tuple(b.shape)}, "
                         f"c {tuple(c.shape)}, d {tuple(d.shape)} do not "
                         f"match")
    if not (0 < hd <= MAX_DIM and 0 < ns <= MAX_DIM):
        raise ValueError(f"{NAME}: head dim {hd} and state size {ns} must "
                         f"be in 1..{MAX_DIM}")
    if bf16 and (hd % 8 or ns % 8):
        raise ValueError(f"{NAME}: bf16 head dim {hd} and state size {ns} "
                         f"must be multiples of 8")
    if min(bs, s, nh) == 0:
        raise ValueError(f"{NAME}: empty input")
    if h0 is not None:
        build.check_operand(NAME, "h0", h0, 4, f32, aligned=False)
        if h0.shape != (bs, nh, hd, ns):
            raise ValueError(f"{NAME}: h0 {tuple(h0.shape)}, expected "
                             f"{(bs, nh, hd, ns)}")
    y = torch.empty_like(x)
    hf = torch.empty((bs, nh, hd, ns), dtype=f32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build.entry(NAME)(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), d.data_ptr(), None if h0 is None else h0.data_ptr(),
        y.data_ptr(), hf.data_ptr(),
        build.DTYPE_CODES[str(x.dtype).removeprefix("torch.")],
        bs, s, nh, hd, ns, stream)
    build.launch_check(NAME, err)
    build.count_launch(mamba_chunk_scan)
    return y, hf


mamba_chunk_scan.launches = 0
