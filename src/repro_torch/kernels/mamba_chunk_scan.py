"""Wrappers of the CUDA Mamba-2 SSD kernels: the forward
(``csrc/mamba_chunk_scan.cu``) and its backward
(``csrc/mamba_chunk_scan_bwd.cu``).

Counterpart of :mod:`repro.kernels.mamba_chunk_scan`.  Takes CUDA tensors
only; :mod:`repro_torch.kernels.ops` sends CPU tensors to the plain
versions in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NAME = "mamba_chunk_scan"
BWD_NAME = "mamba_chunk_scan_bwd"
MAX_DIM = 128  # largest head dim and state size the kernels take
MAX_SMEM = 232448  # bytes of shared memory a CTA may use on the H100
# Rel. L2 of the bf16 kernel's y and h_final against the plain version
# that the card checks hold it to: twice the largest value that the fp32
# CUDA-core kernel (the first design, now the fp32 path) reached over
# chip_smoke.py's bf16 SSD cases, 5.924e-05 (y at (1, 128, 80, 64, 64)
# with h0; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6).
SSD_REL_L2_BF16 = 1.185e-4
# Rel. L2 of each bf16 output of the backward kernel (dx, ddt, da, db, dc,
# dd, dh0) against the plain backward that the card checks hold it to:
# twice the largest value that chip_smoke.py's bf16 backward cases reached
# in the kernel's first runs, 8.237e-05 (dc at (2, 200, 3, 64, 64); NVIDIA
# H100 80GB HBM3, 700.00 W; PERF.md section 6).  Its products are exact
# fp32 FMAs; the error is the bf16 rounding of dx, db and dc against
# another fp32 summation order.
SSD_BWD_REL_L2_BF16 = 1.647e-4


def mamba_chunk_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor, d: torch.Tensor, *,
                     chunk: int = 256, h0: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,NH,HD); dt: (B,S,NH) fp32; a, d: (NH,) fp32; b, c: (B,S,NS)
    in x.dtype; h0: (B,NH,HD,NS) fp32 or None -> (y (B,S,NH,HD) in x.dtype,
    h_final (B,NH,HD,NS) fp32).  ``chunk`` is accepted for the signature of
    the JAX kernel; the CUDA kernel picks its own chunk length.  It raises
    under autograd: a gradient goes through ``ops.mamba_chunk_scan``,
    whose backward is :func:`mamba_chunk_scan_bwd`.  In bf16 the head dim
    and state size must be multiples of 8 (the tensor-core kernel's
    16-byte rows)."""
    build.check_no_grad(NAME, x, dt, a, b, c, d, h0)
    bs, s, nh, hd, ns = _check(NAME, x, dt, a, b, c, d, h0)
    y = torch.empty_like(x)
    hf = torch.empty((bs, nh, hd, ns), dtype=torch.float32,
                     device=x.device)
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


def _check(kernel, x, dt, a, b, c, d, h0):
    """Raise on what the SSD kernels do not take; returns (B, S, NH, HD,
    NS)."""
    f32 = torch.float32
    bf16 = x.dtype == torch.bfloat16
    build.check_operand(kernel, "x", x, 4, aligned=bf16)
    build.check_operand(kernel, "dt", dt, 3, f32, aligned=False)
    for arg, t in (("a", a), ("d", d)):
        build.check_operand(kernel, arg, t, 1, f32, aligned=False)
    for arg, t in (("b", b), ("c", c)):
        build.check_operand(kernel, arg, t, 3, x.dtype, aligned=bf16)
    bs, s, nh, hd = x.shape
    ns = b.shape[-1]
    if (dt.shape != (bs, s, nh) or a.shape != (nh,) or d.shape != (nh,)
            or b.shape != (bs, s, ns) or c.shape != b.shape):
        raise ValueError(f"{kernel}: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)}, d "
                         f"{tuple(d.shape)} do not match")
    if not (0 < hd <= MAX_DIM and 0 < ns <= MAX_DIM):
        raise ValueError(f"{kernel}: head dim {hd} and state size {ns} must "
                         f"be in 1..{MAX_DIM}")
    if bf16 and (hd % 8 or ns % 8):
        raise ValueError(f"{kernel}: bf16 head dim {hd} and state size {ns} "
                         f"must be multiples of 8")
    if min(bs, s, nh) == 0:
        raise ValueError(f"{kernel}: empty input")
    if h0 is not None:
        build.check_operand(kernel, "h0", h0, 4, f32, aligned=False)
        if h0.shape != (bs, nh, hd, ns):
            raise ValueError(f"{kernel}: h0 {tuple(h0.shape)}, expected "
                             f"{(bs, nh, hd, ns)}")
    return bs, s, nh, hd, ns


def bwd_smem_bytes(q: int, hd: int, ns: int) -> int:
    """Shared memory of the fp32 backward kernel at chunk length ``q``
    (``smem_floats`` in csrc/mamba_chunk_scan_bwd.cu): x and dy rows, B and
    C rows, the state and dH, three (q, q) tiles, nine q-vectors and ten
    scalars, in fp32 with rows padded by one."""
    return 4 * (2 * q * (hd + 1) + 2 * q * (ns + 1) + 2 * hd * (ns + 1)
                + 3 * q * (q + 1) + 9 * q + 10)


def bwd_chunk(hd: int, ns: int) -> int:
    """The fp32 backward kernel's chunk length: 64 where its shared memory
    fits a CTA, else 32 (HD = NS = 128)."""
    return 64 if bwd_smem_bytes(64, hd, ns) <= MAX_SMEM else 32


BWD_Q = 64       # the bf16 backward's chunk length
BWD_GROUP = 8    # heads a CTA of the bf16 backward, where NS <= 64
BWD_SEGMENT = 8  # chunks a segment of the bf16 backward's state walks


def bwd_sm90_smem_bytes(hd: int, ns: int, g: int) -> int:
    """Shared memory of the bf16 backward's chunk kernel with ``g`` heads a
    CTA (``ChunkSmem::bytes`` in csrc/mamba_chunk_scan_bwd.cu): x, dy, B
    and C tiles and the state's three terms in bf16, padded to 64 or 128;
    in fp32 C B^T (rows padded by four), seven 64-vectors, eight scalars,
    the next state's two parts where they are staged (HD, NS <= 64), and
    the group's dt and two decays a head."""
    hdp, nsp = (64 if n <= 64 else 128 for n in (hd, ns))
    q, ht = BWD_Q, hdp * nsp
    return (2 * (2 * q * hdp + 2 * q * nsp + 3 * ht)
            + 4 * (q * (q + 4) + 7 * q + 8
                   + (2 * ht if ht <= 64 * 64 else 0) + g * (q + 2)))


def bwd_group(nh: int, hd: int, ns: int) -> int:
    """Heads a CTA of the bf16 backward: ``BWD_GROUP`` (at most ``nh``)
    where NS <= 64, whose db and dc the kernel sums over the group in
    registers; one head at a larger NS."""
    return min(BWD_GROUP, nh) if ns <= 64 else 1


def mamba_chunk_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                         b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                         dy: torch.Tensor, dh_final: torch.Tensor | None,
                         h0: torch.Tensor | None = None):
    """Gradients of :func:`mamba_chunk_scan` for the output gradients ``dy``
    (B,S,NH,HD, in x.dtype) and ``dh_final`` (B,NH,HD,NS fp32; None for
    zeros) -> (dx, ddt, da, db, dc, dd, dh0): dx, db and dc in x.dtype,
    ddt (B,S,NH), da and dd (NH,) and dh0 (B,NH,HD,NS; None when ``h0`` is
    None) in fp32, as :func:`repro_torch.kernels.ref.mamba_chunk_scan_bwd`
    computes them.  Takes what the forward takes.  One call into the
    library, into fp32 scratch.  bf16 (the chunk-parallel tensor-core
    kernels): the states of the chunks and of the segments of K =
    ``BWD_SEGMENT`` chunks (2,B,NH,NC+NSEG,HD,NS) with NC = ceil(S/64) and
    NSEG = ceil(NC/K), db and dc summed over each group of G =
    :func:`bwd_group` heads (2,B,ceil(NH/G),S,NS), and da and dd per chunk
    (2,B,NC,NH).  fp32 (the CUDA-core kernel): the states
    (B,NH,ceil(S/Q),HD,NS) at Q = :func:`bwd_chunk`, and per-head
    partials (2,B,NH,S,NS) and (2,B,NH)."""
    build.check_no_grad(BWD_NAME, x, dt, a, b, c, d, dy, dh_final, h0)
    bs, s, nh, hd, ns = _check(BWD_NAME, x, dt, a, b, c, d, h0)
    bf16 = x.dtype == torch.bfloat16
    build.check_operand(BWD_NAME, "dy", dy, 4, x.dtype, aligned=bf16)
    if dy.shape != x.shape:
        raise ValueError(f"{BWD_NAME}: dy {tuple(dy.shape)}, expected "
                         f"{tuple(x.shape)}")
    if dh_final is not None:
        build.check_operand(BWD_NAME, "dh_final", dh_final, 4, torch.float32,
                            aligned=False)
        if dh_final.shape != (bs, nh, hd, ns):
            raise ValueError(f"{BWD_NAME}: dh_final {tuple(dh_final.shape)},"
                             f" expected {(bs, nh, hd, ns)}")
    f32 = dict(dtype=torch.float32, device=x.device)
    if bf16:
        q, g, k = BWD_Q, bwd_group(nh, hd, ns), BWD_SEGMENT
        nc, ng = -(-s // q), -(-nh // g)
        states = torch.empty((2, bs, nh, nc - (-nc // k), hd, ns), **f32)
        dbc = torch.empty((2, bs, ng, s, ns), **f32)
        dad = torch.empty((2, bs, nc, nh), **f32)
    else:
        q, g, k = bwd_chunk(hd, ns), 1, 1
        states = torch.empty((bs, nh, -(-s // q), hd, ns), **f32)
        dbc = torch.empty((2, bs, nh, s, ns), **f32)
        dad = torch.empty((2, bs, nh), **f32)
    dx = torch.empty_like(x)
    ddt = torch.empty((bs, s, nh), **f32)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    da, dd = torch.empty((nh,), **f32), torch.empty((nh,), **f32)
    dh0 = None if h0 is None else torch.empty((bs, nh, hd, ns), **f32)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build.entry(BWD_NAME)(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), d.data_ptr(), ptr(h0), dy.data_ptr(), ptr(dh_final),
        dx.data_ptr(), ddt.data_ptr(), db.data_ptr(), dc.data_ptr(),
        da.data_ptr(), dd.data_ptr(), ptr(dh0), states.data_ptr(),
        dbc[0].data_ptr(), dbc[1].data_ptr(), dad[0].data_ptr(),
        dad[1].data_ptr(),
        build.DTYPE_CODES[str(x.dtype).removeprefix("torch.")],
        bs, s, nh, hd, ns, q, g, k, stream)
    build.launch_check(BWD_NAME, err)
    build.count_launch(mamba_chunk_scan_bwd)
    return dx, ddt, da, db, dc, dd, dh0


mamba_chunk_scan_bwd.launches = 0
