"""Wrappers of the CUDA RMSNorm kernels, forward and backward
(``csrc/rmsnorm.cu``).

Counterpart of :mod:`repro.kernels.rmsnorm` (forward); the JAX package has
no backward kernel.  Takes CUDA tensors only; :mod:`repro_torch.kernels.ops`
sends CPU tensors to the plain versions in :mod:`repro_torch.kernels.ref`
and wires both directions into autograd.

:func:`launch_shape` picks every launch on the host, from the row count,
the width and the dtype, and the C entry points take its result.
"""
from __future__ import annotations

import collections
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

NAME = "rmsnorm"
NPTS = (1, 2, 3, 4, 5, 6, 8)  # loads a thread holds: the instances compiled
# The register budget: the most threads a CTA for a thread that holds up to
# so many elements of a row (of x, and in the backward of g and the fp32
# dscale sums), so that each instance keeps its registers under
# __launch_bounds__ without spilling.
BUDGET = ((8, 1024), (16, 512), (64, 256))
# csrc/rmsnorm.cu compiles NPTS and BUDGET from these (kernels/build.py)
NVCC_DEFINES = {"RMS_NPTS": ",".join(map(str, NPTS)),
                "RMS_BUDGET": ",".join(f"{e},{t}" for e, t in BUDGET)}
# Packed rows: threads a CTA and the most loads a thread holds.  Fewer
# loads and more threads a row keep more rows in flight a SM (registers);
# the forward's and backward's were the fastest of those tried on an H100
# at the slices' shapes (PERF.md, §6).
FWD_THREADS, FWD_MOST = 128, 5
BWD_THREADS, BWD_MOST = 256, 2
# Up to FEW_ELEMS elements (rows x d: decode steps, and the slices'
# prefills but the gated norm's past 409 tokens) each row gets a CTA of
# its own, whose threads hold SPREAD_LOADS loads each: on an H100 that
# beat one load a thread and the packed plans there, and lost to the
# packed plans beyond.
FEW_ELEMS, SPREAD_LOADS = 2**21, 2
BWD_CTAS = 264   # most CTAs of the backward, and rows of its scratch
# threads that may share a row: a power of two up to a warp, or whole warps
TPRS = (1, 2, 4, 8, 16) + tuple(range(32, 1025, 32))


class Plan(NamedTuple):
    """One launch of ``csrc/rmsnorm.cu``."""
    vec: int           # elements a load: 16 bytes' worth, or 1 (any d)
    npt: int           # loads a thread holds in registers (an instance)
    tpr: int           # threads that share a row
    threads: int       # threads a CTA: threads // tpr rows at a time
    rows_per_cta: int  # rows a CTA walks
    grid: int          # CTAs; in the backward also the scratch's rows


def max_threads(elems: int) -> int:
    """Most threads a CTA when a thread holds ``elems`` elements of a row
    (``BUDGET``); 0 past the budget."""
    return next((t for e, t in BUDGET if elems <= e), 0)


def _fits(tpr: int, npt: int, vec: int) -> bool:
    return tpr <= max_threads(npt * vec)


def _packed_split(nv: int, vec: int, most: int) -> tuple[int, int]:
    """(threads a row, loads a thread) for rows packed into CTAs: the
    fewest threads that hold ``nv`` loads at most ``most`` each (or more,
    where a row needs it), with every thread holding as many where some
    split allows it."""
    for cap in (most, max(NPTS)):
        fits = [(t, n) for t in TPRS for n in NPTS
                if n <= cap and t * n >= nv and _fits(t, n, vec)]
        if fits:
            return min([tn for tn in fits if tn[0] * tn[1] == nv] or fits)
    _too_wide(nv, vec)


def _spread_split(nv: int, vec: int) -> tuple[int, int]:
    """(threads a row, loads a thread) for a row alone in its CTA: as many
    threads as hold ``SPREAD_LOADS`` loads each (fewer where the row has
    fewer), or the fewest loads more that fit."""
    for n in (n for n in NPTS if n >= min(SPREAD_LOADS, nv)):
        need = -(-nv // n)
        tpr = next((t for t in TPRS if t >= need), None)
        if tpr is not None and _fits(tpr, n, vec):
            return tpr, n
    _too_wide(nv, vec)


def _too_wide(nv: int, vec: int):
    raise ValueError(f"{NAME}: a row of {nv * vec} elements is wider than "
                     f"the kernels hold in registers ({vec} a load)")


def _cta(tpr: int, npt: int, vec: int, threads: int) -> int:
    """Threads of a packed CTA: whole rows, at most ``threads`` unless one
    row needs more, within the register budget."""
    most = min(threads, max_threads(npt * vec))
    return tpr * max(1, most // tpr)


@functools.lru_cache(maxsize=4096)
def launch_shape(rows: int, d: int, dtype: torch.dtype, *,
                 backward: bool = False, aligned: bool = True) -> Plan:
    """The launch of the forward (or ``backward``) kernel for ``rows``
    rows of ``d`` elements of ``dtype``.  ``aligned``: every row pointer is
    16-byte aligned, so d a multiple of 16 bytes loads 16 bytes at a time;
    otherwise one element at a time.

    Forward: up to ``FEW_ELEMS`` elements each row has a CTA of its own
    and as many threads as hold ``SPREAD_LOADS`` loads each (a CTA is at
    least a warp, so it holds several narrow rows); more rows are packed
    ``FWD_THREADS // tpr`` to a CTA, a thread holding up to ``FWD_MOST``
    loads.  Backward: packed the same way (``BWD_THREADS``, ``BWD_MOST``),
    each CTA walking a run of rows over at most ``BWD_CTAS`` CTAs.  The
    backward's CTAs and the rows each walks depend on ``rows`` alone: never
    on the card, the dtype or the alignment.  The order of dscale's sums
    within a CTA (its row groups, ``threads // tpr``) also depends on d,
    the dtype and the alignment, so dscale is bit-equal from call to call
    of one (rows, d, dtype, alignment)."""
    step = 16 // dtype.itemsize
    vec = step if aligned and d % step == 0 else 1
    nv = d // vec
    if backward:
        tpr, npt = _packed_split(nv, vec, BWD_MOST)
        threads = _cta(tpr, npt, vec, BWD_THREADS)
        per = -(-rows // min(rows, BWD_CTAS))
    elif rows * d <= FEW_ELEMS:
        tpr, npt = _spread_split(nv, vec)
        threads = max(32, tpr)
        per = threads // tpr
    else:
        tpr, npt = _packed_split(nv, vec, FWD_MOST)
        threads = _cta(tpr, npt, vec, FWD_THREADS)
        per = threads // tpr
    return Plan(vec, npt, tpr, threads, per, -(-rows // per))


def _check(kernel: str, x: torch.Tensor, scale: torch.Tensor) -> int:
    """Check x (..., d) and scale (d,); return the row count."""
    build.check_operand(kernel, "x", x, max(x.dim(), 1), aligned=False)
    build.check_operand(kernel, "scale", scale, 1, x.dtype, aligned=False)
    d = x.shape[-1] if x.dim() else 0
    if scale.shape != (d,) or d == 0 or x.numel() == 0:
        raise ValueError(f"{kernel}: x {tuple(x.shape)}, scale "
                         f"{tuple(scale.shape)}: empty or not matching")
    return x.numel() // d


def _plan(rows: int, x: torch.Tensor, *tensors: torch.Tensor,
          backward: bool = False) -> Plan:
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, *tensors))
    return launch_shape(rows, x.shape[-1], x.dtype, backward=backward,
                        aligned=aligned)


def _code(x: torch.Tensor) -> int:
    return build.DTYPE_CODES[str(x.dtype).removeprefix("torch.")]


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
                zero_centered: bool = True, with_rstd: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """x: (..., d); scale: (d,) in x.dtype -> (y in x.dtype, rstd (...)
    fp32, the per-row rsqrt(mean(x^2) + eps) the backward takes).  Without
    ``with_rstd`` rstd is neither allocated nor written, and is None."""
    build.check_no_grad(NAME, x, scale)
    rows = _check(NAME, x, scale)
    y = torch.empty_like(x)
    rstd = (torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
            if with_rstd else None)
    plan = _plan(rows, x, scale, y)
    err = build.entry(NAME, "rmsnorm_fwd")(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(),
        None if rstd is None else rstd.data_ptr(), _code(x), rows,
        x.shape[-1], float(eps), int(zero_centered), *plan, _stream(x))
    build.launch_check(NAME, err)
    build.count_launch(rmsnorm_fwd, (rows, x.shape[-1]))
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
    plan = _plan(rows, x, scale, g, dx, backward=True)
    part = torch.empty((plan.grid, d), dtype=torch.float32, device=x.device)
    err = build.entry(NAME, "rmsnorm_bwd")(
        x.data_ptr(), scale.data_ptr(), rstd.data_ptr(), g.data_ptr(),
        dx.data_ptr(), dscale.data_ptr(), part.data_ptr(), _code(x), rows, d,
        int(zero_centered), *plan, _stream(x))
    build.launch_check(NAME, err)
    build.count_launch(rmsnorm_bwd, (rows, d))
    return dx, dscale


# launches, and launches by (rows, d)
rmsnorm_fwd.launches = 0
rmsnorm_bwd.launches = 0
rmsnorm_fwd.shapes = collections.Counter()
rmsnorm_bwd.shapes = collections.Counter()
