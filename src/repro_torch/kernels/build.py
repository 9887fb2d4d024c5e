"""Build and load the CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface and loaded with :mod:`ctypes`.  Nothing is built
when a module is imported: :func:`load` builds on the first CUDA call of a
kernel, and :func:`build_all` starts one ``nvcc`` per source in parallel.
Libraries go to ``build/kernels/`` under the checkout, named by a hash of
the sources and flags, so a changed source is rebuilt and an unchanged one
is reused.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dtype codes of the C entry points (csrc/common.cuh)
DTYPE_CODES = {"float32": 0, "bfloat16": 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points of each library (one per csrc/<name>.cu): symbol -> argtypes
SIGNATURES = {
    "flash_attention": {
        # q, k, v, o, lse (or null), dtype, B, S, T, H, KV, HD, causal,
        # window, scale, softcap, q_offset, stream
        "flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _I, _I, _I, _F, _F, _I, _P]},
    "flash_attention_bwd": {
        # q, k, v, o, lse, dO, dq, dk, dv, delta (bf16: (B, H, S) fp32
        # scratch; fp32: null), dtype, B, S, T, H, KV, HD, causal, window,
        # scale, softcap, q_offset, stream
        "flash_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I,
                                _P]},
    "decode_attention": {
        # q, k, v, lengths, o, dtype, B, T, H, KV, HD, window, scale,
        # softcap, stream
        "decode_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _I, _F, _F, _P]},
    "mamba_chunk_scan": {
        # x, dt, a, b, c, d, h0 (or null), y, h_final, dtype, B, S, NH,
        # HD, NS, stream
        "mamba_chunk_scan_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 _I, _I, _I, _I, _P]},
    "rmsnorm": {
        # x, scale, y, rstd, dtype, rows, d, eps, zero_centered, stream
        "rmsnorm_fwd": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
        # x, scale, rstd, g, dx, dscale, partials, dtype, rows, d,
        # zero_centered, stream
        "rmsnorm_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]},
}

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` is built for the present
    sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[Path, subprocess.Popen | None]:
    out = library_path(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, proc


def _finish(name: str, out: Path, proc: subprocess.Popen | None) -> str:
    """Wait for one build; move the library into place; return the log."""
    if proc is None:
        return ""
    log, _ = proc.communicate()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(log)
    return log


def _open(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for symbol, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build_all() -> dict[str, str]:
    """Compile every kernel library that is not built yet, one ``nvcc`` per
    source, all at once; load them.  Returns each build's compiler log."""
    with _lock:
        started = {n: _start(n) for n in SIGNATURES if n not in _loaded}
        logs, errors = {}, []
        for n, sp in started.items():  # wait for every build before raising
            try:
                logs[n] = _finish(n, *sp)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        for n, (path, _) in started.items():
            _loaded[n] = _open(n, path)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _loaded:
            path, proc = _start(name)
            _finish(name, path, proc)
            _loaded[name] = _open(name, path)
        return _loaded[name]


def entry(name: str, symbol: str | None = None):
    """The C entry point ``symbol`` of library ``name`` (by default the
    library's only one)."""
    if symbol is None:
        (symbol,) = SIGNATURES[name]
    return getattr(load(name), symbol)


# head dims the attention kernels are instantiated for (csrc/*.cu templates)
HEAD_DIMS = (32, 64, 80, 128)


def check_operand(kernel: str, arg: str, t, ndim: int, dtype=None, *,
                  aligned: bool = True) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``ndim`` dims in a
    dtype the kernel takes (``dtype`` if given), 16-byte aligned unless
    ``aligned`` is False (for operands the kernel reads element by
    element)."""
    if t.device.type != "cuda":
        raise ValueError(f"{kernel}: {arg} is on {t.device}, not CUDA")
    if t.dim() != ndim:
        raise ValueError(f"{kernel}: {arg} has shape {tuple(t.shape)}, "
                         f"expected {ndim} dims")
    name = str(t.dtype).removeprefix("torch.")
    if dtype is None and name not in DTYPE_CODES:
        raise ValueError(f"{kernel}: {arg} dtype {t.dtype} not supported "
                         f"(float32 or bfloat16)")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{kernel}: {arg} dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {arg} must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{kernel}: {arg} must be 16-byte aligned")


def check_no_grad(kernel: str, *tensors) -> None:
    """Raise if autograd would record this call.  A kernel fills a fresh
    tensor through a raw pointer, so its output has no autograd history:
    under grad mode a result of inputs that require grad would silently
    cut the graph.  The autograd functions of :mod:`.ops` call the kernels
    with grad mode off; anything else that needs a gradient must go there.
    """
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: an input requires grad, and this kernel's output "
            f"would be detached from autograd; call it under "
            f"torch.no_grad(), or through repro_torch.kernels.ops where an "
            f"autograd backward exists")


def launch_check(kernel: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")
