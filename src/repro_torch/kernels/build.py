"""Build and load the CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface and loaded with :mod:`ctypes`.  A library that
:data:`UNITS` lists is built from several translation units instead,
compiled apart and linked into the one library.  Nothing is built when a
module is imported: :func:`load` builds on the first CUDA call of a
kernel, and :func:`build_all` starts one ``nvcc`` per translation unit,
all at once.
Libraries go to ``build/kernels/`` under the checkout, named by a hash of
the sources and flags, so a changed source is rebuilt and an unchanged one
is reused.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dtype codes of the C entry points (csrc/common.cuh)
DTYPE_CODES = {"float32": 0, "bfloat16": 1}

# head dims the attention kernels are instantiated for (csrc/*.cu
# templates): the flash forward and backward, and decode
HEAD_DIMS = (32, 64, 80, 128, 256)

# libraries built from several translation units: name -> [(source in
# csrc/, its macros)].  Decode's 68 instances took one nvcc ~73 s; one
# unit for each (dtype, head dim) lets them build beside the others.
UNITS = {"decode_attention": [("decode_attention.cu", {})] + [
    ("decode_attention_hd.cu", {"DECODE_DTYPE": str(code),
                                "DECODE_HD": str(hd)})
    for code in DTYPE_CODES.values() for hd in HEAD_DIMS]}

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
        # q, k, v, lengths, o, partials (n_split > 1: fp32 scratch; else
        # null), dtype, B, T, H, KV, HD, window, scale, softcap, n_split,
        # stream
        "decode_attention_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _I, _F, _F, _I, _P],
        # dtype, HD, G: 1 where decode_attention_fwd launches, else 0
        "decode_attention_built": [_I, _I, _I]},
    "mamba_chunk_scan": {
        # x, dt, a, b, c, d, h0 (or null), y, h_final, dtype, B, S, NH,
        # HD, NS, stream
        "mamba_chunk_scan_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 _I, _I, _I, _I, _P]},
    "mamba_chunk_scan_bwd": {
        # x, dt, a, b, c, d, h0 (or null), dy, dh_final (or null), dx, ddt,
        # db, dc, da, dd, dh0 (or null), then fp32 scratch: states,
        # db and dc partials, da and dd partials; dtype, B, S, NH, HD, NS,
        # Q, G (heads a group), K (chunks a segment), stream
        "mamba_chunk_scan_bwd": [_P] * 21 + [_I] * 9 + [_P]},
    "rmsnorm": {
        # x, scale, y, rstd (or null), dtype, rows, d, eps, zero_centered,
        # then the launch shape (kernels/rmsnorm.py Plan: vec, npt, tpr,
        # threads, rows_per_cta, grid), stream
        "rmsnorm_fwd": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _I, _I,
                        _I, _I, _P],
        # x, scale, rstd, g, dx, dscale, partials ((grid, d) fp32 scratch),
        # dtype, rows, d, zero_centered, the launch shape, stream
        "rmsnorm_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _I, _I, _I, _I, _P]},
}

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# seconds from build_all's start until each library it built was in place
build_seconds: dict[str, float] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def defines(name: str) -> dict[str, str]:
    """The macros of library ``name``: the ``NVCC_DEFINES`` of its wrapper
    module, where it has one, so that what both the host and the kernels
    must know (such as the instances compiled) is set there alone."""
    if not Path(__file__).with_name(f"{name}.py").exists():
        return {}
    module = importlib.import_module(f"{__package__}.{name}")
    return dict(getattr(module, "NVCC_DEFINES", {}))


def _defines_header(name: str) -> str:
    """The ``#define`` lines of :func:`defines`: nvcc reads them from a
    header it includes first (``-D`` would split a value at its commas)."""
    return "".join(f"#define {k} {v}\n" for k, v in defines(name).items())


def units(name: str) -> list[tuple[Path, dict[str, str]]]:
    """The translation units of library ``name``, each a source and its
    macros: ``csrc/<name>.cu`` alone unless :data:`UNITS` lists more."""
    return [(CSRC / src, dict(macros))
            for src, macros in UNITS.get(name, [(f"{name}.cu", {})])]


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` is built for the present
    sources, flags and macros."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(_defines_header(name).encode())
    for src in sorted(CSRC.glob("*.cuh")):
        h.update(src.read_bytes())
    for src, macros in units(name):
        h.update(src.read_bytes())
        if macros:
            h.update(repr(sorted(macros.items())).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[Path, list[tuple[subprocess.Popen, Path]]]:
    """Start the ``nvcc`` of each translation unit of library ``name``;
    returns where the library goes and each process with its output (the
    library itself for a one-unit library, else an object file)."""
    out = library_path(name)
    if out.exists():
        return out, []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = list(NVCC_FLAGS)
    header = _defines_header(name)
    if header:
        path = out.with_suffix(".h")
        path.write_text(header)
        flags += ["--pre-include", str(path)]
    todo = units(name)
    if len(todo) > 1:       # compile apart: objects, linked in _finish
        flags[flags.index("-shared")] = "-c"
    procs = []
    for i, (src, macros) in enumerate(todo):
        tmp = out.with_suffix(f".{i}.{os.getpid()}.o" if len(todo) > 1
                              else f".{os.getpid()}.tmp")
        cmd = [nvcc(), *flags, *(f"-D{k}={v}" for k, v in macros.items()),
               "-o", str(tmp), str(src)]
        procs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp))
    return out, procs


def _finish(name: str, out: Path,
            procs: list[tuple[subprocess.Popen, Path]]) -> str:
    """Wait for one library's builds; link its objects where it has
    several; move the library into place; return the log."""
    if not procs:
        return ""
    logs, failed = [], []
    for (proc, _), (src, macros) in zip(procs, units(name)):
        log, _ = proc.communicate()
        logs.append(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {src.name} {macros or ''}:"
                          f"\n{log}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if len(procs) > 1:
        link = None if failed else subprocess.run(
            [nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
             *(str(obj) for _, obj in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for _, obj in procs:
            obj.unlink(missing_ok=True)
        if link is not None and link.returncode != 0:
            raise RuntimeError(f"linking {name} failed:\n{link.stdout}")
        if link is not None:
            logs.append(link.stdout)
    if failed:
        raise RuntimeError("\n".join(failed))
    os.replace(tmp, out)
    log = "".join(logs)
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
    translation unit, all at once; load them.  Returns each build's
    compiler log; :data:`build_seconds` gets the seconds from the start
    until each library was in place."""
    with _lock:
        t0 = time.perf_counter()
        started = {n: _start(n) for n in SIGNATURES if n not in _loaded}
        logs, errors = {}, []

        def finish(n: str) -> None:
            try:
                logs[n] = _finish(n, *started[n])
            except RuntimeError as e:
                errors.append(str(e))
            build_seconds[n] = time.perf_counter() - t0

        # a thread a library, so each one's seconds end when it does; all
        # are waited for before raising
        waits = [threading.Thread(target=finish, args=(n,)) for n in started]
        for w in waits:
            w.start()
        for w in waits:
            w.join()
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


_count_lock = threading.Lock()


def count_launch(counter, shape: tuple[int, ...] | None = None) -> None:
    """One launch of the kernel behind ``counter`` (a wrapper function):
    ``counter.launches += 1``, and ``counter.shapes[shape] += 1`` where
    the wrapper counts by shape, under one lock, so wrappers called from
    several threads at once (a task runtime's workers) lose no count."""
    with _count_lock:
        counter.launches += 1
        if shape is not None:
            counter.shapes[shape] += 1
