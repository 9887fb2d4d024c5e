#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

1. Environment: TF32 off, the card's name and power limit, the kernels
   built with nvcc from ``src/repro_torch/kernels/csrc`` into
   ``build/kernels/`` (timed).
2. Each CUDA kernel against its plain PyTorch version on the card, on the
   JAX suite's sweep shapes and the slices' shapes: flash and decode
   attention at head dims 32, 64, 80 and 128 (fp32 2e-5, bf16 2e-2), the
   Mamba-2 SSD scan with ragged S and a split at h0 (fp32 2e-4, bf16 2e-2).
3. The slices, each at its published width in bf16 with random weights
   from a seeded generator, served through ``ServingEngine`` (16 requests,
   prompt lengths uniform in 32-512, 8 slots, 1024 positions, 32 new
   tokens each):
   * llama3.2-1b (flash and decode attention, head dim 64);
   * zamba2-2.7b (45 mamba2 layers through the SSD kernel, 9 repeats of a
     weight-shared attention slot through flash and decode attention at
     head dim 80).
   For each: the widths are asserted; every request finishes; every
   prefill and decode step went through its kernels (launch counters set
   to 0 just before the engine run and read just after); two requests'
   tokens equal a one-request greedy generation through
   ``prefill``/``decode_step``; kernel-path logits agree with the plain
   path; a profile of one decode step and one 512-token prefill.
4. Numbers: per kernel and slice, its time beside the plain version's, the
   PyTorch library call's (where one computes the same function) and the
   card's bound.

Any failed check raises, so the script exits non-zero.  It prints no
result, and fails, without a CUDA card or outside a checkout of the repo.
The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # rtol = atol, tests/test_kernels.py
SSD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}  # SSD sweeps, same file
LOGITS_REL_TOL = 5e-2  # rel. L2, kernel vs plain path, bf16 models
PEAK_FLOPS = 989e12    # H100 SXM dense bf16, tensor cores
PEAK_BYTES = 3.35e12   # H100 SXM HBM3
SSD_CHUNK = 64         # the SSD kernel's chunk length (csrc/mamba_chunk_scan.cu)

FLASH_SWEEP = [  # (b, s, h, kv, hd, causal, window, cap): tests/test_kernels.py
    (2, 256, 4, 2, 64, True, None, None),
    (1, 256, 8, 8, 128, True, None, 50.0),
    (2, 512, 4, 1, 64, True, 128, None),
    (1, 128, 4, 4, 32, False, None, None),
    (1, 384, 6, 2, 64, True, 256, 30.0),
    (2, 200, 4, 2, 80, True, 64, 30.0),     # head dim 80 (zamba2)
]
PREFILL_LENS = (32, 64, 128, 256, 512, 200)
DECODE_SWEEP = [  # (b, t, h, kv, hd, window, cap): tests/test_kernels.py
    (2, 256, 8, 2, 64, None, None),
    (1, 512, 4, 4, 128, 128, None),
    (3, 256, 16, 8, 64, None, 30.0),
    (2, 384, 8, 1, 32, 64, None),
    (3, 300, 8, 2, 80, 100, 30.0),          # head dim 80 (zamba2)
]
SSD_SWEEP = [  # (b, s, nh, hd, ns): tests/test_kernels.py, plus ragged S
    (2, 128, 3, 32, 16),
    (1, 256, 2, 64, 32),
    (1, 64, 4, 16, 8),
    (2, 200, 3, 64, 64),
]
N_REQUESTS, MAX_BATCH, MAX_LEN, NEW_TOKENS = 16, 8, 1024, 32

# (arch, published widths: layers, d, heads, kv heads, head dim, d_ff,
#  vocab, dtype, mamba (d_state, d_conv, expand, head_dim, chunk) or None)
SLICES = [
    ("llama3.2-1b", (16, 2048, 32, 8, 64, 8192, 128256, "bfloat16", None)),
    ("zamba2-2.7b", (54, 2560, 32, 32, 80, 10240, 32000, "bfloat16",
                     (64, 4, 2, 64, 128))),
]


def _randn(rng, shape, dtype):
    a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return a.to(dtype).cuda()


def _check_close(what, got, want, tol):
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bad = err > tol + tol * w.abs()
    max_err = float(err.max())
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} elements off, "
                             f"max abs err {max_err}")
    return max_err


def _ssd_inputs(rng, b, s, nh, hd, ns, dtype):
    """x, dt, a, b, c, d as tests/test_kernels.py draws them (dt > 0,
    a < 0); x, b, c in ``dtype``, the rest fp32."""
    dt = torch.from_numpy((np.abs(rng.standard_normal((b, s, nh))) * 0.1
                           + 0.01).astype(np.float32)).cuda()
    a = torch.from_numpy(-(np.abs(rng.standard_normal(nh)) + 0.1).astype(
        np.float32)).cuda()
    return (_randn(rng, (b, s, nh, hd), dtype), dt, a,
            _randn(rng, (b, s, ns), dtype), _randn(rng, (b, s, ns), dtype),
            _randn(rng, (nh,), torch.float32))


def _check_flash(rng, dtype, cases, out, key):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    tol = TOL[str(dtype).removeprefix("torch.")]
    for b, s, h, kv, hd, causal, window, cap in cases:
        q = _randn(rng, (b, s, h, hd), dtype)
        k = _randn(rng, (b, s, kv, hd), dtype)
        v = _randn(rng, (b, s, kv, hd), dtype)
        kw = dict(causal=causal, window=window, softcap=cap,
                  scale=1.0 / np.sqrt(hd))
        got = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        err = _check_close(f"flash_attention {dtype} {(b, s, h, kv, hd)}",
                           got, ref.flash_attention(q, k, v, **kw), tol)
        print(f"flash_attention {str(dtype)[6:]:8s} b={b} s={s} h={h} "
              f"kv={kv} hd={hd} causal={causal} window={window} "
              f"cap={cap}: max abs err {err:.3e} (tol {tol})")
        if key and s == max(PREFILL_LENS):
            out[key] = (q, k, v, kw, err)


def _check_decode(rng, dtype, cases, out, key):
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    tol = TOL[str(dtype).removeprefix("torch.")]
    for b, t, h, kv, hd, window, cap in cases:
        q = _randn(rng, (b, 1, h, hd), dtype)
        k = _randn(rng, (b, t, kv, hd), dtype)
        v = _randn(rng, (b, t, kv, hd), dtype)
        lengths = torch.from_numpy(
            rng.integers(1, t, size=(b,)).astype(np.int32)).cuda()
        kw = dict(lengths=lengths, window=window, softcap=cap,
                  scale=1.0 / np.sqrt(hd))
        got = da.decode_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        err = _check_close(f"decode_attention {dtype} {(b, t, h, kv, hd)}",
                           got, ref.decode_attention(q, k, v, **kw), tol)
        print(f"decode_attention {str(dtype)[6:]:8s} b={b} t={t} h={h} "
              f"kv={kv} hd={hd} window={window} cap={cap}: "
              f"max abs err {err:.3e} (tol {tol})")
        if key:
            out[key] = (q, k, v, kw, err)


def _check_ssd(rng, dtype, cases, out, key):
    from repro_torch.kernels import mamba_chunk_scan as mcs
    from repro_torch.kernels import ref
    tol = SSD_TOL[str(dtype).removeprefix("torch.")]
    for b, s, nh, hd, ns in cases:
        args = _ssd_inputs(rng, b, s, nh, hd, ns, dtype)
        h0 = torch.from_numpy(rng.standard_normal((b, nh, hd, ns)).astype(
            np.float32)).cuda() if key else None  # the model passes h0
        y, h = mcs.mamba_chunk_scan(*args, h0=h0)
        torch.cuda.synchronize()
        want_y, want_h = ref.mamba_chunk_scan(*args, h0=h0)
        what = f"mamba_chunk_scan {dtype} {(b, s, nh, hd, ns)}"
        err = max(_check_close(what + " y", y, want_y, tol),
                  _check_close(what + " h_final", h, want_h, tol))
        print(f"mamba_chunk_scan {str(dtype)[6:]:8s} b={b} s={s} nh={nh} "
              f"hd={hd} ns={ns}: max abs err {err:.3e} (tol {tol})")
        if key and s == max(PREFILL_LENS):
            out[key] = (args, h0, err)
    # split at h0: the first part's h_final feeds the rest
    x, dt, a, bm, cm, d = _ssd_inputs(rng, 2, 160, 4, 64, 64, dtype)
    cut = 96
    parts = [[t[:, sl].contiguous() for t in (x, dt, bm, cm)]
             for sl in (slice(0, cut), slice(cut, None))]
    _, h1 = mcs.mamba_chunk_scan(*parts[0][:2], a, *parts[0][2:], d)
    y2, h2 = mcs.mamba_chunk_scan(*parts[1][:2], a, *parts[1][2:], d, h0=h1)
    torch.cuda.synchronize()
    want_y, want_h = ref.mamba_chunk_scan(x, dt, a, bm, cm, d)
    err = max(_check_close("mamba_chunk_scan h0 split y", y2,
                           want_y[:, cut:], tol),
              _check_close("mamba_chunk_scan h0 split h", h2, want_h, tol))
    print(f"mamba_chunk_scan {str(dtype)[6:]:8s} split at h0 (160 = 96 + "
          f"64): max abs err {err:.3e} (tol {tol})")


def check_kernels():
    """Every kernel against its plain version; returns the slice-shape
    inputs and errors for the timing phase."""
    rng = np.random.default_rng(0)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        _check_flash(rng, dtype, FLASH_SWEEP, out, None)
        _check_decode(rng, dtype, DECODE_SWEEP, out, None)
        _check_ssd(rng, dtype, SSD_SWEEP, out, None)
        if not bf16:
            continue
        # the slices' shapes: llama (hd 64, GQA 32/8), zamba2 (hd 80, 32/32)
        for key, (h, kv, hd) in (("flash:llama3.2-1b", (32, 8, 64)),
                                 ("flash:zamba2-2.7b", (32, 32, 80))):
            _check_flash(rng, dtype, [(1, s, h, kv, hd, True, None, None)
                                      for s in PREFILL_LENS], out, key)
        _check_decode(rng, dtype, [(8, MAX_LEN, 32, 8, 64, None, None)], out,
                      "decode:llama3.2-1b")
        _check_decode(rng, dtype, [(8, MAX_LEN, 32, 32, 80, None, None)],
                      out, "decode:zamba2-2.7b")
        _check_ssd(rng, dtype, [(1, s, 80, 64, 64) for s in PREFILL_LENS],
                   out, "ssd:zamba2-2.7b")
    return out


def _n_layers(cfg, kind):
    return sum(sum(s.kind == kind for s in g.pattern) * g.repeat
               for g in cfg.groups)


def greedy_reference(cfg, params, prompt):
    """One request's greedy tokens through ``prefill``/``decode_step``.

    The prompt is padded as the engine pads it and decoded in a batch of
    ``MAX_BATCH`` rows (the request in row 0, the others idle), so every
    bf16 matmul sees the engine's shapes and rounds alike; the request's
    row is computed independently of the others, so any slot mix-up in the
    engine shows as different tokens.
    """
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import tree_map
    from repro_torch.serve.engine import prefill_length
    s = len(prompt)
    toks = np.zeros((1, prefill_length(cfg, s - 1, MAX_LEN)), np.int32)
    toks[0, :s - 1] = prompt[:-1]
    one = model_lib.init_cache(cfg, 1, MAX_LEN, device="cuda")
    _, one = model_lib.prefill(params, cfg, torch.from_numpy(toks).cuda(),
                               one)
    cache = model_lib.init_cache(cfg, MAX_BATCH, MAX_LEN, device="cuda")
    tree_map(lambda g, p: g[:, 0].copy_(p[:, 0]), cache, one)
    cur, pos, out = int(prompt[-1]), s - 1, []
    for _ in range(NEW_TOKENS):
        tokens = torch.zeros((MAX_BATCH, 1), dtype=torch.int32, device="cuda")
        tokens[0, 0] = cur
        p = torch.zeros((MAX_BATCH,), dtype=torch.int32, device="cuda")
        p[0] = pos
        logits, cache = model_lib.decode_step(params, cfg, tokens, cache, p)
        cur = int(torch.argmax(logits[0, 0]))
        out.append(cur)
        pos += 1
    return out


def compare_plain_path(cfg, params):
    """Logits of one prefill + one decode step, kernels vs plain path."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import model as model_lib
    rng = np.random.default_rng(1)
    b, s = 8, 128
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)).cuda()
    pos = torch.full((b,), s, dtype=torch.int32, device="cuda")

    def run():
        cache = model_lib.init_cache(cfg, b, 256, device="cuda")
        pre, cache = model_lib.prefill(params, cfg, toks[:, :s], cache)
        dec, _ = model_lib.decode_step(params, cfg, toks[:, s:], cache, pos)
        return pre.float(), dec.float()

    kernel = run()
    with mock.patch.object(ops, "flash_attention", ref.flash_attention), \
            mock.patch.object(ops, "decode_attention", ref.decode_attention), \
            mock.patch.object(ops, "mamba_chunk_scan", ref.mamba_chunk_scan):
        plain = run()
    res = {}
    for name, a, w in zip(("prefill", "decode"), kernel, plain):
        rel = float((a - w).norm() / w.norm())
        agree = float((a.argmax(-1) == w.argmax(-1)).float().mean())
        res[name] = {"max_abs_err": float((a - w).abs().max()),
                     "rel_l2_err": rel, "token_agreement": agree}
        if not rel <= LOGITS_REL_TOL:
            raise AssertionError(f"{name} logits, kernel vs plain path: "
                                 f"rel L2 err {rel} > {LOGITS_REL_TOL}")
    return res


def make_prompts(cfg):
    rng = np.random.default_rng(2)
    lens = rng.integers(32, 513, size=N_REQUESTS)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in lens]


def _counters():
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_chunk_scan as mcs
    return {"flash_attention": fa.flash_attention,
            "decode_attention": da.decode_attention,
            "mamba_chunk_scan": mcs.mamba_chunk_scan}


def serve(cfg, params, prompts):
    """The engine run of one slice, with every launch counter set to 0
    just before it and read just after; checks each kernel's count."""
    from repro_torch.serve.engine import ServingEngine
    eng = ServingEngine(cfg, params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                        device="cuda")
    for fn in _counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    eng.start()
    reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    for r in reqs:
        if not r.done.wait(600):
            raise AssertionError(f"request {r.rid} did not finish")
    wall = time.perf_counter() - t0
    eng.stop()
    launches = {n: fn.launches for n, fn in _counters().items()}
    for r in reqs:
        if len(r.out_tokens) != NEW_TOKENS:
            raise AssertionError(f"request {r.rid}: {len(r.out_tokens)} "
                                 f"tokens, expected {NEW_TOKENS}")
    n_attn, n_ssd = _n_layers(cfg, "attn"), _n_layers(cfg, "mamba2")
    want = {"flash_attention": n_attn * eng.n_prefills,
            "decode_attention": n_attn * eng.n_decode_steps,
            "mamba_chunk_scan": n_ssd * eng.n_prefills}
    if eng.n_prefills != N_REQUESTS or launches != want:
        raise AssertionError(
            f"{cfg.name}: launches {launches}, expected {want} for "
            f"{eng.n_prefills} prefills and {eng.n_decode_steps} decode "
            f"steps over {n_attn} attention and {n_ssd} mamba2 layers")
    print(f"{cfg.name} launches per prefill: flash_attention {n_attn}, "
          f"mamba_chunk_scan {n_ssd}; per decode step: decode_attention "
          f"{n_attn}")
    lat = np.array([r.finish_t - r.submit_t for r in reqs])
    stats = {"arch": cfg.name, "requests": N_REQUESTS,
             "prompt_lens": [len(p) for p in prompts],
             "new_tokens": NEW_TOKENS, "generated": eng.n_generated,
             "prefills": eng.n_prefills, "decode_steps": eng.n_decode_steps,
             "wall_s": wall, "tokens_per_s": eng.n_generated / wall,
             "latency_p50_s": float(np.percentile(lat, 50)),
             "latency_p95_s": float(np.percentile(lat, 95))}
    return reqs, launches, stats


def time_ms(fn, flush, iters=25, warmup=3):
    """Median device time of ``fn`` in ms over ``iters`` runs, each with a
    cold L2 (``flush`` overwrites 128 MB) and the launch queued behind a
    device-side sleep, so the events bracket device work only."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _flash_row(q, k, v, kw, err):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    pairs = s * (s + 1) // 2                # causal, q_offset 0, S == T
    return dict(
        name="flash_attention", shape=[b, s, h, kv, hd], err=err,
        flops=4 * hd * pairs * b * h,
        nbytes=q.element_size() * (2 * q.numel() + k.numel() + v.numel()),
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:114",
        kernel=lambda: fa.flash_attention(q, k, v, **kw),
        plain=lambda: ref.flash_attention(q, k, v, **kw),
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=kw["scale"], enable_gqa=True))


def _decode_row(q, k, v, kw, err):
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    b, _, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    lengths = kw["lengths"]
    live = int(lengths.sum())               # cache rows the step must read
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = (torch.arange(t, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    return dict(
        name="decode_attention", shape=[b, t, h, kv, hd], err=err,
        flops=4 * hd * h * live,
        nbytes=q.element_size() * (2 * q.numel() + 2 * live * kv * hd)
        + lengths.numel() * 4,
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:108",
        kernel=lambda: da.decode_attention(q, k, v, **kw),
        plain=lambda: ref.decode_attention(q, k, v, **kw),
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=kw["scale"], enable_gqa=True))


def _ssd_row(args, h0, err):
    """Bytes: x, dt, a, b, c, d and h0 read once, y and h_final written
    once.  Operations: the multiply-adds of the chunked SSD at the
    kernel's chunk length, each 2 FLOPs: C B^T once per (batch, chunk) over
    the causal pairs, and per (batch, head, chunk) W x over the causal
    pairs, C H^T and the state update; at the bf16 tensor-core rate, the
    type of x, b and c."""
    from repro_torch.kernels import mamba_chunk_scan as mcs
    from repro_torch.kernels import ref
    x, dt, a, bm, cm, d = args
    b, s, nh, hd = x.shape
    ns = bm.shape[-1]
    macs = 0
    for t0 in range(0, s, SSD_CHUNK):
        n = min(SSD_CHUNK, s - t0)
        pairs = n * (n + 1) // 2
        macs += b * (pairs * ns + nh * (pairs * hd + 2 * n * hd * ns))
    nbytes = (sum(t.numel() * t.element_size() for t in args)
              + x.numel() * x.element_size() + 2 * h0.numel() * 4)
    return dict(
        name="mamba_chunk_scan", shape=[b, s, nh, hd, ns], err=err,
        flops=2 * macs, nbytes=nbytes,
        source="src/repro_torch/kernels/csrc/mamba_chunk_scan.cu",
        replaces="src/repro/kernels/mamba_chunk_scan.py:83",
        kernel=lambda: mcs.mamba_chunk_scan(*args, h0=h0),
        plain=lambda: ref.mamba_chunk_scan(*args, h0=h0),
        library=None)  # no single PyTorch call computes the SSD


def kernel_numbers(inputs, launches, card):
    """Times of each kernel at each slice's shapes, beside its plain
    version, the PyTorch library call and the card's bound."""
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")
    make = {"flash": _flash_row, "decode": _decode_row, "ssd": _ssd_row}
    out = []
    for key, inp in inputs.items():
        kind, arch = key.split(":")
        r = make[kind](*inp)
        ms = time_ms(r["kernel"], flush)
        plain_ms = time_ms(r["plain"], flush)
        library_ms = (None if r["library"] is None
                      else time_ms(r["library"], flush))
        t_ops, t_bytes = r["flops"] / PEAK_FLOPS, r["nbytes"] / PEAK_BYTES
        out.append({
            "name": r["name"], "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": launches[arch][r["name"]],
            "max_abs_err": r["err"], "ms": ms, "kernel_ms": ms,
            "plain_ms": plain_ms, "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, "path": arch, "shape": r["shape"],
            "dtype": "bfloat16", "flops": r["flops"], "bytes": r["nbytes"],
            "card": card})
    return out


def _category(kernel_name):
    n = kernel_name.lower()
    if "flash_fwd_kernel" in n or "decode_kernel" in n:
        return "attention_kernels"
    if "ssd_kernel" in n:
        return "ssd_kernel"
    if any(w in n for w in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
        return "matmul"
    return "other"


def profile_slice(cfg, params, card):
    """Where the time of one decode step (8 slots, ~300 cached positions)
    and one 512-token prefill goes: host wall time, device busy time by
    kernel category (torch.profiler), and the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model as model_lib
    rng = np.random.default_rng(3)
    cache = model_lib.init_cache(cfg, MAX_BATCH, MAX_LEN, device="cuda")
    one = model_lib.init_cache(cfg, 1, MAX_LEN, device="cuda")
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (MAX_BATCH, 1)).astype(np.int32)).cuda()
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, 512)).astype(np.int32)).cuda()
    pos = torch.full((MAX_BATCH,), 300, dtype=torch.int32, device="cuda")

    def decode():
        logits, _ = model_lib.decode_step(params, cfg, tokens, cache, pos)
        torch.argmax(logits[:, 0], dim=-1).cpu()

    def prefill():
        model_lib.prefill(params, cfg, prompt, one)
        torch.cuda.synchronize()

    out = {"arch": cfg.name}
    for name, fn, n in (("decode_step_b8", decode, 20),
                        ("prefill_s512", prefill, 5)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        by_cat, launches = {}, 0
        for e in kernels:
            cat = _category(e.key)
            by_cat[cat] = by_cat.get(cat, 0.0) + \
                e.self_device_time_total / 1e3 / n
            launches += e.count
        busy = sum(by_cat.values())
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
        out[name] = {
            "wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall_ms,
            "device_ms_by_category": by_cat,
            "kernel_launches": launches / n,
            "top_kernels_ms": {e.key[:70]: e.self_device_time_total / 1e3 / n
                               for e in top}}
    out["card"] = card
    return out


def run_slice(arch, widths, card):
    """Phase 3 for one slice; returns its engine-run launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import tree_map
    cfg = get_config(arch)
    mc = cfg.mamba
    got = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.dtype,
           None if mc is None else (mc.d_state, mc.d_conv, mc.expand,
                                    mc.head_dim, mc.chunk))
    if got != widths:
        raise AssertionError(f"{arch} is not at its published width: {got}")
    print(f"{arch} at its published width: layers {got[0]}, d {got[1]}, "
          f"heads {got[2]}/{got[3]}, head_dim {got[4]}, d_ff {got[5]}, "
          f"vocab {got[6]}, {got[7]}, mamba {got[8]}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        params = model_lib.init_params(gen, cfg, device="cuda")
        leaves = []
        tree_map(leaves.append, params)
        n_params = sum(p.numel() for p in leaves)
        print(f"{arch}: {n_params} params, {cfg.dtype}, on "
              f"{torch.cuda.get_device_name(0)}")
        parity = compare_plain_path(cfg, params)
        print(f"{arch} kernel vs plain path logits:", json.dumps(parity))
        prompts = make_prompts(cfg)
        picks = (0, N_REQUESTS - 1)  # slot 0 first, then a reused slot
        want = {i: greedy_reference(cfg, params, prompts[i])
                for i in picks}
    reqs, launches, stats = serve(cfg, params, prompts)
    for i in picks:
        if reqs[i].out_tokens != want[i]:
            raise AssertionError(f"{arch} request {i}: engine "
                                 f"{reqs[i].out_tokens} != reference "
                                 f"{want[i]}")
    print(f"{arch} requests {picks}: engine tokens equal the one-request "
          f"greedy reference")
    print(f"{arch} launches over the engine run:", json.dumps(launches))
    stats.update(card=card, n_params=n_params, parity=parity)
    print(json.dumps({"slice": stats}))
    with torch.inference_mode():
        print(json.dumps({"profile": profile_slice(cfg, params, card)}))
    del params, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repo",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    # 1. environment
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: matmul", torch.backends.cuda.matmul.allow_tf32,
          "cudnn", torch.backends.cudnn.allow_tf32)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "device", torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(logs) or 'cached'})")
    shown = (("flash_fwd_kernel", "Li64E"), ("flash_fwd_kernel", "Li80E"),
             ("decode_kernel", "Li64ELi4E"), ("decode_kernel", "Li80ELi1E"),
             ("ssd_kernel", ""))
    for name, log in logs.items():
        entry = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "Used" in line and entry and "13__nv_bfloat16" in entry \
                    and any(k in entry and t in entry for k, t in shown):
                print(f"  {name} bf16 {entry[:48]}: "
                      f"{line.split(':', 1)[1].strip()}")

    # 2. kernels against their plain versions
    inputs = check_kernels()

    # 3. the slices
    launches = {arch: run_slice(arch, widths, card)
                for arch, widths in SLICES}

    # 4. numbers
    with torch.inference_mode():
        rows = kernel_numbers(inputs, launches, card)
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
