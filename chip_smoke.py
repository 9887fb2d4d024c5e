#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

1. Environment: TF32 off, the card's name and power limit, the kernels
   built with nvcc from ``src/repro_torch/kernels/csrc`` into
   ``build/kernels/`` (timed).
2. Each CUDA kernel against its plain PyTorch version on the card, on the
   JAX suite's sweep shapes and the slice's shapes (fp32 2e-5, bf16 2e-2).
3. The slice: llama3.2-1b at its published width in bf16, random weights
   from a seeded generator, served through ``ServingEngine`` (16 requests,
   8 slots, 1024 positions, 32 new tokens each).  Checks that every request
   finishes, that every prefill went through the flash-attention kernel and
   every decode step through the decode-attention kernel, that two
   requests' tokens equal a one-request greedy generation through
   ``prefill``/``decode_step``, and that kernel-path logits agree with the
   plain path.
4. Numbers: tokens/s and request latency; where the time of a decode step
   and of a prefill goes (torch.profiler); per kernel its time beside the
   plain version's, the PyTorch library call's and the card's bound.

Any failed check raises, so the script exits non-zero.  It prints no
result, and fails, without a CUDA card or outside a checkout of the repo.
The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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
LOGITS_REL_TOL = 5e-2  # rel. L2, kernel vs plain path, 16 bf16 layers
PEAK_FLOPS = 989e12    # H100 SXM dense bf16, tensor cores
PEAK_BYTES = 3.35e12   # H100 SXM HBM3

FLASH_SWEEP = [  # (b, s, h, kv, hd, causal, window, cap): tests/test_kernels.py
    (2, 256, 4, 2, 64, True, None, None),
    (1, 256, 8, 8, 128, True, None, 50.0),
    (2, 512, 4, 1, 64, True, 128, None),
    (1, 128, 4, 4, 32, False, None, None),
    (1, 384, 6, 2, 64, True, 256, 30.0),
]
PREFILL_LENS = (32, 64, 128, 256, 512, 200)
DECODE_SWEEP = [  # (b, t, h, kv, hd, window, cap): tests/test_kernels.py
    (2, 256, 8, 2, 64, None, None),
    (1, 512, 4, 4, 128, 128, None),
    (3, 256, 16, 8, 64, None, 30.0),
    (2, 384, 8, 1, 32, 64, None),
]
N_REQUESTS, MAX_BATCH, MAX_LEN, NEW_TOKENS = 16, 8, 1024, 32


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


def check_kernels():
    """Every kernel against its plain version; returns the slice-shape
    inputs and errors for the timing phase."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    rng = np.random.default_rng(0)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype).removeprefix("torch.")]
        cases = [c for c in FLASH_SWEEP]
        if dtype == torch.bfloat16:
            cases += [(1, s, 32, 8, 64, True, None, None)
                      for s in PREFILL_LENS]
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
            if dtype == torch.bfloat16 and s == max(PREFILL_LENS) and h == 32:
                out["flash"] = (q, k, v, kw, err)
        cases = [c for c in DECODE_SWEEP]
        if dtype == torch.bfloat16:
            cases.append((8, MAX_LEN, 32, 8, 64, None, None))
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
            if dtype == torch.bfloat16 and b == 8:
                out["decode"] = (q, k, v, kw, err)
    return out


def greedy_reference(cfg, params, prompt):
    """One request's greedy tokens through ``prefill``/``decode_step``.

    The prompt is padded as the engine pads it and decoded in a batch of
    ``MAX_BATCH`` rows (the request in row 0, the others idle), so every
    bf16 matmul sees the engine's shapes and rounds alike; the request's
    row is computed independently of the others, so any slot mix-up in the
    engine shows as different tokens.
    """
    from repro_torch.models import model as model_lib
    from repro_torch.serve.engine import _bucket
    s = len(prompt)
    bucket = min(_bucket(s - 1), MAX_LEN)
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :s - 1] = prompt[:-1]
    one = model_lib.init_cache(cfg, 1, MAX_LEN, device="cuda")
    _, one = model_lib.prefill(params, cfg, torch.from_numpy(toks).cuda(),
                               one)
    cache = model_lib.init_cache(cfg, MAX_BATCH, MAX_LEN, device="cuda")
    for g, p in zip(cache, one):
        for gs, ps in zip(g["slots"], p["slots"]):
            for key in gs:
                gs[key][:, 0].copy_(ps[key][:, 0])
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
            mock.patch.object(ops, "decode_attention", ref.decode_attention):
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


def serve(cfg, params, prompts):
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serve.engine import ServingEngine
    eng = ServingEngine(cfg, params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                        device="cuda")
    fa.flash_attention.launches = 0
    da.decode_attention.launches = 0
    t0 = time.perf_counter()
    eng.start()
    reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    for r in reqs:
        if not r.done.wait(600):
            raise AssertionError(f"request {r.rid} did not finish")
    wall = time.perf_counter() - t0
    eng.stop()
    launches = {"flash_attention": fa.flash_attention.launches,
                "decode_attention": da.decode_attention.launches}
    for r in reqs:
        if len(r.out_tokens) != NEW_TOKENS:
            raise AssertionError(f"request {r.rid}: {len(r.out_tokens)} "
                                 f"tokens, expected {NEW_TOKENS}")
    n_layers = cfg.num_layers
    if eng.n_prefills != N_REQUESTS or \
            launches["flash_attention"] != n_layers * eng.n_prefills:
        raise AssertionError(f"flash_attention launches {launches} for "
                             f"{eng.n_prefills} prefills x {n_layers} layers")
    if launches["decode_attention"] != n_layers * eng.n_decode_steps:
        raise AssertionError(f"decode_attention launches {launches} for "
                             f"{eng.n_decode_steps} steps x {n_layers} layers")
    lat = np.array([r.finish_t - r.submit_t for r in reqs])
    stats = {"requests": N_REQUESTS,
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


def kernel_numbers(inputs, launches, card):
    """Times of each kernel at the slice's shapes, beside its plain
    version, the PyTorch library call and the card's bound."""
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")
    rows = [_flash_row(*inputs["flash"]), _decode_row(*inputs["decode"])]
    out = []
    for r in rows:
        ms = time_ms(r["kernel"], flush)
        plain_ms = time_ms(r["plain"], flush)
        library_ms = time_ms(r["library"], flush)
        t_ops, t_bytes = r["flops"] / PEAK_FLOPS, r["nbytes"] / PEAK_BYTES
        out.append({
            "name": r["name"], "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": launches[r["name"]],
            "max_abs_err": r["err"], "ms": ms, "kernel_ms": ms,
            "plain_ms": plain_ms, "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, "shape_b_t_h_kv_hd": r["shape"],
            "dtype": "bfloat16", "flops": r["flops"], "bytes": r["nbytes"],
            "card": card})
    return out


def _category(kernel_name):
    n = kernel_name.lower()
    if "flash_fwd_kernel" in n or "decode_kernel" in n:
        return "attention_kernels"
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

    out = {}
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repo",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import tree_map

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
    for name, log in logs.items():
        entry = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "Used" in line and entry and "13__nv_bfloat16Li64E" in entry \
                    and ("flash" in entry or "Li4E" in entry):
                print(f"  {name} bf16 hd=64: {line.split(':', 1)[1].strip()}")

    # 2. kernels against their plain versions
    inputs = check_kernels()

    # 3. the slice
    cfg = get_config("llama3.2-1b")
    widths = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
              cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.dtype)
    if widths != (16, 2048, 32, 8, 64, 8192, 128256, "bfloat16"):
        raise AssertionError(f"llama3.2-1b is not at its published width: "
                             f"{widths}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        params = model_lib.init_params(gen, cfg, device="cuda")
        leaves = []
        tree_map(leaves.append, params)
        n_params = sum(p.numel() for p in leaves)
        print(f"llama3.2-1b: {n_params} params, bf16, on "
              f"{torch.cuda.get_device_name(0)}")
        parity = compare_plain_path(cfg, params)
        print("kernel vs plain path logits:", json.dumps(parity))
        prompts = make_prompts(cfg)
        picks = (0, N_REQUESTS - 1)  # slot 0 first, then a reused slot
        want = {i: greedy_reference(cfg, params, prompts[i])
                for i in picks}
    reqs, launches, stats = serve(cfg, params, prompts)
    for i in picks:
        if reqs[i].out_tokens != want[i]:
            raise AssertionError(f"request {i}: engine {reqs[i].out_tokens} "
                                 f"!= reference {want[i]}")
    print(f"requests {picks}: engine tokens equal the one-request greedy "
          f"reference")
    print("launches over the engine run:", json.dumps(launches))
    stats["card"] = card
    print(json.dumps({"slice": stats}))

    # 4. numbers
    with torch.inference_mode():
        print(json.dumps({"profile": profile_slice(cfg, params, card)}))
        rows = kernel_numbers(inputs, launches, card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
