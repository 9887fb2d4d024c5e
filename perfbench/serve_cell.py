"""A serving cell: a closed loop of clients against the port's
``ServingEngine``.

Set-up makes the weights, builds the engine (its cache of ``slots`` x
``max_len`` positions, its warm runtime pool) and warms up every prefill
length the pool's prompts will use and the decode step.  Then each client
sends a request, waits for it to finish and sends the next; client starts
are staggered by ``stagger_s``.  The window opens once every client has
had one request finished and lasts the run's seconds.  With ``--trace 1``
a sub-window of ``profile.seconds`` starting ``profile.offset_s`` into the
window is profiled.

After the window the engine stops, the peak memory is read, the engine's
state is freed, and the reference checks a sample of the requests that
finished in the window, drawn from the seed with the longest among them.
"""
from __future__ import annotations

import collections
import gc
import statistics
import time

import numpy as np
import torch

from perfbench import devtrace, flops, modelcfg, traffic, weights
from perfbench.reference import lm
from perfbench.reference import serve as ref_serve

POLL_S = 0.002


def p95(values: list) -> float:
    """The 95th percentile (``statistics.quantiles``, inclusive)."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=20, method="inclusive")[18]


class _Record:
    __slots__ = ("req", "prompt_len", "new", "open_tokens", "open_admitted",
                 "close_tokens")

    def __init__(self, req, prompt_len, new):
        self.req, self.prompt_len, self.new = req, prompt_len, new
        self.open_tokens = None
        self.open_admitted = False
        self.close_tokens = 0


def _snapshot(eng, records) -> dict:
    """The engine's counters now; each of ``records`` not yet stamped gets
    its tokens so far and whether it was already admitted (prefilled)."""
    from repro_torch.kernels import flash_attention as fa
    admitted = {id(r) for r in list(eng.active) if r is not None}
    obs = eng.observe()
    for r in records:
        if r.open_tokens is None:
            r.open_tokens = len(r.req.out_tokens)
            r.open_admitted = r.open_tokens > 0 or id(r.req) in admitted
    return {"admitted": admitted, "t": time.perf_counter(), "n_generated": eng.n_generated,
            "n_decode_steps": eng.n_decode_steps,
            "n_prefills": eng.n_prefills,
            "server_busy": obs["server_busy"],
            "n_finished": obs["n_finished"],
            "flash": collections.Counter(fa.flash_attention.shapes)}


def warm_lengths(cfg, stream, max_len: int) -> list:
    """One prompt length of the pool for each padded prefill length the
    pool uses (the longest that pads to it), so that warm-up prefills each
    exactly once and fits the cache as the pool's requests do."""
    from repro_torch.serve.engine import prefill_length
    longest: dict = {}
    for s in (int(s) for s in stream.prompts if s > 1):
        p = prefill_length(cfg, s - 1, max_len)
        longest[p] = max(longest.get(p, 0), s)
    return [longest[p] for p in sorted(longest)]


def run(cell: dict, conf: dict, t: dict, limits: dict, seed: int,
        seconds: float, trace: bool, device, t_start: float,
        control: bool = False) -> dict:
    """One run; ``control`` also reads the control and a planted fault on
    the same sample (``perfbench/control.py``)."""
    from repro_torch.serve.engine import ServingEngine
    m = conf["model"]
    cfg = modelcfg.build(conf)
    params = weights.make(cfg, seed, device)
    n_params = weights.n_params(params)
    stream = traffic.RequestStream(t, seed, cfg.vocab_size)
    if device.type == "cuda":
        from repro_torch.kernels import build
        build.build_all()
    eng = ServingEngine(cfg, params, max_batch=t["slots"],
                        max_len=t["max_len"], device=device)
    eng.start()
    try:
        g = traffic.rng(seed, 5)
        warm = [eng.submit(g.integers(0, cfg.vocab_size, n, dtype=np.int32),
                           2) for n in warm_lengths(cfg, stream,
                                                    t["max_len"])]
        for r in warm:
            r.done.wait()
        if eng.error is not None:
            raise RuntimeError("warm-up failed") from eng.error
        setup_s = time.perf_counter() - t_start
        out = _loop(eng, stream, t, seconds, trace)
    finally:
        try:
            eng.stop()
        except RuntimeError as e:
            out = {"error": repr(e.__cause__ or e)}
    if device.type == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    else:
        peak = 0
    if "error" in out:
        return {"error": out["error"], "setup_s": setup_s,
                "memory_peak_bytes": peak}
    records, o, c = out["records"], out["open"], out["close"]
    done = [r for r in records
            if r.req.done.is_set() and o["t"] <= r.req.finish_t <= c["t"]]
    lat_ms = [1e3 * (r.req.finish_t - r.req.submit_t) for r in done]
    wrong = [r for r in done if len(r.req.out_tokens) != r.new]
    window_s = c["t"] - o["t"]

    obs = _window_obs(records, o, c, m, n_params, t["slots"], window_s)
    obs.update(out.get("profile", {}))
    # the check: a sample of the requests finished in the window
    sample = _sample(done, seed, t["check"]["requests"])
    samples = [(r.req.prompt.tolist(), list(r.req.out_tokens))
               for r in sample]
    del eng, out, records
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    judged = judge(params, m, samples, device, control)
    gap = judged["max_logit_gap"]
    checks = {     # no request finished: no sample, an infinite gap
        "wrong_token_counts": {"value": len(wrong), "limit": 0,
                               "holds": not wrong},
        "max_logit_gap": {"value": gap, "limit": limits["max_logit_gap"],
                          "holds": gap <= limits["max_logit_gap"]},
    }
    return {
        "metrics": {
            "serve_tokens_per_s": (c["n_generated"] - o["n_generated"])
            / window_s,
            "request_p95_ms": p95(lat_ms) if lat_ms else float("nan"),
            "setup_s": setup_s},
        "attempted": len(done), "failed": len(wrong), "checks": checks,
        "memory_peak_bytes": peak, "obs": obs,
        "served_tokens_checked": sum(len(s[1]) for s in samples),
        "reference_s": time.perf_counter() - t_ref, "judged": judged}


def _loop(eng, stream, t: dict, seconds: float, trace: bool) -> dict:
    clients = t["clients"]
    t0 = time.perf_counter()
    start_at = [t0 + i * t["stagger_s"] for i in range(clients)]
    current: list = [None] * clients
    served: set = set()
    records: list = []
    prof_cfg = t.get("profile", {})
    opened = closed = None
    prof = None
    result: dict = {}
    while closed is None:
        now = time.perf_counter()
        if eng.error is not None:
            return {"error": repr(eng.error)}
        for i in range(clients):
            r = current[i]
            if r is not None and r.req.done.is_set():
                served.add(i)
                current[i] = r = None
            if r is None and now >= start_at[i]:
                prompt, new = stream.next()
                current[i] = _Record(eng.submit(prompt, new), len(prompt),
                                     new)
                records.append(current[i])
        if opened is None and len(served) == clients:
            opened = _snapshot(eng, records)
        if opened is not None:
            rel = now - opened["t"]
            if trace and prof is None and rel >= prof_cfg["offset_s"]:
                prof = devtrace.Profiled().__enter__()
                p0 = _snapshot(eng, [])
            if prof is not None and "sub" not in result and \
                    rel >= prof_cfg["offset_s"] + prof_cfg["seconds"]:
                p1 = _snapshot(eng, [])
                prof.__exit__(None, None, None)
                result["sub"] = True
                result["profile"] = {
                    "trace": prof.result,
                    "sub_flash": p1["flash"] - p0["flash"]}
            if rel >= seconds:
                closed = _snapshot(eng, [])
                for r in records:
                    r.close_tokens = len(r.req.out_tokens)
                break
        time.sleep(POLL_S)
    if trace and "sub" not in result:
        raise RuntimeError("the profiled sub-window does not fit the window")
    # tokens of requests sent after the window opened count from 0
    for r in records:
        if r.open_tokens is None:
            r.open_tokens = 0
    result.update(records=records, open=opened, close=closed)
    return result


def _window_obs(records, o, c, m: dict, n_params: int, slots: int,
                window_s: float) -> dict:
    """What the per-layer readers read about the window (counts, deltas,
    model FLOPs)."""
    prompt_real = 0
    model_flops = 0
    for r in records:
        k0, k1 = r.open_tokens, r.close_tokens
        if not r.open_admitted and (k1 > 0 or id(r.req) in c["admitted"]):
            # prefilled in the window
            prompt_real += r.prompt_len - 1
            model_flops += flops.prefill_flops(n_params, m, r.prompt_len - 1)
        for i in range(k0, k1):     # token i chosen at prompt_len - 1 + i
            model_flops += flops.decode_flops(n_params, m,
                                              r.prompt_len - 1 + i)
    return {
        "window_s": window_s, "slots": slots, "n_params": n_params,
        "attention_layers": flops.attention_layers(m),
        "generated": c["n_generated"] - o["n_generated"],
        "decode_steps": c["n_decode_steps"] - o["n_decode_steps"],
        "prefills": c["n_prefills"] - o["n_prefills"],
        "server_busy_s": c["server_busy"] - o["server_busy"],
        "tasks_finished": c["n_finished"] - o["n_finished"],
        "prompt_tokens_needed": prompt_real,
        "flash_shapes": c["flash"] - o["flash"],
        "model_flops": model_flops,
    }


def _sample(done: list, seed: int, k: int) -> list:
    """``k`` of the finished requests, drawn from the seed, with the longest
    (prompt and served tokens) among them."""
    if not done:
        return []
    longest = max(done, key=lambda r: r.prompt_len + len(r.req.out_tokens))
    rest = [r for r in done if r is not longest]
    g = traffic.rng(seed, 4)
    pick = g.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def judge(params, m: dict, samples: list, device,
          control: bool = False) -> dict:
    """``max_logit_gap``: the widest gap of the served tokens below the fp32
    reference's best logit, over ``samples`` (prompt, tokens).  With
    ``control``, also ``control_gap`` (the tokens an fp8 reference puts
    first at the same positions) and ``fault_gap`` (each sample's middle
    served token replaced by the next id: a token altered where it is
    produced)."""
    if not samples:
        return {"max_logit_gap": float("inf")}
    lm.exact_fp32()
    seqs, starts = ref_serve.served_sequences(samples, device)
    ref = ref_serve.logits_at(params, m, seqs, starts, lm.Ops("fp32"))
    out = {"max_logit_gap": ref_serve.widest_gap(ref, [s[1] for s in
                                                      samples])}
    if control:
        ctrl = ref_serve.logits_at(params, m, seqs, starts, lm.Ops("fp8"))
        out["control_gap"] = ref_serve.control_gap(ref, ctrl)
        vocab = ref[0].shape[-1]
        altered = []
        for _, toks in samples:
            toks = list(toks)
            i = len(toks) // 2
            toks[i] = (toks[i] + 1) % vocab
            altered.append(toks)
        out["fault_gap"] = ref_serve.widest_gap(ref, altered)
    return out
