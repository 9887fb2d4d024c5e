"""A training cell: the port's ``Trainer`` on the benchmark's weights and
batches.

Set-up builds one ``Trainer``, gives it the benchmark's weights (fresh
AdamW state over them) and its batches, and drives it through the first
``check.steps`` steps with the window's own call (``Trainer.train``):
the reference follows exactly these.  Their losses, the first gradient
as the optimizer took it (its first moment after step 1 over 1 - b1) and
each leaf's change over them are read there.  The window is one
``Trainer.train`` call on the same object, as many steps as fill the
run's seconds at the set-up's step time, timed to a synchronise; its
peak memory is taken after a reset.  With ``--trace 1`` the profiler
then covers ``profile.steps`` more whole steps.

After the window the trainer is freed and the reference runs the same
steps in fp32 from the same weights and batches.
"""
from __future__ import annotations

import gc
import statistics
import time

import torch

from perfbench import devtrace, flops, modelcfg, traffic, weights
from perfbench.reference import lm
from perfbench.reference import train as ref_train
from perfbench.reference.tree import tree_items, tree_map

GIB = float(1 << 30)


def _trainer(cfg, t: dict, seed: int, device):
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.trainer import Trainer, TrainerConfig
    o = t["optimizer"]
    opt = make_optimizer(o["name"], **{k: v for k, v in o.items()
                                       if k != "name"})
    never = 1 << 40
    tr = Trainer(cfg, TrainerConfig(steps=1, global_batch=t["batch"],
                                    seq_len=t["seq_len"], ckpt_every=never,
                                    eval_every=never, log_every=never,
                                    seed=seed % (1 << 32)),
                 optimizer=opt, device=device)
    tr.params = tr.opt_state = None    # the trainer's own draw
    gc.collect()
    tr.params = tree_map(lambda p: p.requires_grad_(True),
                         weights.make(cfg, seed, device))
    tr.opt_state = tr.opt.init(tr.params)
    tr.dataset = traffic.TrainBatches(t, seed, cfg.vocab_size)
    return tr


def program_readings(tr, cfg, seed: int, steps: int, device) -> dict:
    """Drive ``tr`` through its first ``steps`` steps; the losses, each
    leaf's first gradient (from the optimizer's first moment) and each
    leaf's change since the start."""
    b1 = tr.opt.cfg.b1
    tr.train(1)
    with torch.no_grad():
        first = {k: float(v.norm()) / (1 - b1)
                 for k, v in tree_items(tr.opt_state["m"])}
    tr.train(steps)
    with torch.no_grad():
        p0 = weights.make(cfg, seed, device)
        change = {k: float((v.float() - w.float()).norm())
                  for (k, v), (_, w) in zip(tree_items(tr.params),
                                            tree_items(p0))}
        del p0
    return {"losses": [h["loss"] for h in tr.history[:steps]],
            "first_grad": first, "change": change}


def run(cell: dict, conf: dict, t: dict, limits: dict, seed: int,
        seconds: float, trace: bool, device, t_start: float) -> dict:
    m = conf["model"]
    cfg = modelcfg.build(conf)
    if device.type == "cuda":
        from repro_torch.kernels import build
        build.build_all()
    tr = _trainer(cfg, t, seed, device)
    n_params = weights.n_params(tr.params)
    k = t["check"]["steps"]
    prog = program_readings(tr, cfg, seed, k, device)
    step_s = statistics.median(h["time_s"] for h in tr.history[1:k])
    n = max(1, round(seconds / step_s))
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    t0 = time.perf_counter()
    tr.train(k + n)
    if cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    window = tr.history[k:k + n]
    tokens = n * t["batch"] * t["seq_len"]
    obs = {"window_s": t1 - t0, "steps": n,
           "step_ms": [1e3 * h["time_s"] for h in window],
           "n_params": n_params,
           "step_flops": flops.train_step_flops(n_params, m, t["batch"],
                                                t["seq_len"])}
    if trace:
        obs.update(_profile(tr, k + n, t))
    del tr
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = reference_readings(cfg, m, t, seed, k, device, "fp32")
    checks, other = compare(prog, ref, limits)
    return {
        "metrics": {"train_tokens_per_s": tokens / (t1 - t0),
                    "train_peak_gib": peak / GIB,
                    "setup_s": setup_s},
        "attempted": n, "failed": 0, "checks": checks,
        "memory_peak_bytes": max(peak, setup_peak) if cuda else 0,
        "obs": obs, "readings": other,
        "reference_s": time.perf_counter() - t_ref}


def _profile(tr, done: int, t: dict) -> dict:
    import collections

    from repro_torch.kernels import flash_attention as fa
    p = t["profile"]["steps"]
    f0 = collections.Counter(fa.flash_attention.shapes)
    b0 = collections.Counter(fa.flash_attention_bwd.shapes)
    with devtrace.Profiled() as prof:
        tr.train(done + p)
    return {"trace": prof.result, "profile_steps": p,
            "sub_flash": collections.Counter(fa.flash_attention.shapes) - f0,
            "sub_flash_bwd":
                collections.Counter(fa.flash_attention_bwd.shapes) - b0}


def reference_readings(cfg, m: dict, t: dict, seed: int, steps: int, device,
                       precision: str, drop_half: bool = False) -> dict:
    """The reference's readings over the same weights and first batches."""
    lm.exact_fp32()
    params = weights.make(cfg, seed, device)
    batches = []
    for s in range(steps):
        b = traffic.train_batch(t, seed, cfg.vocab_size, s)
        batches.append((torch.from_numpy(b["tokens"]).long().to(device),
                        torch.from_numpy(b["labels"]).long().to(device)))
    o = dict(t["optimizer"])
    return ref_train.run(params, m, o, batches, lm.Ops(precision), drop_half)


def readings(prog: dict, ref: dict) -> dict:
    """Every number the check can compare, as (value, the step or leaf
    that gave it).

    * ``loss_gap.stepN``: step N's relative loss gap.
    * ``grad_norm_gap``: over the leaves, the gap between the program's
      and the reference's norm of the first gradient, over the
      reference's norm of that leaf or of the median leaf, whichever is
      larger.
    * ``change_norm_gap``: the same of each leaf's change over the steps,
      over the leaves whose reference gradient is at least a thousandth
      of the median leaf's (the others move by round-off alone).
    * ``grad_norm_gap.median``, ``change_norm_gap.median``: the median
      leaf's gap of each, steady from seed to seed where the worst leaf
      is one small leaf's noise.
    """
    out = {f"loss_gap.step{i + 1}": (abs(a - b) / abs(b), f"step {i + 1}")
           for i, (a, b) in enumerate(zip(prog["losses"], ref["losses"]))}
    gr = ref["first_grad"]
    med_g = statistics.median(gr.values())
    grads = {k: abs(prog["first_grad"][k] - v) / max(v, med_g)
             for k, v in gr.items()}
    moved = [k for k, v in gr.items() if v >= 1e-3 * med_g]
    cr = ref["change"]
    med_c = statistics.median(cr[k] for k in moved)
    changes = {k: abs(prog["change"][k] - cr[k]) / max(cr[k], med_c)
               for k in moved}
    for name, gaps in (("grad_norm_gap", grads),
                       ("change_norm_gap", changes)):
        at = max(gaps, key=gaps.get)
        out[name] = (gaps[at], at)
        out[f"{name}.median"] = (statistics.median(gaps.values()),
                                 f"median of {len(gaps)} leaves")
    return out


def compare(prog: dict, ref: dict, limits: dict) -> dict:
    """The numbers that ``limits`` names, each with its limit; the other
    readings under ``readings`` (printed, not compared)."""
    got = readings(prog, ref)
    checks = {name: {"value": got[name][0], "limit": lim,
                     "holds": got[name][0] <= lim, "at": got[name][1]}
              for name, lim in limits.items() if not name.startswith("_")}
    return checks, {k: v for k, v in got.items() if k not in checks}
