#!/usr/bin/env python3
"""Readings that set a cell's correctness limits, at the cell's own size:

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds 15]

For each seed it prints one JSON line: the numbers the check compares for
the program, for the control (the reference put in the program's place
and computed in fp8, the precision below the configuration's bf16) and
for the planted faults the cell can have:

* serving: a token altered where it is produced (``fault_gap``), on the
  sample of a run with a short window at the cell's load;
* training: half of the batch left out and the mean taken over the rest
  (``fault_half``), planted in the reference put in the program's place;
  a step that returns its state unchanged reads 1 on ``change_norm_gap``
  by that number's definition and needs no run.

The benchmark's own runs never run this.
"""
import json
import sys
import time

if __name__ == "__main__":
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(root), str(root / "src")]


def serve_readings(files: dict, seed: int, seconds: float, device) -> dict:
    from perfbench import serve_cell
    out = serve_cell.run(files["cell"], files["config"], files["traffic"],
                         files["limits"], seed, seconds, False, device,
                         time.perf_counter(), control=True)
    return {"program": out["judged"]["max_logit_gap"],
            "control": out["judged"]["control_gap"],
            "fault_token_altered": out["judged"]["fault_gap"],
            "served_tokens_checked": out["served_tokens_checked"],
            "requests_done": out["attempted"]}


def train_readings(files: dict, seed: int, device) -> dict:
    import gc

    import torch

    from perfbench import modelcfg, train_cell
    conf, t = files["config"], files["traffic"]
    m, cfg = conf["model"], modelcfg.build(conf)
    k = t["check"]["steps"]
    if device.type == "cuda":
        from repro_torch.kernels import build
        build.build_all()
    tr = train_cell._trainer(cfg, t, seed, device)
    prog = train_cell.program_readings(tr, cfg, seed, k, device)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    ref = train_cell.reference_readings(cfg, m, t, seed, k, device, "fp32")
    out = {}
    for name, side in (
            ("program", prog),
            ("control", train_cell.reference_readings(
                cfg, m, t, seed, k, device, "fp8")),
            ("fault_half", train_cell.reference_readings(
                cfg, m, t, seed, k, device, "fp32", drop_half=True))):
        out[name] = train_cell.readings(side, ref)
    return out


def main(argv) -> int:
    import argparse

    import torch

    from perfbench import harness
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args(argv)
    harness.setup_env()
    files = harness.cell_files(harness.manifest(), args.workload)
    device = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if files["traffic"]["kind"] == "train":
            r = train_readings(files, seed, device)
        else:
            r = serve_readings(files, seed, args.seconds, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          "card": harness.power_limit(), **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
