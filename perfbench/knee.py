#!/usr/bin/env python3
"""The knee of a serving cell's closed loop, found once by a sweep on the
card:

    python3 perfbench/knee.py --workload <cell> --seed <n> \
        --clients 1,2,4,8,16,32 --seconds 20

For each number of clients (with as many slots) it runs the cell's mix
once with a window of ``--seconds`` and prints one JSON line: tokens/s,
the p95 latency, the requests finished and the device's memory peak.
Tokens/s stop rising at the knee.  The benchmark's own runs never run
this.
"""
import json
import sys
import time

if __name__ == "__main__":
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(root), str(root / "src")]


def main(argv) -> int:
    import argparse

    import torch

    from perfbench import harness, serve_cell
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--clients", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    harness.setup_env()
    files = harness.cell_files(harness.manifest(), args.workload)
    for n in (int(c) for c in args.clients.split(",")):
        t = dict(files["traffic"], clients=n, slots=n,
                 check={"requests": 1})
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = serve_cell.run(files["cell"], files["config"], t,
                             files["limits"], args.seed, args.seconds,
                             False, torch.device("cuda"), t0)
        print(json.dumps({"workload": args.workload, "clients": n,
                          "seed": args.seed, **out["metrics"],
                          "requests": out["attempted"],
                          "memory_peak_bytes": out["memory_peak_bytes"],
                          "seconds": time.perf_counter() - t0,
                          "card": harness.power_limit()}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
