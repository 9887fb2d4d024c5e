"""One run of one cell: the command line, the manifest, the cell's runner,
the per-layer readers and the result line.

Everything a cell needs is found by name from ``BENCHMARK.json``: the
configuration file it names, ``traffic/<traffic>.json`` (whose ``kind``
names the runner, ``<kind>_cell.py`` beside this file), ``limits/<cell>.json`` (the limits of the correctness
check) and ``metrics/<metric>.py`` for each per-layer metric (a module
with ``read(obs) -> float | None``).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")



def runner_module(kind: str) -> str:
    """The module that runs a traffic of ``kind``: ``<kind>_cell.py`` here,
    with ``run(...) -> dict``."""
    if not kind.replace("_", "").isalnum() or \
            not (HERE / f"{kind}_cell.py").is_file():
        raise SystemExit(f"no runner for traffic kind {kind!r} "
                         f"(perfbench/{kind}_cell.py)")
    return f"perfbench.{kind}_cell"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_files(bench: dict, name: str, here: Path = HERE) -> dict:
    """The cell ``name`` and its configuration, traffic and limits."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; cells: "
                         f"{sorted(cells)}")
    cell = cells[name]
    conf_entry = next(c for c in bench["configs"]
                      if c["name"] == cell["config"])
    return {"cell": cell,
            "config": load_json(here.parent / conf_entry["file"]),
            "traffic": load_json(here / "traffic" / f"{cell['traffic']}.json"),
            "limits": load_json(here / "limits" / f"{name}.json")}


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end ones, or with
    ``trace`` its per-layer ones."""
    key = "per_layer" if trace else "end_to_end"
    return [mt for mt in bench[key]
            if "workloads" not in mt or cell in mt["workloads"]]


def reader(name: str, here: Path = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def device_info(torch, device, count: int, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": peak}


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def result_line(bench: dict, cell: str, out: dict, trace: bool,
                device: dict, here: Path = HERE) -> dict:
    """The last line of the run's standard output."""
    metrics = {}
    for mt in metrics_of(bench, cell, trace):
        if trace:
            value = reader(mt["name"], here)(out["obs"])
        else:
            value = out["metrics"].get(mt["name"])
        if value is None or (isinstance(value, float) and math.isnan(value)):
            continue
        metrics[mt["name"]] = {"value": value, "unit": mt["unit"]}
    checks = out["checks"]
    line = {"correct": all(c["holds"] for c in checks.values()),
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": dict(device)}
    if trace and "trace" in out["obs"]:
        tr = out["obs"]["trace"]
        line["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        line["breakdown"] = tr["breakdown"]
    line["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                      for k, c in checks.items()}
    return line


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def setup_env(root: Path = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def execute(args, t_start: float, device_name: str | None = None,
            root: Path = ROOT) -> tuple[dict, dict]:
    """Run the cell and return (result line, the runner's output).  The
    device is the card unless ``device_name`` says otherwise, and the
    checkout is ``root`` (both for the tests)."""
    import importlib

    import torch
    here = root / "perfbench"
    bench = manifest(root)
    files = cell_files(bench, args.workload, here)
    cell = files["cell"]
    if device_name is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(f"{args.workload} needs {cell['chips']} CUDA "
                             f"device(s); torch sees "
                             f"{torch.cuda.device_count()}")
        device = torch.device("cuda")
    else:
        device = torch.device(device_name)
    runner = importlib.import_module(runner_module(files["traffic"]["kind"]))
    out = runner.run(cell, files["config"], files["traffic"],
                     files["limits"], args.seed, args.seconds,
                     bool(args.trace), device, t_start)
    if "error" in out:
        raise RuntimeError(f"{args.workload}: the program failed: "
                           f"{out['error']}")
    line = result_line(bench, args.workload, out, bool(args.trace),
                       device_info(torch, device, cell["chips"],
                                   out["memory_peak_bytes"]), here)
    return line, out


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    setup_env()
    line, out = execute(args, t_start)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: JAX or the JAX package",
              file=sys.stderr)
        return 3
    print(f"card: {power_limit()}; reference {out['reference_s']:.1f} s",
          file=sys.stderr)
    for k, (value, at) in out.get("readings", {}).items():
        print(f"reading {k}: {value!r} at {at} (not compared)",
              file=sys.stderr)
    for k, c in out["checks"].items():
        at = f" at {c['at']}" if "at" in c else ""
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}{at} "
              f"{'ok' if c['holds'] else 'FAILED'}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0
