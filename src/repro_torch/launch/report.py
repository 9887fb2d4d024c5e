"""Markdown tables of the dry-run matrix and its roofline (counterpart of
the JAX package's ``scripts/make_experiments.py``), from the records that
:mod:`repro_torch.launch.dryrun` writes.

  python -m repro_torch.launch.dryrun --all --mesh both --jobs 8
  python -m repro_torch.launch.dryrun --all --mesh both --optimized --jobs 8
  python -m repro_torch.launch.report [--dir build/dryrun_torch]

A record whose file ends in ``_opt`` (an ``--optimized`` run) shows with
``+OPT`` after its mesh.  The roofline terms are recomputed from each
record's corrected costs and its model FLOPs under the H100 constants of
:mod:`.roofline`.
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.launch import roofline as rl


def load(art: pathlib.Path) -> dict:
    """{(arch, shape, mesh): record} of the records in ``art``."""
    recs = {}
    for f in sorted(art.glob("*.json")):
        rec = json.loads(f.read_text())
        mesh = rec["mesh"] + ("+OPT" if f.stem.endswith("_opt") else "")
        recs[(rec["arch"], rec["shape"], mesh)] = rec
    return recs


def recompute_roofline(rec) -> rl.Roofline:
    """The roofline of a record's corrected costs and model FLOPs."""
    corr = rec["corrected"]
    return rl.Roofline(flops=corr["flops"], bytes_accessed=corr["bytes"],
                       wire_bytes=corr["wire_bytes"],
                       model_flops=rec["roofline"]["model_flops_per_dev"])


def render(recs: dict) -> str:
    lines = ["### Dry-run matrix (single-pod 16x16 = 256 H100s; multi-pod "
             "2x16x16 = 512 H100s)\n",
             "| arch | shape | mesh | status | step s | peak GB/dev | "
             "collectives (corrected counts) |",
             "|---|---|---|---|---|---|---|"]
    for (a, s, m), rec in sorted(recs.items()):
        if rec["status"] == "skip":
            lines.append(f"| {a} | {s} | {m} | SKIP (full-attn long-ctx) "
                         f"| | | |")
            continue
        if rec["status"] != "ok":
            lines.append(f"| {a} | {s} | {m} | **ERROR** | | | "
                         f"{rec.get('error', '')[:60]} |")
            continue
        full = rec["full"]
        peak = full["memory"]["peak_bytes_per_dev"] / 1e9
        colls = rec.get("corrected", {}).get("collective_counts",
                                             full["collective_counts"])
        cstr = " ".join(f"{k.replace('all-', 'a')}:{int(v)}"
                        for k, v in sorted(colls.items()))
        lines.append(f"| {a} | {s} | {m} | ok | {full['step_s']:.1f} | "
                     f"{peak:.1f} | {cstr} |")
    lines += ["",
              f"### Roofline (single-pod, per-device, corrected costs; "
              f"H100 SXM: {rl.PEAK_FLOPS / 1e12:.0f} TF bf16, "
              f"{rl.HBM_BW / 1e12:.2f} TB/s HBM, {rl.LINK_BW / 1e9:.0f} GB/s "
              f"link)\n",
              "| arch | shape | t_comp s | t_mem s | t_coll s | bottleneck | "
              "useful | roofline frac |",
              "|---|---|---|---|---|---|---|---|"]
    for (a, s, m), rec in sorted(recs.items()):
        if not m.startswith("single") or rec["status"] != "ok" \
                or "corrected" not in rec:
            continue
        a = a + (" (OPTIMIZED)" if m.endswith("OPT") else "")
        r = recompute_roofline(rec)
        lines.append(f"| {a} | {s} | {r.t_compute:.3f} | {r.t_memory:.3f} | "
                     f"{r.t_collective:.3f} | {r.bottleneck} | "
                     f"{r.useful_ratio:.2f} | {r.roofline_fraction:.4f} |")
    return "\n".join(lines)


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/dryrun_torch",
                    help="the dry-run's records (its --out)")
    args = ap.parse_args(argv)
    text = render(load(pathlib.Path(args.dir)))
    print(text)
    return text


if __name__ == "__main__":
    main()
