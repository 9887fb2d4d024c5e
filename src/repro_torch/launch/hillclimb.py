"""The measure step of the hill-climb (counterpart of the JAX package's
``scripts/hillclimb.py``): run one dry-run cell with config and
logical-rule overrides and print its corrected roofline terms.

  python -m repro_torch.launch.hillclimb --arch llama3.2-1b \\
      --shape train_4k [--set remat=dots] [--set fuse_qkv=1] \\
      [--set moe.group_size=512] [--rule seq=model] [--rule ffn=none]

``--set field=value`` replaces a config field (``sub.field`` one of a
nested config), its value coerced to the field's type; ``--rule
name=axis`` replaces a logical rule of
:func:`repro_torch.parallel.annotate.make_rules` (``none`` for None,
``a+b`` for a tuple of mesh axes).  The cell runs on the port's dry-run
(:func:`repro_torch.launch.dryrun.measure_cell`: meta DTensors over the
fake 256-rank mesh, or with ``--mesh multi`` the 512-rank one) and its
H100 roofline (:mod:`.roofline`).  Beside the JAX script's flags:
``--optimized`` starts from the optimized config, ``--smoke`` from the
smoke config, ``--device`` sets the mesh's device type (default cuda).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.common import SHAPE_CASES


def _coerce(obj, k: str, v: str):
    field = {f.name: f for f in dataclasses.fields(obj)}[k]
    if field.type in ("bool", bool):
        return v in ("1", "true", "True")
    if field.type in ("int", int):
        return int(v)
    if field.type in ("float", float):
        return float(v)
    return v


def apply_sets(cfg, sets):
    """``cfg`` with each ``field=value`` (or ``sub.field=value``) of
    ``sets`` applied, as the JAX script applies ``--set``."""
    for kv in sets:
        k, v = kv.split("=", 1)
        if "." in k:  # nested, e.g. moe.group_size=512
            sub, leaf = k.split(".", 1)
            subcfg = getattr(cfg, sub)
            subcfg = dataclasses.replace(subcfg,
                                         **{leaf: _coerce(subcfg, leaf, v)})
            cfg = dataclasses.replace(cfg, **{sub: subcfg})
        else:
            cfg = dataclasses.replace(cfg, **{k: _coerce(cfg, k, v)})
    return cfg


def parse_rules(rules) -> dict:
    """``name=axis`` overrides of the logical rules: ``none`` is None,
    ``a+b`` the tuple of mesh axes (a, b)."""
    over = {}
    for kv in rules:
        k, v = kv.split("=", 1)
        over[k] = (None if v in ("none", "None") else
                   tuple(v.split("+")) if "+" in v else v)
    return over


def _field(cfg, key: str):
    for part in key.split("."):
        cfg = getattr(cfg, part)
    return cfg


def main(argv=None, mesh=None) -> dict:
    """Run the cell and print its record as JSON; returns the record.
    ``mesh`` (a mesh to use in place of the production one) is for tests
    on small configs."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=dryrun.SHAPES)
    ap.add_argument("--set", action="append", default=[],
                    help="cfg field overrides, e.g. remat=dots")
    ap.add_argument("--rule", action="append", default=[],
                    help="logical rule overrides, e.g. seq=model")
    ap.add_argument("--tag", default="variant")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--optimized", action="store_true",
                    help="start from the optimized config")
    ap.add_argument("--smoke", action="store_true",
                    help="start from the smoke config")
    ap.add_argument("--device", default=None,
                    help="the mesh's device type (default cuda)")
    args = ap.parse_args(argv)

    if args.optimized:
        from repro_torch.configs.optimized import optimized_config
        cfg = optimized_config(args.arch, smoke=args.smoke)
    else:
        cfg = configs.get_config(args.arch, smoke=args.smoke)
    cfg = apply_sets(cfg, args.set)
    rule_over = parse_rules(args.rule)

    case = SHAPE_CASES[args.shape]
    if mesh is None:
        mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                    device=args.device)
    t0 = time.time()
    full = dryrun.measure_cell(cfg, case, mesh, rule_over)
    corr = {k: full[k] for k in ("flops", "bytes", "wire_bytes",
                                 "collective_counts")}
    corr["flops"] += dryrun.slstm_correction(cfg, case, mesh)
    tokens = case.global_batch * (case.seq_len
                                  if case.kind != "decode" else 1)
    mf = rl.model_flops(cfg.active_param_count(), tokens, case.kind) \
        + rl.attn_model_flops(cfg, case)
    roof = rl.Roofline(flops=corr["flops"], bytes_accessed=corr["bytes"],
                       wire_bytes=corr["wire_bytes"],
                       model_flops=mf / mesh.size())
    out = {"tag": args.tag, "arch": args.arch, "shape": args.shape,
           "overrides": args.set, "rules": args.rule,
           "config": {kv.split("=", 1)[0]: _field(cfg, kv.split("=", 1)[0])
                      for kv in args.set},
           "n_devices": mesh.size(),
           "peak_gb": full["memory"]["peak_bytes_per_dev"] / 1e9,
           "collectives": corr["collective_counts"],
           **{k: round(v, 4) for k, v in roof.to_dict().items()
              if isinstance(v, float)},
           "bottleneck": roof.bottleneck,
           "wall_s": round(time.time() - t0, 1)}
    print(json.dumps(out, indent=1, default=str))
    return out


if __name__ == "__main__":
    main()
