"""Multi-pod dry-run (counterpart of :mod:`repro.launch.dryrun`): run
every (arch x shape x mesh) cell's step once, eagerly, on ``meta`` DTensors
placed by the production specs over a fake process group of 256 or 512
ranks, and record per-device memory, FLOPs, bytes and collectives, and an
H100 roofline (:mod:`.roofline`).

This process is rank 0 of the fake group; every other rank runs the same
step on shards of the same shapes.  The step runs inside
``logical_rules`` (the hints place the activations) and
``ops.fake_kernels`` (the kernels' fakes and FLOP formulas,
:mod:`repro_torch.kernels.meta`), under a dispatch mode that sees the
local ops DTensor issues on rank 0's shards:

* ``flops``: the local ops' FLOPs, by :mod:`torch.utils.flop_counter`'s
  formulas (matrix products, attention) and the kernels' own; elementwise
  ops other than the kernels' count none;
* ``bytes``: the bytes each local op reads and writes (views count none);
* collectives: each functional collective DTensor issues (op, tensor
  bytes, group size), costed with JAX's ring factors;
* ``memory``: per-device argument bytes (params, optimizer state, cache,
  inputs: the local shards) and, for a training step, the bytes autograd
  saves for the backward (``saved_tensors_hooks``, each storage once, the
  arguments' own left out) plus each remat-checkpointed repeat's input,
  which the checkpoint keeps outside those hooks.  This stands where the
  JAX record has XLA's temp bytes.

XLA counts a scan body once, so the JAX dry-run extrapolates its costs
from unrolled variants (``corrected_costs``, ``variant_cfg``).  An eager
step runs every layer, so the port keeps neither: the record's
``corrected`` holds the step's own counts plus :func:`slstm_correction`,
since on meta tensors the sLSTM time loop runs
``xlstm.META_SCAN_STEPS`` steps (``--skip-variants`` is accepted and
changes nothing).

Usage:
  python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k \\
      --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --jobs 8
The mesh is of device type ``cuda`` unless ``--device cpu``; no tensor is
allocated on either.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as model_lib
from repro_torch.models import xlstm
from repro_torch.models.common import SHAPE_CASES, tree_leaves
from repro_torch.models.config import dtype_named
from repro_torch.parallel import sharding
from repro_torch.parallel.annotate import logical_rules, make_rules
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import make_train_step

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]

# ops that move no bytes: allocations, and the wait on a collective
_NO_BYTES = {"empty", "empty_strided", "new_empty", "new_empty_strided",
             "empty_like", "wait_tensor", "_wrap_tensor_autograd", "detach"}

_COLLECTIVES = {
    # DTensor's move of a shard to another tensor dim on a cuda mesh (on
    # a cpu mesh it falls back to an all-gather and a slice)
    "shard_dim_alltoall": "all-to-all",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _nbytes(t) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


def _group_size(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


class Counter(TorchDispatchMode):
    """FLOPs, bytes and collectives of the local ops of a step (this
    rank's).  An op on DTensors is left to DTensor (``NotImplemented``),
    so the mode sees what it issues: the op on the local shards and the
    collectives of its redistributions.  The fake-tensor calls by which
    DTensor infers an op's global output shape are not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.stats = rl.CollectiveStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out  # DTensor's shape propagation, on global shapes
        packet = func._overloadpacket
        if packet.__name__ in _COLLECTIVES and (
                "c10d" in str(packet) or "_dtensor" in str(packet)):
            self._collective(packet.__name__, args, out)
            return out
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        if isinstance(out, FakeTensor):
            return out  # the fake arguments it makes for one
        if not func.is_view and packet.__name__ not in _NO_BYTES:
            ts = [a for a in torch.utils._pytree.tree_leaves(
                (args, kwargs, out)) if isinstance(a, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size() for t in ts)
        return out

    def _collective(self, name, args, out):
        op = _COLLECTIVES[name]
        if name == "all_gather_into_tensor":
            n, nbytes = args[1], _nbytes(out)
        elif name == "reduce_scatter_tensor":
            n, nbytes = args[2], _nbytes(out)
        else:
            n, nbytes = _group_size(args[-1]), _nbytes(args[0])
        self.stats.record(op, nbytes, n)


class SavedBytes(torch.autograd.graph.saved_tensors_hooks):
    """Bytes of the storages autograd saves for the backward (this rank's
    shards), each once, those in ``skip`` (the arguments) left out."""

    def __init__(self, skip: set):
        self.seen = set(skip)
        self.bytes = 0

        def pack(t):
            st = _local(t).untyped_storage()
            if st._cdata not in self.seen:
                self.seen.add(st._cdata)
                self.bytes += st.nbytes()
            return t

        super().__init__(pack, lambda t: t)


def _storages(tree) -> set:
    return {_local(t).untyped_storage()._cdata for t in tree_leaves(tree)}


def build(cfg, case, mesh):
    """(fn, args, kinds): the cell's step ``fn(*args)`` on meta DTensors,
    and the argument trees by kind (params, opt_state, cache, inputs)."""
    params = sharding.abstract_sharded_params(cfg, mesh)
    ins = sharding.abstract_inputs(cfg, case, mesh)
    if case.kind == "train":
        for p in tree_leaves(params):
            p.requires_grad_(True)
        opt = make_optimizer(cfg.optimizer)
        state = opt.abstract_state(params, mesh)
        return (make_train_step(cfg, opt), (params, state, ins),
                {"params": params, "opt_state": state, "inputs": ins})
    cache = sharding.cache_shardings(cfg, mesh, case.global_batch,
                                     case.seq_len)
    kinds = {"params": params, "cache": cache, "inputs": ins}
    if case.kind == "prefill":
        def fn(params, tokens, cache, image_embeds=None):
            with torch.no_grad():
                return model_lib.prefill(params, cfg, tokens, cache,
                                         image_embeds)
        extra = (ins["image_embeds"],) if cfg.vision_dim else ()
        return fn, (params, ins["tokens"], cache, *extra), kinds

    def fn(params, tokens, cache, pos):
        with torch.no_grad():
            return model_lib.decode_step(params, cfg, tokens, cache, pos)
    return fn, (params, ins["tokens"], cache, ins["pos"]), kinds


def _remat_inputs_bytes(cfg, case, mesh) -> int:
    """A training step's checkpointed repeats each keep their input x
    (B, S, D) in the compute dtype, sharded as the batch: bytes a rank."""
    if case.kind != "train" or cfg.remat == "none":
        return 0
    b_axes = sharding.batch_axes(mesh, case.global_batch)
    shards = math.prod(sharding.mesh_axes(mesh)[a] for a in b_axes)
    x = (case.global_batch // shards) * case.seq_len * cfg.d_model
    repeats = sum(g.repeat for g in cfg.groups)
    return repeats * x * dtype_named(cfg.dtype).itemsize


def measure_cell(cfg, case, mesh) -> dict:
    """Run the cell's step once; per-device counts (JAX's
    ``compile_cell``)."""
    fn, args, kinds = build(cfg, case, mesh)
    arg_bytes = {k: sum(_nbytes(t) for t in tree_leaves(v))
                 for k, v in kinds.items()}
    counter = Counter()
    saved = SavedBytes(set().union(*(_storages(v)
                                      for v in kinds.values())))
    t0 = time.time()
    with logical_rules(mesh, make_rules(cfg, mesh, case.global_batch)), \
            ops.fake_kernels(), counter, saved:
        out = fn(*args)
    step_s = time.time() - t0
    inputs = set().union(*(_storages(v) for v in kinds.values()))
    out_bytes = sum(_nbytes(t) for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor)
                    and _local(t).untyped_storage()._cdata not in inputs)
    saved_bytes = saved.bytes + _remat_inputs_bytes(cfg, case, mesh)
    args_total = sum(arg_bytes.values())
    stats = counter.stats
    return {
        "step_s": round(step_s, 2),
        "flops": float(counter.flops),
        "bytes": float(counter.bytes),
        "wire_bytes": stats.wire_bytes,
        "collective_counts": dict(stats.counts),
        "collective_bytes_by_op": {k: float(v)
                                   for k, v in stats.bytes_by_op.items()},
        "memory": {
            "argument_bytes_per_dev": args_total,
            "argument_bytes_by_kind": arg_bytes,
            "output_bytes_per_dev": out_bytes,
            "saved_bytes_per_dev": saved_bytes,
            "peak_bytes_per_dev": args_total + out_bytes + saved_bytes,
        },
    }


def slstm_correction(cfg, case, mesh) -> float:
    """Analytic per-device FLOPs of the sLSTM time steps the dry-run does
    not run (all but ``xlstm.META_SCAN_STEPS``), by JAX's formula."""
    n_slstm = sum(sum(1 for s in g.pattern if s.kind == "slstm") * g.repeat
                  for g in cfg.groups)
    if n_slstm == 0 or case.kind == "decode":
        return 0.0
    b_axes = sharding.batch_axes(mesh, case.global_batch)
    sizes = sharding.mesh_axes(mesh)
    shards = 1
    for a in b_axes:
        shards *= sizes[a]
    b_local = case.global_batch / max(shards, 1)
    nh = cfg.num_heads
    hd = cfg.d_model // nh
    per_step = b_local * (4 * nh * hd * hd * 2 + 20 * nh * hd)
    fwd = (case.seq_len - xlstm.META_SCAN_STEPS) * per_step
    return n_slstm * fwd * (3.0 if case.kind == "train" else 1.0)


def run_cell(arch: str, shape: str, mesh_name: str, out_dir: pathlib.Path,
             *, force: bool = False, skip_variants: bool = False,
             optimized: bool = False, device=None, smoke: bool = False,
             mesh=None) -> dict:
    """One cell's record, written to ``out_dir`` (JAX's keys).  ``smoke``
    and ``mesh`` (a mesh to use in place of ``mesh_name``'s production
    one) are for tests on small configs."""
    suffix = "_opt" if optimized else ""
    out_path = out_dir / (f"{configs.canonical(arch)}__{shape}"
                          f"__{mesh_name}{suffix}.json")
    if out_path.exists() and not force:
        rec = json.loads(out_path.read_text())
        print(f"[skip-cached] {out_path.name}: {rec.get('status')}")
        return rec
    if optimized:
        from repro_torch.configs.optimized import optimized_config
        cfg = optimized_config(arch)
    else:
        cfg = configs.get_config(arch, smoke=smoke)
    case = SHAPE_CASES[shape]
    rec = {"arch": configs.canonical(arch), "shape": shape,
           "mesh": mesh_name, "time": time.strftime("%F %T")}
    if shape == "long_500k" and not cfg.subquadratic:
        rec.update(status="skip",
                   reason="full-attention arch; long_500k requires "
                          "sub-quadratic decode")
        out_path.write_text(json.dumps(rec, indent=1))
        print(f"[skip] {out_path.name}")
        return rec
    if mesh is None:
        mesh = make_production_mesh(multi_pod=(mesh_name == "multi"),
                                    device=device)
    n_dev = mesh.size()
    try:
        print(f"[run ] {arch} {shape} {mesh_name} ({n_dev} devices)")
        full = measure_cell(cfg, case, mesh)
        rec["full"] = full
        corr = {k: full[k] for k in ("flops", "bytes", "wire_bytes",
                                     "collective_bytes_by_op",
                                     "collective_counts")}
        corr["flops"] += slstm_correction(cfg, case, mesh)
        rec["corrected"] = corr
        tokens = case.global_batch * (case.seq_len
                                      if case.kind != "decode" else 1)
        mf = rl.model_flops(cfg.active_param_count(), tokens,
                            case.kind) + rl.attn_model_flops(cfg, case)
        roof = rl.Roofline(flops=corr["flops"], bytes_accessed=corr["bytes"],
                           wire_bytes=corr["wire_bytes"],
                           model_flops=mf / n_dev)
        rec["roofline"] = roof.to_dict()
        rec["n_devices"] = n_dev
        rec["status"] = "ok"
    except Exception as e:  # record failures as artifacts too
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-4000:])
        print(f"[FAIL] {arch} {shape} {mesh_name}: {e}")
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def _run_cell_kw(job) -> dict:
    (arch, shape, mesh_name), out_dir, kw = job
    return run_cell(arch, shape, mesh_name, out_dir, **kw)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=SHAPES + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--skip-variants", action="store_true",
                    help="accepted for JAX's CLI; the port runs none")
    ap.add_argument("--optimized", action="store_true",
                    help="use the optimized configs")
    ap.add_argument("--out", default="build/dryrun_torch")
    ap.add_argument("--device", default=None,
                    help="the meshes' device type (default cuda)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each process with its own "
                         "fake process group")
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = configs.all_arch_names() if args.all or not args.arch \
        else [args.arch]
    shapes = SHAPES if args.all or not args.shape else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]
    kw = dict(force=args.force, skip_variants=args.skip_variants,
              optimized=args.optimized, device=args.device)
    t0 = time.time()
    if args.jobs > 1:
        import concurrent.futures
        import multiprocessing
        with concurrent.futures.ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context(
                    "spawn")) as pool:
            recs = list(pool.map(_run_cell_kw, [(c, out_dir, kw)
                                                for c in cells]))
    else:
        recs = [run_cell(*c, out_dir, **kw) for c in cells]
    n_fail = sum(r.get("status") == "error" for r in recs)
    n_ok = len(recs) - n_fail
    print(f"\ndone: {n_ok} ok/skip, {n_fail} failed "
          f"in {time.time() - t0:.1f} s")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
