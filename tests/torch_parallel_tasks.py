"""The rank function of ``tests/test_torch_parallel.py``: one sharded
train step a config, on a (2, 4) ``("data", "model")`` mesh of 8 gloo
ranks.  A spawned worker unpickles the function by reference, so it lives
in this module, which imports no test module and no JAX."""
import pickle


def sharded_steps(rank, world, store_path, in_path, out_path):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        from repro_torch import bridge, configs
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models.common import (ShapeCase, tree_leaves,
                                               tree_map)
        from repro_torch.parallel import sharding
        from repro_torch.parallel.annotate import logical_rules, make_rules
        from repro_torch.train.optimizer import make_optimizer
        from repro_torch.train.train_step import (make_grad_fn,
                                                  make_train_step)
        with open(in_path, "rb") as f:
            jobs = pickle.load(f)
        mesh = make_host_mesh((2, 4), device="cpu")
        out = {}
        for name, job in jobs.items():
            cfg = configs.get_config(job["arch"], smoke=True)
            params = sharding.shard_params(
                tree_map(lambda t: t.requires_grad_(True),
                         bridge.params_from_numpy(job["params"], "cpu")),
                cfg, mesh)
            b = job["batch"]["tokens"].shape[0]
            specs = sharding.input_specs(
                cfg, ShapeCase("t", job["batch"]["tokens"].shape[1],
                                        b, "train"), mesh)
            batch = {k: sharding.distribute(torch.from_numpy(v),
                                            specs[k].spec, mesh)
                     for k, v in job["batch"].items()}
            opt = make_optimizer("adamw", **job["opt"])
            with logical_rules(mesh, make_rules(cfg, mesh, b)):
                _, grads = make_grad_fn(cfg)(params, batch)
                grads = bridge.params_to_numpy(tree_map(
                    lambda t: t.full_tensor().detach(), grads))
                step = make_train_step(cfg, opt)
                params, state, m = step(params, opt.init(params), batch)
            full = tree_map(lambda t: t.full_tensor().detach(), params)
            res = {"params": bridge.params_to_numpy(full), "grads": grads,
                   "loss": float(m["loss"].full_tensor()),
                   "grad_norm": float(m["grad_norm"]),
                   "placements": sorted({str(t.placements) for t in
                                         tree_leaves(params)})}
            res["serve"] = _serve(cfg, job, mesh, rank)
            if rank == 0:
                out[name] = res
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _serve(cfg, job, mesh, rank):
    """Prefill a 4 x 12 prompt into a 16-position cache and take 4 greedy
    decode steps, sharded (params, cache, tokens) and plain on the same
    params: the largest logit difference and whether the tokens agree."""
    import torch
    from repro_torch import bridge
    from repro_torch.models import model
    from repro_torch.parallel import sharding
    from repro_torch.parallel.annotate import logical_rules, make_rules
    b, s, n = 4, 12, 4
    params = bridge.params_from_numpy(job["params"], "cpu")
    toks = torch.from_numpy(job["batch"]["tokens"][:, :s]).long()

    def run(p, cache, place):
        logits, cache = model.prefill(p, cfg, place(toks), cache)
        outs, seq = [logits], []
        for i in range(n):
            full = logits.full_tensor() if hasattr(logits, "full_tensor") \
                else logits
            nxt = full.argmax(-1)
            seq.append(nxt)
            pos = torch.full((b,), s + i, dtype=torch.int64)
            logits, cache = model.decode_step(p, cfg, place(nxt), cache,
                                              place(pos))
            outs.append(logits)
        return [o.full_tensor() if hasattr(o, "full_tensor") else o
                for o in outs], seq

    with torch.no_grad():
        want, want_seq = run(params, model.init_cache(cfg, b, s + n,
                                                      device="cpu"),
                             lambda t: t)
        axes = sharding.batch_axes(mesh, b) or None
        with logical_rules(mesh, make_rules(cfg, mesh, b)):
            got, got_seq = run(
                sharding.shard_params(params, cfg, mesh),
                sharding.shard_cache(model.init_cache(cfg, b, s + n,
                                                      device="cpu"),
                                     cfg, mesh, b),
                lambda t: sharding.distribute(
                    t, (axes,) + (None,) * (t.dim() - 1), mesh))
    return {"logits_max_abs": max(float((g - w).abs().max())
                                  for g, w in zip(got, want)),
            "tokens_equal": all(bool((g == w).all())
                                for g, w in zip(got_seq, want_seq))}
