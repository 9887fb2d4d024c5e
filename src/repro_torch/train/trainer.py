"""Training drivers (counterpart of :mod:`repro.train.trainer`).

:class:`Trainer` — the single-controller loop with prefetched data,
periodic async checkpoints and evals, and exact restart from the latest
checkpoint (the data pipeline included, since batches are a pure function
of step).

:class:`MicrobatchCoordinator` — the paper-integration path: each global
step becomes a task graph (M microbatch-gradient tasks -> 1 reduce+update
task) submitted as an epoch to one persistent
:class:`repro_torch.core.client.Cluster`, so back-to-back steps reuse the
warm executor pool instead of restarting it.  The work-stealing scheduler
rebalances microbatches away from stragglers, and executor failure
mid-step resubmits the lost microbatches.

Both run on the CUDA card unless ``device="cpu"`` is given, and raise
without a card.  Params are leaf tensors that require grad; the optimizer
updates them in place (:mod:`.optimizer`).  Bit-equal restarts on the card
need deterministic kernels: the caller sets
``torch.use_deterministic_algorithms(True)`` (and ``CUBLAS_WORKSPACE_CONFIG``
before cuBLAS starts); the port's own kernels use no atomics.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ckpt_lib
from repro_torch.core.client import Cluster
from repro_torch.core.graph import Task, TaskGraph
from repro_torch.core.tracing import Spans
from repro_torch.data.pipeline import PrefetchPipeline, SyntheticDataset
from repro_torch.device import resolve
from repro_torch.models import model as model_lib
from repro_torch.models.common import tree_map
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import Optimizer, make_optimizer
from repro_torch.train.train_step import (make_eval_step, make_grad_fn,
                                         make_train_step)


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    ckpt_every: int = 50
    eval_every: int = 50
    ckpt_dir: str = ""
    keep_ckpts: int = 3
    log_every: int = 10
    seed: int = 0


class Trainer:
    """The single-controller loop.  Each step runs under a ``train.step``
    span of the recorder ``self.spans`` (``"train"``, on unless
    ``spans=False``), with the children ``train.data`` (the next batch to
    the device), ``train.grad`` and ``train.optimizer`` (also timed on
    the device) and ``train.sync`` (the loss and gradient norm read
    back), each carrying the step's number."""

    def __init__(self, cfg: ModelConfig, tc: TrainerConfig,
                 optimizer: Optimizer | None = None,
                 device: torch.device | str | None = None,
                 spans: bool = True):
        self.cfg = cfg
        self.tc = tc
        self.device = resolve(device)
        self.opt = optimizer or make_optimizer(cfg.optimizer)
        gen = torch.Generator(device=self.device).manual_seed(tc.seed)
        self.params = tree_map(lambda p: p.requires_grad_(True),
                               model_lib.init_params(gen, cfg, self.device))
        self.opt_state = self.opt.init(self.params)
        self.step = 0
        self.dataset = SyntheticDataset(cfg, tc.global_batch, tc.seq_len,
                                        tc.seed)
        self.spans = Spans("train", enabled=spans)
        self._train_step = make_train_step(cfg, self.opt, spans=self.spans)
        self._eval_step = make_eval_step(cfg)
        self.ckptr = (ckpt_lib.AsyncCheckpointer(tc.ckpt_dir, tc.keep_ckpts)
                      if tc.ckpt_dir else None)
        self.history: list[dict] = []

    def _batch(self, batch: dict) -> dict:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

    # ------------------------------------------------------------------
    def maybe_restore(self) -> bool:
        if not self.tc.ckpt_dir:
            return False
        step = ckpt_lib.latest_step(self.tc.ckpt_dir)
        if step is None:
            return False
        tree = {"params": self.params, "opt": self.opt_state}
        restored, step, _ = ckpt_lib.restore(self.tc.ckpt_dir, tree, step)
        with torch.no_grad():  # keep the autograd leaves, load their values
            tree_map(lambda p, r: p.copy_(r), tree, restored)
        self.step = step
        return True

    def train(self, steps: int | None = None) -> list[dict]:
        steps = steps or self.tc.steps
        pipe = PrefetchPipeline(self.dataset, depth=2, n_loaders=2,
                                start_step=self.step)
        try:
            while self.step < steps:
                with self.spans.span("train.step", step=self.step + 1):
                    with self.spans.span("train.data"):
                        step_id, batch = pipe.get()
                        batch = self._batch(batch)
                    t0 = time.perf_counter()
                    self.params, self.opt_state, metrics = self._train_step(
                        self.params, self.opt_state, batch)
                    with self.spans.span("train.sync"):
                        loss = float(metrics["loss"])
                        grad_norm = float(metrics["grad_norm"])
                    t1 = time.perf_counter()
                self.step = step_id + 1
                rec = {"step": self.step, "loss": loss,
                       "grad_norm": grad_norm, "time_s": t1 - t0}
                self.history.append(rec)
                if self.ckptr and self.step % self.tc.ckpt_every == 0:
                    self.ckptr.save(self.step,
                                    {"params": self.params,
                                     "opt": self.opt_state},
                                    meta={"config": self.cfg.name})
                if self.step % self.tc.eval_every == 0:
                    eb = self._batch(self.dataset.batch_at(
                        10_000_000 + self.step))
                    rec["eval_loss"] = float(
                        self._eval_step(self.params, eb)["loss"])
                if self.step % self.tc.log_every == 0:
                    print(f"step {self.step:5d} loss {loss:.4f} "
                          f"({rec['time_s']*1e3:.0f} ms)")
        finally:
            pipe.stop()
            if self.ckptr:
                self.ckptr.wait()
        return self.history


# ---------------------------------------------------------------------------
# Microbatch dispatch through the paper's runtime
# ---------------------------------------------------------------------------

class MicrobatchCoordinator:
    """One training step = one graph epoch on a persistent Cluster.

    Executors are runtime workers (stand-ins for pods); each microbatch
    gradient is a task; the final task averages gradients and applies the
    optimizer.  The Cluster outlives the step loop, so the 2nd..Nth step
    submit onto warm executors (no pool restart between steps — the whole
    point of the paper's long-lived server).  ``slow_workers`` makes
    chosen executors straggle so the work-stealing scheduler's
    rebalancing is observable.

    Because the pool is shared across steps, an executor killed via
    ``fail_worker`` stays dead for the coordinator's lifetime (later
    steps run on the surviving executors).  Its thread still runs the
    task it had started to the end, beside the task's re-run elsewhere,
    so the update writes fresh param tensors, as the JAX package's
    functional update does: a microbatch still running reads the params
    it started with, and its autograd graph stays valid.

    The executors share the card's default stream, so their kernels
    serialize on it; the microbatch gradients and the reduce (a sum in
    list order) do not depend on which executor ran which microbatch.

    ``events=`` and ``tracing=`` go to the pool's Cluster, whose
    ``trace_analysis()`` then splits each task into the overhead
    segments.
    """

    #: default byte bound on the coordinator's pool.  Microbatch tasks
    #: return small ints (gradients ride the closure), so the bound is
    #: slack in practice.
    DEFAULT_MEMORY_LIMIT = 256 * 2**20

    def __init__(self, cfg: ModelConfig, *, n_executors: int = 4,
                 n_microbatches: int = 8, scheduler: str = "rsds_ws",
                 slow_workers: dict[int, float] | None = None,
                 seed: int = 0,
                 memory_limit: int | None = DEFAULT_MEMORY_LIMIT,
                 events=None, tracing: bool = False,
                 device: torch.device | str | None = None):
        self.cfg = cfg
        self.device = resolve(device)
        self.n_executors = n_executors
        self.n_micro = n_microbatches
        self.scheduler_name = scheduler
        self.slow = slow_workers or {}
        self.memory_limit = memory_limit
        self._events = events
        self._tracing = tracing
        self.opt = make_optimizer(cfg.optimizer)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = tree_map(lambda p: p.requires_grad_(True),
                               model_lib.init_params(gen, cfg, self.device))
        self.opt_state = self.opt.init(self.params)
        self._grad = make_grad_fn(cfg)
        self.step = 0
        self.steal_count = 0
        self._cluster: Cluster | None = None

    # ------------------------------------------------------------------
    def _ensure_cluster(self) -> Cluster:
        if self._cluster is not None:
            return self._cluster
        server = "dask" if self.scheduler_name.startswith("dask") else \
            "rsds"
        sched = {"rsds_ws": "ws", "dask_ws": "ws", "ws": "ws",
                 "random": "random", "heft": "heft"}[self.scheduler_name]
        c = Cluster(server=server, scheduler=sched,
                    n_workers=self.n_executors, runtime="thread",
                    name="microbatch", balance_interval=0.002,
                    timeout=120.0, autostart=False,
                    memory_limit=self.memory_limit,
                    events=self._events, tracing=self._tracing)
        rt = c.runtime
        if self.slow:
            orig = rt._worker_loop

            def slow_loop(wid):
                if wid not in self.slow:
                    return orig(wid)
                inbox = rt.worker_inbox[wid]
                while True:
                    item = inbox.get()
                    if item is None:
                        return
                    if wid in rt.dead:
                        continue
                    with rt._lock:
                        if item in rt.queued.get(wid, []):
                            rt.queued[wid].remove(item)
                        else:
                            # retracted (stolen) while waiting in the
                            # inbox: skip without paying the straggler
                            # delay, or ghosts of a previous epoch's
                            # stolen tasks would stall the next one
                            continue
                    time.sleep(self.slow[wid])
                    t = rt.g.task(item)
                    if t.fn is not None:
                        args = [rt.results.get(d) for d in t.inputs]
                        rt.results[item] = t.fn(*args) if t.args == () \
                            else t.fn(*t.args)
                    rt.server_inbox.put(("finished", item, wid))

            rt._worker_loop = slow_loop
        c.start()
        self._cluster = c
        return c

    def close(self) -> None:
        if self._cluster is not None:
            self._cluster.close()
            self._cluster = None

    def _make_step_graph(self, batch: dict) -> TaskGraph:
        mb = {k: np.array_split(v, self.n_micro) for k, v in batch.items()}
        tasks = []
        losses = [0.0] * self.n_micro
        # The pool's graph keeps these closures until compaction, thousands
        # of tasks on: the reduce takes the gradients out, and a failed
        # executor's run that ends after the reduce stores none.
        step = {"grads": [None] * self.n_micro}

        def run_micro(i):
            def fn():
                # straggler injection happens per-executor in the runtime
                (loss, _), g = self._grad(
                    self.params, {k: torch.from_numpy(v[i]).to(self.device)
                                  for k, v in mb.items()})
                losses[i] = float(loss)
                grads = step["grads"]
                if grads is not None:
                    grads[i] = g
                return i
            return fn

        for i in range(self.n_micro):
            tasks.append(Task(i, (), duration=1e-3, output_size=1024,
                              fn=run_micro(i), name=f"micro-{i}"))

        def reduce_fn(*_):
            grads, step["grads"] = step["grads"], None
            gsum = grads[0]
            for g in grads[1:]:
                gsum = tree_map(torch.add, gsum, g)
            gmean = tree_map(lambda x: x / self.n_micro, gsum)
            params = tree_map(
                lambda p: p.detach().clone().requires_grad_(True),
                self.params)
            self.params, self.opt_state, om = self.opt.apply(
                params, gmean, self.opt_state)
            return float(np.mean(losses))

        tasks.append(Task(self.n_micro, tuple(range(self.n_micro)),
                          duration=1e-3, output_size=8, fn=reduce_fn,
                          name="reduce"))
        return TaskGraph(tasks, name=f"train-step-{self.step}")

    def train_step(self, batch: dict, *, fail_worker: int | None = None
                   ) -> dict:
        """One step on ``batch`` (numpy arrays, split into the
        microbatches along axis 0); ``fail_worker`` kills that executor
        10 ms after the step's submission."""
        cluster = self._ensure_cluster()
        graph = self._make_step_graph(batch)
        if fail_worker is not None:
            def _killer():
                time.sleep(0.01)
                cluster.runtime.fail_worker(fail_worker)
            threading.Thread(target=_killer, daemon=True).start()
        futs = cluster.client.submit_graph(graph)
        ok = futs.wait(120.0)
        epoch = futs.epoch
        loss = futs.raw_results().get(self.n_micro) if ok else None
        futs.release()   # per-step values are consumed; free the keys
        self.step += 1
        ev = cluster.events
        if ev is not None:
            ev.publish("train-step", step=self.step,
                       makespan=epoch.makespan)
        return {"step": self.step, "loss": loss,
                "makespan": epoch.makespan, "timed_out": not ok,
                "server_busy": epoch.server_busy}
