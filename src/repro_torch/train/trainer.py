"""Training loop (counterpart of :class:`repro.train.trainer.Trainer`):
the single-controller loop with prefetched data, periodic async
checkpoints and evals, and exact restart from the latest checkpoint (the
data pipeline included, since batches are a pure function of step).

It runs on the CUDA card unless ``device="cpu"`` is given, and raises
without a card.  Params are leaf tensors that require grad; the optimizer
updates them in place (:mod:`.optimizer`).  Bit-equal restarts on the card
need deterministic kernels: the caller sets
``torch.use_deterministic_algorithms(True)`` (and ``CUBLAS_WORKSPACE_CONFIG``
before cuBLAS starts); the port's own kernels use no atomics.

Not ported yet: ``MicrobatchCoordinator``, which needs the task runtime
(``repro.core``) copied into the port.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.ckpt import checkpoint as ckpt_lib
from repro_torch.data.pipeline import PrefetchPipeline, SyntheticDataset
from repro_torch.device import resolve
from repro_torch.models import model as model_lib
from repro_torch.models.common import tree_map
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import Optimizer, make_optimizer
from repro_torch.train.train_step import make_eval_step, make_train_step


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
    def __init__(self, cfg: ModelConfig, tc: TrainerConfig,
                 optimizer: Optimizer | None = None,
                 device: torch.device | str | None = None):
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
        self._train_step = make_train_step(cfg, self.opt)
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
                step_id, batch = pipe.get()
                batch = self._batch(batch)
                t0 = time.perf_counter()
                self.params, self.opt_state, metrics = self._train_step(
                    self.params, self.opt_state, batch)
                loss = float(metrics["loss"])
                self.step = step_id + 1
                rec = {"step": self.step, "loss": loss,
                       "grad_norm": float(metrics["grad_norm"]),
                       "time_s": time.perf_counter() - t0}
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
