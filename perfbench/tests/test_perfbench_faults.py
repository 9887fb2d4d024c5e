"""Whole runs on the CPU at smoke sizes (the look for a card skipped):
sound runs come out correct, and each fault a cell can have makes
``correct`` false."""
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(Path(__file__).parent)]

import perfbench_tiny  # noqa: E402
from perfbench import harness  # noqa: E402

SERVE, TRAIN = "dscoder-code-complete", "dscoder-train-4x2048"


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return perfbench_tiny.make(tmp_path_factory.mktemp("bench"))


def run(root, cell, seed=2**31 + 77, seconds=1.5):
    args = harness.parse(["--workload", cell, "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", "0"])
    line, _ = harness.execute(args, time.perf_counter(), device_name="cpu",
                              root=root)
    return line


def test_sound_serving_run_is_correct(tiny):
    line = run(tiny, SERVE)
    assert line["correct"] is True and line["attempted"] > 0
    assert line["failed"] == 0
    assert set(line["metrics"]) == {"serve_tokens_per_s", "request_p95_ms",
                                    "setup_s"}


def test_altered_token_is_caught(tiny, monkeypatch):
    """A token altered where it is produced: each decode step's logits make
    the reference's worst token the engine's greedy choice."""
    from repro_torch.serve import engine
    real = engine.model_lib.decode_step

    def altered(*a, **kw):
        logits, cache = real(*a, **kw)
        return -logits, cache

    monkeypatch.setattr(engine.model_lib, "decode_step", altered)
    line = run(tiny, SERVE)
    assert line["correct"] is False
    gap = line["checks"]["max_logit_gap"]
    assert gap["value"] > gap["limit"]


def test_sound_training_run_is_correct(tiny):
    line = run(tiny, TRAIN)
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"train_tokens_per_s", "train_peak_gib",
                                    "setup_s"}


def test_step_that_returns_its_state_unchanged_is_caught(tiny, monkeypatch):
    from repro_torch.train import optimizer
    monkeypatch.setattr(optimizer.AdamW, "apply",
                        lambda self, p, g, s: (p, s, {
                            "grad_norm": torch.zeros(()),
                            "lr": torch.zeros(())}))
    line = run(tiny, TRAIN)
    assert line["correct"] is False
    assert line["checks"]["change_norm_gap"]["value"] == pytest.approx(1.0)


def test_half_batch_is_caught(tiny, monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from repro_torch.train import trainer
    real = trainer.make_train_step

    def half(cfg, opt, **kw):
        step = real(cfg, opt, **kw)
        return lambda p, s, b: step(p, s, {k: v[:len(v) // 2]
                                           for k, v in b.items()})

    monkeypatch.setattr(trainer, "make_train_step", half)
    line = run(tiny, TRAIN)
    assert line["correct"] is False


def test_decode_step_that_leaves_the_cache_unchanged_is_caught(tiny,
                                                               monkeypatch):
    """A decode step that returns its state unchanged: the new token's
    keys and values never reach the cache."""
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "_scatter_time",
                        lambda buf, val, pos: None)
    line = run(tiny, SERVE)
    assert line["correct"] is False
