"""The control of the correctness check at smoke size on the CPU: the
reference put in the program's place and computed in fp8 (the precision
below the configurations' bf16) must come out not correct under each
cell's limits.  ``perfbench/control.py`` reads the same at the cells' own
size on the card."""
import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(Path(__file__).parent)]

import perfbench_tiny  # noqa: E402
from perfbench import harness, modelcfg, serve_cell, train_cell  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = perfbench_tiny.make(tmp_path_factory.mktemp("control"))
    # enough served tokens for a widest gap (~150, as the cell's ~300)
    path = root / "perfbench" / "traffic" / "code_complete.json"
    mix = json.loads(path.read_text())
    mix.update(new_tokens={"dist": "lognormal", "median": 24, "sigma": 0.3,
                           "min": 16, "max": 32}, check={"requests": 6})
    path.write_text(json.dumps(mix))
    return root


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fp8_control_fails_the_serving_check(tiny, seed):
    f = harness.cell_files(harness.manifest(tiny), "dscoder-code-complete",
                           tiny / "perfbench")
    out = serve_cell.run(f["cell"], f["config"], f["traffic"], f["limits"],
                         seed, 2.0, False, CPU, time.perf_counter(),
                         control=True)
    limit = f["limits"]["max_logit_gap"]
    assert out["judged"]["max_logit_gap"] <= limit
    assert out["judged"]["control_gap"] > limit
    assert out["judged"]["fault_gap"] > limit


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fp8_control_fails_the_training_check(tiny, seed):
    f = harness.cell_files(harness.manifest(tiny), "dscoder-train-4x2048",
                           tiny / "perfbench")
    conf, t = f["config"], f["traffic"]
    cfg, m = modelcfg.build(conf), conf["model"]
    ref = train_cell.reference_readings(cfg, m, t, seed, 3, CPU, "fp32")
    ctrl = train_cell.reference_readings(cfg, m, t, seed, 3, CPU, "fp8")
    checks, _ = train_cell.compare(ctrl, ref, f["limits"])
    assert not all(c["holds"] for c in checks.values()), checks
    same, _ = train_cell.compare(ref, ref, f["limits"])
    assert all(c["holds"] for c in same.values())
