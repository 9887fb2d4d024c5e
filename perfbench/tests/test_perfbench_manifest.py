"""BENCHMARK.json against the benchmark's rules, and the shape of the
result line."""
import collections
import json
import math
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
# keys of widths, which ``reduced`` may never name
WIDTH = re.compile(r"(_size$|_dim$|_rank$|headdim|d_state|expand|"
                   r"experts_per_tok|top_k|d_model|d_ff)")


@pytest.fixture(scope="module")
def bench():
    return harness.manifest(ROOT)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(bench)) < 64 * 1024
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    # the command names no file outside the paths
    for w in bench["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_run_seconds_fit_24_cells(bench):
    rs = bench["run_seconds"]
    cells = 24
    total = (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_configs(bench):
    names = [c["name"] for c in bench["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    files = set()
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and c["source"].startswith("https://")
        assert _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        doc = json.loads((ROOT / c["file"]).read_text())
        assert doc["name"] == c["name"] and doc["source"] == c["source"]
        assert doc["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in doc
            assert not WIDTH.search(key), key


def test_config_model_blocks_match_their_published_keys(bench):
    for c in bench["configs"]:
        doc = json.loads((ROOT / c["file"]).read_text())
        m = doc["model"]
        layers = sum(g["repeat"] * len(g["pattern"]) for g in m["groups"])
        assert layers == doc["num_hidden_layers"]
        assert m["d_model"] == doc["hidden_size"]
        assert m["d_ff"] == doc["intermediate_size"]
        assert m["num_heads"] == doc["num_attention_heads"]
        assert m["num_kv_heads"] == doc["num_key_value_heads"]
        assert m["vocab_size"] == doc["vocab_size"]
        assert m["tie_embeddings"] == doc["tie_word_embeddings"]
        assert m["dtype"] == doc["torch_dtype"]
        for key, value in doc.get("published", {}).items():
            assert key in doc["reduced"] and doc[key] != value


def test_workloads(bench):
    names = [w["name"] for w in bench["workloads"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(names)
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(names) // 4)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        files = harness.cell_files(bench, w["name"], ROOT / "perfbench")
        assert harness.runner_module(files["traffic"]["kind"])


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert e2e["setup_s"]["bound"] <= 0.25
    all_names = list(e2e) + [m["name"] for m in bench["per_layer"]]
    assert len(set(all_names)) == len(all_names)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert 1 <= len(bench["per_layer"]) <= 128
    layers: dict = {}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in e2e
        reports = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m.get("workloads", reports)) <= reports
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").exists()
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        ends = [m["name"] for m in harness.metrics_of(bench, cell, False)]
        assert "setup_s" in ends and len(ends) >= 2
        assert harness.metrics_of(bench, cell, True)


def test_every_cell_has_its_limits(bench):
    for w in bench["workloads"]:
        limits = harness.cell_files(bench, w["name"],
                                    ROOT / "perfbench")["limits"]
        assert limits and all(isinstance(v, (int, float)) and v > 0
                              for k, v in limits.items()
                              if not k.startswith("_"))


def test_result_line_schema(bench):
    cell = "dscoder-code-complete"
    out = {"metrics": {"serve_tokens_per_s": 280.5, "request_p95_ms": 1.5e4,
                       "setup_s": 30.0},
           "attempted": 200, "failed": 0,
           "checks": {"max_logit_gap": {"value": 0.1, "limit": 0.5,
                                        "holds": True}},
           "obs": {}}
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
           "memory_peak_bytes": 5e10}
    line = harness.result_line(bench, cell, out, False, dev)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"serve_tokens_per_s", "request_p95_ms",
                                    "setup_s"}
    assert line["metrics"]["setup_s"] == {"value": 30.0, "unit": "s"}
    out["checks"]["max_logit_gap"]["holds"] = False
    assert harness.result_line(bench, cell, out, False, dev)["correct"] is \
        False
    json.dumps(line)


def test_traced_line_carries_busy_window_and_breakdown(bench):
    cell = "dscoder-train-4x2048"
    trace = {"busy_s": 1.9, "window_s": 2.0, "kernels": {
        "void flash_fwd_kernel_sm90<128, 2>(...)": [0.05, 16],
        "void flash_bwd_dq_kernel_sm90<...>(...)": [0.06, 8]},
        "breakdown": {"device_ops": [["gemm", 1.0]],
                      "idle_gaps": [["aten::copy_", 0.01]]}}
    obs = {"window_s": 40.0, "steps": 46, "step_ms": [860.0, 870.0, 850.0],
           "n_params": 2_584_000_000, "step_flops": 1e14, "trace": trace,
           "profile_steps": 2,
           "sub_flash": collections.Counter({(4, 2048, 2048, 56, 8, 128,
                                              True, 0): 16}),
           "sub_flash_bwd": collections.Counter({(4, 2048, 2048, 56, 8, 128,
                                                  True, 0): 8})}
    out = {"metrics": {}, "attempted": 46, "failed": 0, "obs": obs,
           "checks": {"loss_gap": {"value": 1e-4, "limit": 1e-2,
                                   "holds": True}}}
    dev = {"platform": "gpu", "kind": "x", "count": 1,
           "memory_peak_bytes": 1}
    line = harness.result_line(bench, cell, out, True, dev)
    assert set(line["metrics"]) == {m["name"] for m in harness.metrics_of(
        bench, cell, True)}
    assert line["device"]["busy_s"] == 1.9
    assert line["device"]["window_s"] == 2.0
    assert line["breakdown"] == trace["breakdown"]
    assert list(line)[-1] == "checks"
    for m in line["metrics"].values():
        assert math.isfinite(m["value"])
