"""The quantile-drawn traffic, and a traffic mix added as a new file."""
import collections
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness, traffic  # noqa: E402

SEEDS = [0, 1, 2**31 + 12345, 2**40 + 7, 9_876_543_210]


def _mix():
    return harness.load_json(ROOT / "perfbench" / "traffic" /
                             "code_complete.json")


def _lognormal_mix():
    """The cell's mix with lengths drawn from lognormal laws."""
    return dict(_mix(),
                prompt_tokens={"dist": "lognormal", "median": 1536,
                               "sigma": 0.6, "min": 256, "max": 4096},
                new_tokens={"dist": "lognormal", "median": 48, "sigma": 0.5,
                            "min": 16, "max": 128})


def test_the_code_mix_has_the_sources_medians():
    t = _mix()
    s = traffic.RequestStream(t, 2**31 + 9, 32256)
    reqs = [s.next() for _ in range(t["pool"] + 3)]
    assert {len(p) for p, _ in reqs} == {t["prompt_tokens"]["tokens"]}
    assert {n for _, n in reqs} == {t["new_tokens"]["tokens"]}
    # the seed draws the ids
    assert not np.array_equal(reqs[0][0], reqs[1][0])


def test_lengths_are_the_same_multiset_for_every_seed():
    t = _lognormal_mix()
    seen = []
    for seed in SEEDS:
        s = traffic.RequestStream(t, seed, 32256)
        reqs = [s.next() for _ in range(t["pool"])]
        seen.append((collections.Counter(len(p) for p, _ in reqs),
                     collections.Counter(n for _, n in reqs),
                     [len(p) for p, _ in reqs]))
    for lens, news, _ in seen[1:]:
        assert lens == seen[0][0] and news == seen[0][1]
    # the seed orders them
    assert len({tuple(order) for *_, order in seen}) == len(SEEDS)


def test_lengths_follow_the_law():
    t = _lognormal_mix()
    p = traffic.quantile_lengths(t["prompt_tokens"], t["pool"])
    n = traffic.quantile_lengths(t["new_tokens"], t["pool"])
    assert p.min() >= 256 and p.max() <= 4096
    assert n.min() >= 16 and n.max() <= 128
    assert np.median(p) == pytest.approx(1536, rel=0.01)
    assert np.median(n) == pytest.approx(48, rel=0.03)


def test_same_seed_same_requests_and_second_round():
    t = dict(_lognormal_mix(), pool=8)
    a = traffic.RequestStream(t, 2**31 + 5, 100)
    b = traffic.RequestStream(t, 2**31 + 5, 100)
    ra = [a.next() for _ in range(20)]
    rb = [b.next() for _ in range(20)]
    for (pa, na), (pb, nb) in zip(ra, rb):
        assert na == nb and np.array_equal(pa, pb)
        assert pa.dtype == np.int32 and pa.max() < 100
    # the second round draws the pool again: same multiset
    first = sorted(len(p) for p, _ in ra[:8])
    assert sorted(len(p) for p, _ in ra[8:16]) == first


def test_train_batches_differ_by_step_and_repeat_by_seed():
    t = harness.load_json(ROOT / "perfbench" / "traffic" /
                          "train_4x2048.json")
    t = dict(t, batch=2, seq_len=16)
    a = traffic.train_batch(t, 2**35, 50, 0)
    assert np.array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert np.array_equal(a["tokens"],
                          traffic.train_batch(t, 2**35, 50, 0)["tokens"])
    b = traffic.train_batch(t, 2**35, 50, 1)
    assert not np.array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"][0], a["tokens"][1])


def test_a_traffic_mix_is_added_as_files(tmp_path):
    """A new cell needs a traffic file, a limits file and a BENCHMARK.json
    entry: no file that is there is edited."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*")
              if p.is_file()}
    bench = harness.manifest(ROOT)
    mix = dict(_mix(), why="short chat", clients=8,
               prompt_tokens={"dist": "lognormal", "median": 256,
                              "sigma": 0.5, "min": 64, "max": 512})
    (tmp_path / "perfbench" / "traffic" / "short_chat.json").write_text(
        json.dumps(mix))
    (tmp_path / "perfbench" / "limits" / "dscoder-short-chat.json"
     ).write_text(json.dumps({"max_logit_gap": 1.0}))
    bench["workloads"].append({"name": "dscoder-short-chat",
                               "config": "deepseek-coder-33b-31L",
                               "traffic": "short_chat", "chips": 1,
                               "why": "short chat"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    files = harness.cell_files(harness.manifest(tmp_path),
                               "dscoder-short-chat", tmp_path / "perfbench")
    assert files["traffic"]["clients"] == 8
    assert harness.runner_module(files["traffic"]["kind"])
    assert files["config"]["name"] == "deepseek-coder-33b-31L"
    assert [w["name"] for w in harness.manifest(tmp_path)["workloads"]][-1] \
        == "dscoder-short-chat"
    for p, data in before.items():
        assert p.read_bytes() == data
