"""The readers of the program's spans: each new per-layer metric on a
hand-built recorder, and the window each selects from the recorder of a
whole CPU run at smoke sizes."""
import importlib.util
import statistics
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(Path(__file__).parent)]

import perfbench_tiny  # noqa: E402
from perfbench import harness  # noqa: E402
from repro_torch.core import tracing  # noqa: E402

SERVE, TRAIN = "dscoder-code-complete", "dscoder-train-4x2048"
MS = 1_000_000          # ns


def module(name, root=ROOT):
    """The reader module ``perfbench/metrics/<name>.py``."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "spans_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(name, obs):
    return harness.reader(name)(obs)


def rec(sid, parent, name, t0_ms, t1_ms, **kw):
    return tracing.SpanRecord(sid, parent, name, "t", int(t0_ms * MS),
                              int(t1_ms * MS), **kw)


@pytest.fixture
def serve_spans():
    """A ``"serve"`` recorder open from 0 ms and closed at 1000 ms
    holding one span before a 100 ms window (900..1000 ms) and, in it: a
    step with an admission (a prefill call), a decode call and a
    read-back, and a second step that ends past the close."""
    sp = tracing.Spans("serve")
    sp.t_open_ns = 0
    sp.records.extend([
        rec(1, None, "serve.call", 850, 860, attrs={"kind": "decode"}),
        rec(2, None, "serve.step", 900, 960, attrs={"live": 2}),
        rec(3, 2, "serve.admit", 901, 921, rid=7, attrs={"wait_s": 0.004}),
        rec(4, 3, "serve.call", 902, 915, rid=7, attrs={"kind": "prefill"}),
        rec(5, 4, "serve.task", 903, 913, attrs={"kind": "prefill"}),
        rec(6, 5, "serve.h2d", 903, 905),
        rec(7, 5, "serve.model", 905, 913),
        rec(9, 2, "serve.call", 922, 950, attrs={"kind": "decode"}),
        rec(10, 9, "serve.task", 923, 949, attrs={"kind": "decode"}),
        rec(11, 10, "serve.h2d", 923, 924),
        rec(12, 10, "serve.model", 924, 930),
        rec(13, 2, "serve.readback", 950, 955),
        rec(14, None, "serve.admit", 961, 962, rid=8,
            attrs={"wait_s": 0.010}),
        rec(15, None, "serve.step", 970, 1010, attrs={"live": 2}),
    ])
    sp.t_closed_ns = 1000 * MS
    yield sp
    tracing._RECORDERS.pop("serve", None)


OBS = {"window_s": 0.1}


def test_call_overhead(serve_spans):
    # (13 - 10) and (28 - 26) ms; the call before the window is left out
    assert read("call_overhead_us.serve", OBS) == pytest.approx(2500.0)


def test_engine_self_share(serve_spans):
    # the step's 60 ms less its admission, decode call and read-back
    # (20 + 28 + 5); the step past the close is left out
    assert read("engine_self_share.serve", OBS) == pytest.approx(7.0)


def test_device_wait_share(serve_spans):
    # h2d 2 + 1 ms and the read-back 5 ms of 100
    assert read("device_wait_share.serve", OBS) == pytest.approx(8.0)


def test_decode_enqueue(serve_spans):
    # the decode task's model span only, not the prefill's
    assert read("decode_enqueue_ms.serve", OBS) == pytest.approx(6.0)


def test_admit_wait_p95(serve_spans):
    want = statistics.quantiles([4.0, 10.0], n=20, method="inclusive")[18]
    assert read("admit_wait_p95_ms.serve", OBS) == pytest.approx(want)


def test_serve_readers_find_nothing_without_a_closed_recorder():
    tracing._RECORDERS.pop("serve", None)
    names = ["call_overhead_us.serve", "engine_self_share.serve",
             "device_wait_share.serve", "decode_enqueue_ms.serve",
             "admit_wait_p95_ms.serve"]
    assert [read(n, OBS) for n in names] == [None] * 5
    sp = tracing.Spans("serve")         # open: no window yet
    sp.records.append(rec(1, None, "serve.step", 0, 1))
    assert [read(n, OBS) for n in names] == [None] * 5
    tracing._RECORDERS.pop("serve", None)


def test_serve_readers_pass_over_a_recorder_younger_than_the_window(
        serve_spans):
    """A recorder built inside the window is another run's (a later
    engine's), and none of its spans is read."""
    serve_spans.t_open_ns = 950 * MS
    assert serve_spans.window(OBS["window_s"]) is None
    assert read("call_overhead_us.serve", OBS) is None
    serve_spans.t_open_ns = 900 * MS
    assert read("call_overhead_us.serve", OBS) == pytest.approx(2500.0)


def test_optimizer_ms_reads_the_window_steps_device_time():
    """Steps 1-2 before the window, 3-5 the window, 6-7 profiled: the
    median of the window's optimizer device times; a step whose events
    have not completed is left out."""
    sp = tracing.Spans("train")
    dev = {1: 0.5, 2: 0.5, 3: 0.150, 4: 0.160, 5: 0.170, 6: 0.9, 7: 0.9}
    for s, d in dev.items():
        sp.records.append(rec(10 * s, None, "train.step", s, s + 1, step=s))
        sp.records.append(rec(10 * s + 1, 10 * s, "train.optimizer", s,
                              s + 0.5, step=s, _device_s=d))
    obs = {"steps": 3, "profile_steps": 2}
    assert read("optimizer_ms.train", obs) == pytest.approx(160.0)
    assert module("optimizer_ms.train").window_steps(obs)[1] == range(3, 6)
    assert read("optimizer_ms.train", {"steps": 3}) == pytest.approx(900.0)
    sp.records[-1].events, sp.records[-1]._device_s = None, None
    assert read("optimizer_ms.train", {"steps": 1}) is None
    # a recorder with fewer steps than the window is another run's
    assert module("optimizer_ms.train").window_steps(
        {"steps": 46, "profile_steps": 2}) is None
    assert read("optimizer_ms.train", {"steps": 46}) is None
    tracing._RECORDERS.pop("train", None)
    assert read("optimizer_ms.train", obs) is None


# ---------------------------------------------------------------------------
# the window of a whole run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return perfbench_tiny.make(tmp_path_factory.mktemp("bench"))


def run(root, cell, seed=2**31 + 91, seconds=1.5):
    args = harness.parse(["--workload", cell, "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", "0"])
    return harness.execute(args, time.perf_counter(), device_name="cpu",
                           root=root)


def test_serving_window_holds_the_window_calls(tiny):
    """The calls the serving readers select are the window's prefills and
    decode steps, give or take the calls that straddle its ends."""
    _, out = run(tiny, SERVE)
    obs = out["obs"]
    recs = tracing.recorder("serve").window(obs["window_s"])
    calls = [r for r in recs if r.name == "serve.call"]
    assert obs["decode_steps"] > 0
    assert abs(len(calls) - obs["prefills"] - obs["decode_steps"]) <= 2
    for name in ("call_overhead_us.serve", "engine_self_share.serve",
                 "device_wait_share.serve", "decode_enqueue_ms.serve"):
        assert read(name, obs) > 0, name


def test_training_window_holds_the_window_steps(tiny):
    """The steps the training reader selects are the window's
    ``Trainer.train`` call: ``obs["steps"]`` of them, each a recorded
    ``train.step`` with its four children."""
    _, out = run(tiny, TRAIN)
    obs = out["obs"]
    spans, steps = module("optimizer_ms.train", tiny).window_steps(obs)
    recs = list(spans.records)
    picked = [r for r in recs if r.name == "train.step" and r.step in steps]
    assert len(picked) == obs["steps"] == len(steps)
    assert max(r.step for r in recs if r.name == "train.step") == steps[-1]
    for r in picked:
        kids = sorted(k.name for k in recs if k.parent == r.sid)
        assert kids == ["train.data", "train.grad", "train.optimizer",
                        "train.sync"]
