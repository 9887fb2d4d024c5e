"""Every per-layer metric's arithmetic against hand counts."""
import collections
import statistics
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import devtrace, flops, harness, serve_cell  # noqa: E402


def read(name, obs):
    return harness.reader(name)(obs)


def test_idle_union_and_gaps():
    # window 0..100 ns; kernels 10-30 and 20-40 overlap, 60-70, one past
    # the window's end clipped to 95-100
    dev = [("k1", 10, 30), ("k2", 20, 40), ("k1", 60, 70), ("k3", 95, 120)]
    host = [("aten::mm", 40, 60), ("aten::copy_", 45, 55),
            ("outer", 0, 100)]
    out = devtrace.summarize((0, 100), dev, host)
    assert out["busy_s"] == pytest.approx((30 + 10 + 5) / 1e9)
    assert out["window_s"] == pytest.approx(100 / 1e9)
    assert out["kernels"]["k1"] == [pytest.approx(30 / 1e9), 2]
    assert out["kernels"]["k3"] == [pytest.approx(5 / 1e9), 1]
    gaps = out["breakdown"]["idle_gaps"]
    # gaps: 0-10, 40-60, 70-95; longest first, named by the innermost host
    # range covering the middle
    assert [g[1] for g in gaps] == pytest.approx([25e-9, 20e-9, 10e-9])
    assert gaps[1][0] == "aten::copy_" and gaps[0][0] == "outer"
    ops = out["breakdown"]["device_ops"]
    assert ops[0][0] == "k1" and ops[0][1] == pytest.approx(30e-9)
    obs = {"trace": out}
    assert read("device_idle.serve", obs) == pytest.approx(55.0)
    assert read("device_idle.train", obs) == pytest.approx(55.0)


def test_live_pairs_and_model_flops():
    assert flops.live_pairs(4, 4, True, 0) == 10
    assert flops.live_pairs(4, 4, False, 0) == 16
    assert flops.live_pairs(4, 4, True, 2) == 1 + 2 + 2 + 2
    assert flops.live_pairs(3, 5, True, 0) == 6   # queries 0..2
    m = {"groups": [{"pattern": [{"kind": "mamba2"}, {"kind": "attn",
                                                      "shared": True}],
                     "repeat": 3}], "head_dim": 8, "num_heads": 2}
    assert flops.attention_layers(m) == 3
    n = 1000
    # 6 N B S + 12 hd H B P, P = layers x S (S + 1) / 2
    assert flops.train_step_flops(n, m, 2, 4) == 6 * n * 8 + \
        12 * 8 * 2 * 2 * 3 * 10
    assert flops.prefill_flops(n, m, 4) == 2 * n * 4 + 4 * 8 * 2 * 3 * 10
    assert flops.decode_flops(n, m, 9) == 2 * n + 4 * 8 * 2 * 3 * 10


def test_flash_roofline_reader():
    # one launch at (1, 1024, 1024, 56, 8, 128, causal): bytes bound or
    # flops bound, whichever is larger
    shape = (1, 1024, 1024, 56, 8, 128, True, 0)
    f = 4 * 56 * 128 * (1024 * 1025 // 2)
    b = 2 * (2 * 1024 * 56 * 128 + 2 * 1024 * 8 * 128)
    assert flops.flash_fwd_cost(*shape) == (f, b)
    bound = max(f / 989e12, b / 3.35e12)
    trace = {"kernels": {"void flash_fwd_kernel_sm90<128>(x)": [4 * bound, 3],
                         "gemm": [1.0, 9]}}
    obs = {"trace": trace, "sub_flash": collections.Counter({shape: 2})}
    assert read("flash_fwd_roofline.serve", obs) == pytest.approx(50.0)
    assert read("flash_fwd_roofline.serve", {}) is None


def test_flash_training_roofline_reader():
    """Forward and backward launches against the ``flash_fwd`` and
    ``flash_bwd_`` kernels' time; the backward's five products are 2.5
    times the forward's two."""
    shape = (4, 2048, 2048, 56, 8, 128, True, 0)
    f, _ = flops.flash_fwd_cost(*shape)
    fb, bb = flops.flash_bwd_cost(*shape)
    assert fb == 5 * f // 2
    assert bb == 2 * (5 * 4 * 2048 * 56 * 128 + 4 * 4 * 2048 * 8 * 128) + \
        4 * 4 * 56 * 2048
    fwd = flops.bound_s(f, 0)
    bwd = flops.bound_s(fb, bb)
    sec = 10 * (2 * fwd + bwd)
    trace = {"kernels": {"void flash_fwd_kernel_sm90<128, 2>(a)": [sec / 2, 2],
                         "void flash_bwd_dkdv_kernel_sm90<7>(b)":
                             [sec / 4, 1],
                         "void flash_bwd_dot_kernel(c)": [sec / 4, 1],
                         "gemm": [5.0, 1]}}
    obs = {"trace": trace,
           "sub_flash": collections.Counter({shape: 2}),
           "sub_flash_bwd": collections.Counter({shape: 1})}
    assert read("flash_roofline.train", obs) == pytest.approx(10.0)
    assert read("flash_roofline.train", dict(obs, sub_flash_bwd=None)) \
        is None


def test_mfu_readers():
    obs = {"window_s": 2.0, "model_flops": 989e12}
    assert read("mfu.serve", obs) == pytest.approx(50.0)
    obs = {"window_s": 4.0, "steps": 2, "step_flops": 989e12}
    assert read("mfu.train", obs) == pytest.approx(50.0)


def test_engine_readers():
    obs = {"generated": 96, "decode_steps": 4, "slots": 32}
    assert read("decode_occupancy.serve", obs) == pytest.approx(75.0)
    # two prefills of 1100 and 300 prompt tokens (1099 + 299 needed),
    # launched at 2048 and 512 in each of 2 attention layers
    shapes = collections.Counter({(1, 2048, 2048, 8, 8, 128, True, 0): 2,
                                  (1, 512, 512, 8, 8, 128, True, 0): 2})
    obs = {"flash_shapes": shapes, "prompt_tokens_needed": 1099 + 299,
           "attention_layers": 2}
    assert read("prefill_useful_share.serve", obs) == pytest.approx(
        100 * 1398 / 2560)
    obs = {"server_busy_s": 0.003, "tasks_finished": 100}
    assert read("server_us_per_task.serve", obs) == pytest.approx(30.0)
    assert read("step_ms_median.train", {"step_ms": [3.0, 1.0, 2.0, 10.0]}) \
        == 2.5


def test_p95_is_over_all_requests():
    lat = list(range(1, 201))       # 200 requests, 1..200 ms
    assert serve_cell.p95(lat) == pytest.approx(
        statistics.quantiles(lat, n=20, method="inclusive")[18])
    assert serve_cell.p95(lat) == pytest.approx(190.05)
    assert serve_cell.p95([7.0]) == 7.0


class _Req:
    def __init__(self, out):
        self.out_tokens = out


class _Rec:
    def __init__(self, prompt_len, open_tokens, out, admitted=None,
                 close_tokens=None):
        self.prompt_len, self.open_tokens = prompt_len, open_tokens
        self.req = _Req(out)
        self.open_admitted = open_tokens > 0 if admitted is None else admitted
        self.close_tokens = len(out) if close_tokens is None else close_tokens


def test_window_flops_count_prefills_and_tokens_of_the_window():
    m = {"groups": [{"pattern": [{"kind": "attn"}], "repeat": 2}],
         "head_dim": 4, "num_heads": 2}
    n = 100
    recs = [_Rec(10, 0, [1, 2, 3]),      # prefilled and 3 tokens in window
            _Rec(20, 2, [1, 2, 3, 4]),   # tokens 2 and 3 in the window
            _Rec(30, 5, [1] * 5),        # done before the window
            # prefilled before the window opened, its first token after
            _Rec(40, 0, [1], admitted=True, close_tokens=0),
            # prefilled in the window, no token before it closed
            _Rec(50, 0, [1, 2], close_tokens=0),
            # its tokens after the close do not count
            _Rec(60, 0, [1, 2, 3], close_tokens=1)]
    o = {"n_generated": 0, "n_decode_steps": 0, "n_prefills": 0,
         "server_busy": 0.0, "n_finished": 0, "flash": collections.Counter()}
    c = {"n_generated": 5, "n_decode_steps": 3, "n_prefills": 1,
         "server_busy": 0.01, "n_finished": 4,
         "flash": collections.Counter(), "admitted": {id(recs[4].req)}}
    obs = serve_cell._window_obs(recs, o, c, m, n, 4, 1.0)
    want = (flops.prefill_flops(n, m, 9)
            + sum(flops.decode_flops(n, m, 9 + i) for i in range(3))
            + sum(flops.decode_flops(n, m, 19 + i) for i in (2, 3))
            + flops.prefill_flops(n, m, 49)
            + flops.prefill_flops(n, m, 59) + flops.decode_flops(n, m, 59))
    assert obs["model_flops"] == want
    assert obs["prompt_tokens_needed"] == 9 + 49 + 59
    assert obs["generated"] == 5 and obs["tasks_finished"] == 4
