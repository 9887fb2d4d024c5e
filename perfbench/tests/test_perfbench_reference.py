"""The frozen references against the port's plain path at smoke sizes, on
the CPU in fp32 (where the port runs the plain versions of its kernels),
and the control's precision."""
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(Path(__file__).parent)]

import perfbench_tiny  # noqa: E402
from perfbench import modelcfg, traffic, weights  # noqa: E402
from perfbench.reference import lm  # noqa: E402
from perfbench.reference.mixers import mamba2  # noqa: E402
from perfbench.reference import serve as ref_serve  # noqa: E402
from perfbench.reference import train as ref_train  # noqa: E402
from perfbench.reference.tree import tree_items  # noqa: E402

CPU = torch.device("cpu")


def conf(name, dtype="float32"):
    """A configuration at smoke size, or (``hybrid``) a smoke model with
    Mamba-2 layers for the reference's ``mamba2`` mixer."""
    if name == "hybrid":
        return {"name": "hybrid-smoke",
                "model": dict(perfbench_tiny.HYBRID, dtype=dtype)}
    doc = json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                     .read_text())
    doc["model"].update(perfbench_tiny.MODELS[name], dtype=dtype)
    return doc


@pytest.fixture(params=["deepseek-coder-33b-31L", "hybrid"])
def model(request):
    doc = conf(request.param)
    cfg = modelcfg.build(doc)
    return doc["model"], cfg, weights.make(cfg, 2**31 + 3, CPU)


def test_forward_matches_the_port(model):
    from repro_torch.models import model as model_lib
    m, cfg, params = model
    tokens = torch.randint(0, cfg.vocab_size, (2, 37),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want, _ = model_lib.forward(params, cfg, tokens)
        got = ref_serve.logits_at(params, m, list(tokens), [0, 0],
                                  lm.Ops("fp32"))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4)


def test_prefill_then_decode_matches_the_reference(model):
    """The served path (prefill, then a decode step at each position) and
    the reference's whole-sequence logits give the same greedy tokens."""
    from repro_torch.models import model as model_lib
    m, cfg, params = model
    prompt = torch.randint(0, cfg.vocab_size, (1, 12),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        cache = model_lib.init_cache(cfg, 1, 32, device=CPU)
        model_lib.prefill(params, cfg, prompt[:, :-1], cache)
        tok, out = prompt[:, -1:], []
        for i in range(6):
            logits, cache = model_lib.decode_step(
                params, cfg, tok, cache, torch.tensor([11 + i]))
            tok = logits[:, 0].argmax(-1, keepdim=True)
            out.append(int(tok))
    seqs, starts = ref_serve.served_sequences([(prompt[0].tolist(), out)],
                                              CPU)
    ref = ref_serve.logits_at(params, m, seqs, starts, lm.Ops("fp32"))
    assert ref_serve.widest_gap(ref, [out]) < 1e-4
    assert ref_serve.control_gap(ref, ref) == 0.0


def test_chunked_ssd_is_the_recurrence():
    from repro_torch.kernels import ref as port_ref
    g = torch.Generator().manual_seed(2)
    b, s, nh, hp, ns = 2, 45, 3, 8, 5
    x = torch.randn(b, s, nh, hp, generator=g)
    dt = torch.rand(b, s, nh, generator=g) * 0.3
    a = -torch.rand(nh, generator=g) * 4
    bm, cm = (torch.randn(b, s, ns, generator=g) for _ in range(2))
    want, _ = port_ref.mamba_chunk_scan(x, dt, a, bm, cm, torch.zeros(nh))
    for chunk in (8, 16, 64):
        torch.testing.assert_close(mamba2.ssd(x, dt, a, bm, cm, chunk), want,
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["deepseek-coder-33b-4L", "hybrid"])
def test_training_steps_match_the_port(name):
    """Loss, the first gradient and the change after two AdamW steps,
    against the port's train step on the same weights and batches."""
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import make_train_step
    doc = conf(name)
    m, cfg = doc["model"], modelcfg.build(doc)
    t = dict(json.loads((ROOT / "perfbench" / "traffic" /
                         "train_4x2048.json").read_text()), batch=2,
             seq_len=24)
    o = t["optimizer"]
    seed = 5
    params = weights.make(cfg, seed, CPU)
    batches = [traffic.train_batch(t, seed, cfg.vocab_size, s)
               for s in range(2)]
    ref = ref_train.run(params, m, o, [
        (torch.from_numpy(b["tokens"]).long(),
         torch.from_numpy(b["labels"]).long()) for b in batches],
        lm.Ops("fp32"))
    opt = make_optimizer("adamw", **{k: v for k, v in o.items()
                                     if k != "name"})
    from repro_torch.models.common import tree_map
    p = tree_map(lambda a: a.clone().requires_grad_(True), params)
    state = opt.init(p)
    step = make_train_step(cfg, opt)
    losses, first = [], None
    for b in batches:
        p, state, met = step(p, state, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
        losses.append(float(met["loss"]))
        if first is None:
            first = {k: float(v.norm()) / (1 - o["b1"])
                     for k, v in tree_items(state["m"])}
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    for k, v in ref["first_grad"].items():
        assert first[k] == pytest.approx(v, rel=1e-3, abs=1e-7), k
    for (k, v), (_, w) in zip(tree_items(p), tree_items(params)):
        assert float((v.detach() - w).norm()) == pytest.approx(
            ref["change"][k], rel=1e-3, abs=1e-7), k


def test_fp8_ops_round_to_e4m3():
    x = torch.tensor([[1.0, 1.06, -3.3, 448.0]])
    q = lm.fp8(x)
    assert q[0, 0] == 1.0 and q[0, 3] == 448.0
    assert q[0, 1] in (1.0, 1.125)         # 3 mantissa bits
    a = torch.randn(4, 16, requires_grad=True)
    w = torch.randn(16, 8, requires_grad=True)
    y = lm.Ops("fp8").mm(a, w)
    assert (y - a @ w).abs().max() > 0
    y.sum().backward()
    assert a.grad.shape == a.shape and w.grad.shape == w.shape
