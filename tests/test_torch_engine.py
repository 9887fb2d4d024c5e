"""The port's ServingEngine against the JAX model's greedy generation
(tests/test_train_serve_ft.py::test_serving_engine_matches_reference)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.serve import engine as engine_lib  # noqa: E402
from repro_torch.serve.engine import ServingEngine, _bucket  # noqa: E402


def _jax_generate(cfg, params, prompt, n_new, prefill=jmodel.prefill,
                  decode_step=jmodel.decode_step):
    cache = jmodel.init_cache(cfg, 1, 256)
    toks = jnp.asarray(prompt[None, :-1], jnp.int32)
    if toks.shape[1]:
        _, cache = prefill(params, cfg, toks, cache)
    cur, pos, out = int(prompt[-1]), len(prompt) - 1, []
    for _ in range(n_new):
        logits, cache = decode_step(
            params, cfg, jnp.asarray([[cur]], jnp.int32), cache,
            jnp.asarray([pos], jnp.int32))
        cur = int(jnp.argmax(logits[0, 0]))
        out.append(cur)
        pos += 1
    return out


def _serve(cfg, params, prompts, n_new, **kw):
    eng = ServingEngine(cfg, params, device="cpu", **kw)
    eng.start()
    reqs = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    try:
        for r in reqs:
            assert r.done.wait(120)
    finally:
        eng.stop()
    return eng, reqs


def test_engine_matches_jax_reference_generation():
    cfg_j = jconfigs.get_config("llama3.2-1b", smoke=True)
    cfg_t = tconfigs.get_config("llama3.2-1b", smoke=True)
    params_j = jmodel.init_params(jax.random.PRNGKey(1), cfg_j)
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg_t.vocab_size, size=n) for n in (5, 9, 17)]
    eng, reqs = _serve(cfg_t, params_t, prompts, 6, max_batch=4,
                       max_len=256)
    for p, r in zip(prompts, reqs):
        assert r.out_tokens == _jax_generate(cfg_j, params_j, p, 6)
    assert eng.n_prefills == 3 and eng.n_generated == 18


def test_engine_recycles_slots_and_stops_at_max_len():
    """More requests than slots: freed slots are reused, and a request
    whose position reaches max_len - 1 ends early (the 30-token prompt
    decodes at positions 29 and 30, then stops)."""
    from repro_torch.models import model as tmodel
    cfg = tconfigs.get_config("llama3.2-1b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    params = tmodel.init_params(gen, cfg, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in (1, 3, 12, 30, 7)]
    eng, reqs = _serve(cfg, params, prompts, 4, max_batch=2, max_len=32)
    assert [len(r.out_tokens) for r in reqs] == [4, 4, 4, 2, 4]
    assert eng.n_prefills == 4  # a one-token prompt needs no prefill
    assert all(r.finish_t >= r.submit_t for r in reqs)


def test_bucket():
    assert [_bucket(n) for n in (1, 16, 17, 512, 1025)] == \
        [16, 16, 32, 512, 2048]


def test_zamba2_engine_matches_jax_reference_generation():
    """Mamba state and the shared attention slot's per-repeat caches through
    the engine: prompts of 9 and 30 tokens would be bucketed to 16 and 32
    for an attention arch, and 3 requests over 2 slots reuse a slot."""
    cfg_j = jconfigs.get_config("zamba2-2.7b", smoke=True)
    cfg_t = tconfigs.get_config("zamba2-2.7b", smoke=True)
    params_j = jmodel.init_params(jax.random.PRNGKey(2), cfg_j)
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        "cpu")
    prefill = jax.jit(jmodel.prefill, static_argnums=1)
    decode_step = jax.jit(jmodel.decode_step, static_argnums=1)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg_t.vocab_size, size=n) for n in (9, 30, 17)]
    eng, reqs = _serve(cfg_t, params_t, prompts, 6, max_batch=2,
                       max_len=256)
    for p, r in zip(prompts, reqs):
        assert r.out_tokens == _jax_generate(cfg_j, params_j, p, 6,
                                             prefill, decode_step)
    assert eng.n_prefills == 3 and eng.n_generated == 18


def test_recurrent_archs_prefill_exact_prompt_length(monkeypatch):
    zamba = tconfigs.get_config("zamba2-2.7b", smoke=True)
    llama = tconfigs.get_config("llama3.2-1b", smoke=True)
    assert [engine_lib.prefill_length(zamba, n, 64) for n in (1, 8, 29)] \
        == [1, 8, 29]
    assert [engine_lib.prefill_length(llama, n, 64) for n in (1, 8, 29, 99)] \
        == [16, 16, 32, 64]
    from repro_torch.models import model as tmodel
    seen = []
    real = tmodel.prefill

    def spy(params, cfg, tokens, cache):
        seen.append(tokens.shape[1])
        return real(params, cfg, tokens, cache)

    monkeypatch.setattr(engine_lib.model_lib, "prefill", spy)
    params = tmodel.init_params(torch.Generator().manual_seed(0), zamba,
                                device="cpu")
    prompts = [np.arange(n) % zamba.vocab_size for n in (9, 30)]
    _serve(zamba, params, prompts, 2, max_batch=2, max_len=64)
    assert sorted(seen) == [8, 29]
