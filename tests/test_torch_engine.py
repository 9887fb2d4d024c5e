"""The port's ServingEngine against the JAX model's greedy generation
(tests/test_train_serve_ft.py::test_serving_engine_matches_reference),
and its runtime side: every prefill and decode step is a task on the
engine's warm ``repro_torch.core`` Cluster, run under inference mode on
the pool's thread, with ``request-*`` events by tenant, ``observe()``, no
spill at the default memory limit, no call's tensors kept by the pool
after the call, and a failing step re-raised by ``stop()``."""
import gc
import threading
import time
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
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


def test_engine_runs_steps_on_its_cluster_with_request_events(monkeypatch):
    """Each prefill and decode step is one epoch of the engine's pool, run
    on the pool's worker thread under inference mode; every request
    enters, is admitted and exits once, under its tenant; nothing spills
    at the default limit; ``observe()`` snapshots the pool."""
    from repro_torch.models import model as tmodel
    cfg = tconfigs.get_config("llama3.2-1b", smoke=True)
    params = tmodel.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    seen = []
    real_prefill, real_decode = tmodel.prefill, tmodel.decode_step

    def spy(real, kind):
        def call(*args):
            seen.append((kind, torch.is_inference_mode_enabled(),
                         threading.current_thread()))
            return real(*args)
        return call

    monkeypatch.setattr(engine_lib.model_lib, "prefill",
                        spy(real_prefill, "prefill"))
    monkeypatch.setattr(engine_lib.model_lib, "decode_step",
                        spy(real_decode, "decode"))
    eng = ServingEngine(cfg, params, max_batch=2, max_len=64, events=True,
                        device="cpu")
    assert eng.observe()["n_workers"] == 1
    eng.start()
    rng = np.random.default_rng(4)
    tenants = ["a", "b", "a"]
    reqs = [eng.submit(rng.integers(0, cfg.vocab_size, size=n),
                       max_new_tokens=3, tenant=t)
            for n, t in zip((4, 9, 6), tenants)]
    try:
        for r in reqs:
            assert r.done.wait(120)
        snap = eng.observe()
    finally:
        eng.stop()
    kinds = [k for k, _, _ in seen]
    assert kinds.count("prefill") == eng.n_prefills == 3
    assert kinds.count("decode") == eng.n_decode_steps
    assert all(mode for _, mode, _ in seen)
    assert all(t is not eng._thread and t is not threading.main_thread()
               for _, _, t in seen)
    n_calls = eng.n_prefills + eng.n_decode_steps
    assert snap["n_epochs"] == n_calls and snap["n_finished"] == n_calls
    assert snap["open_epochs"] == [] and snap["dead"] == []
    assert snap["spill_bytes"] == 0
    mem = eng._cluster.runtime.memory_stats()
    assert mem["spill_count"] == 0 and mem["memory_limit"] == \
        engine_lib.DEFAULT_MEMORY_LIMIT
    evs = eng.events.tail(10**5)
    for kind in ("request-enter", "request-admit", "request-exit"):
        got = {e["rid"]: e["tenant"] for e in evs if e["type"] == kind}
        assert got == {r.rid: t for r, t in zip(reqs, tenants)}, kind
    exits = {e["rid"]: e for e in evs if e["type"] == "request-exit"}
    for r in reqs:
        assert exits[r.rid]["n_tokens"] == len(r.out_tokens) == 3
        assert exits[r.rid]["latency_s"] == r.finish_t - r.submit_t
    admits = [e for e in evs if e["type"] == "request-admit"]
    assert {e["slot"] for e in admits} <= {0, 1}
    assert eng.events.counts["epoch-close"] == n_calls


def test_engine_pool_keeps_no_tensor_of_a_finished_call(monkeypatch):
    """The pool's graph holds every task's args until compaction, so the
    engine passes it host arrays and the long-lived param and cache
    trees: each call's token and position tensors and each prefill's
    one-slot cache are freed once the call returns, while the engine
    still serves."""
    from repro_torch.models import model as tmodel
    cfg = tconfigs.get_config("llama3.2-1b", smoke=True)
    params = tmodel.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    made = []
    real_prefill, real_decode = tmodel.prefill, tmodel.decode_step

    def prefill(params, cfg, tokens, cache):
        made.extend(weakref.ref(t) for t in
                    [tokens] + tree_leaves(cache))
        return real_prefill(params, cfg, tokens, cache)

    def decode_step(params, cfg, tokens, cache, pos):
        made.extend((weakref.ref(tokens), weakref.ref(pos)))
        return real_decode(params, cfg, tokens, cache, pos)

    monkeypatch.setattr(engine_lib.model_lib, "prefill", prefill)
    monkeypatch.setattr(engine_lib.model_lib, "decode_step", decode_step)
    eng = ServingEngine(cfg, params, max_batch=2, max_len=64, device="cpu")
    eng.start()
    reqs = [eng.submit(np.arange(n) % cfg.vocab_size, max_new_tokens=3)
            for n in (4, 9, 6, 7)]
    try:
        for r in reqs:
            assert r.done.wait(120)
        # the pool's server drops a released result on its own thread
        for _ in range(1000):
            gc.collect()
            alive = [r() for r in made if r() is not None]
            if not alive:
                break
            time.sleep(0.01)
        n_tasks = eng._cluster.runtime.g.n_rows
    finally:
        eng.stop()
    assert eng.n_prefills == 4 and n_tasks == \
        eng.n_prefills + eng.n_decode_steps
    assert len(made) == 2 * eng.n_decode_steps + eng.n_prefills * (
        1 + len(tree_leaves(eng.cache)))
    assert alive == []


def test_failed_decode_step_makes_stop_raise(monkeypatch):
    """A decode step that raises on the pool's thread is returned to the
    loop thread, which fails: the request is released and ``stop()``
    re-raises at once (the pool's worker survives, so no call waits out
    its timeout)."""
    from repro_torch.models import model as tmodel
    cfg = tconfigs.get_config("llama3.2-1b", smoke=True)
    params = tmodel.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")

    def boom(*args):
        raise ValueError("decode failed")

    monkeypatch.setattr(engine_lib.model_lib, "decode_step", boom)
    eng = ServingEngine(cfg, params, max_batch=2, max_len=64, device="cpu")
    eng.start()
    req = eng.submit(np.arange(5), max_new_tokens=3)
    assert req.done.wait(10)
    with pytest.raises(RuntimeError, match="serving loop failed") as info:
        eng.stop()
    assert isinstance(info.value.__cause__, ValueError)
    assert req.out_tokens == []
    assert not eng._thread.is_alive()
    assert eng._cluster.runtime.dead == set()
