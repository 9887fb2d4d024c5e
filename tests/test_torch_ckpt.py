"""The port's checkpoints (repro_torch.ckpt.checkpoint) against the JAX
package's on-disk layout: each package restores the other's checkpoints,
bf16 leaves included, and the files the port writes are the bytes the JAX
package writes for the same tree."""
import dataclasses
import functools
import json
import pathlib
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.ckpt import checkpoint as tckpt  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402


@functools.lru_cache(maxsize=None)
def _trees(dtype: str):
    """The same {"params", "opt"} tree (llama smoke, params in ``dtype``,
    AdamW state with nonzero moments and step 5) in both packages."""
    cfg = dataclasses.replace(jconfigs.get_config("llama3.2-1b", smoke=True),
                              dtype=dtype)
    params = jax.jit(jmodel.init_params, static_argnums=1)(
        jax.random.PRNGKey(1), cfg)  # jitted: 3x faster than op by op
    state = jopt.make_optimizer("adamw").init(params)
    rng = np.random.default_rng(0)
    state = {"m": jax.tree.map(lambda m: jnp.asarray(
                 rng.standard_normal(m.shape), jnp.float32), state["m"]),
             "v": jax.tree.map(lambda v: jnp.asarray(
                 rng.random(v.shape), jnp.float32), state["v"]),
             "step": jnp.asarray(5, jnp.int32)}
    jtree = {"params": params, "opt": state}
    ttree = bridge.params_from_numpy(jax.tree.map(np.asarray, jtree), "cpu")
    return jtree, ttree


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_same(ttree, jtree):
    got = jax.tree.leaves(bridge.params_to_numpy(ttree))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jtree))
    assert len(got) == len(want)
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a, _bits(w))


def _zeros_like(ttree):
    return tree_map(torch.zeros_like, ttree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_in_the_port(dtype):
    jtree, ttree = _trees(dtype)
    with tempfile.TemporaryDirectory() as d:
        jckpt.save(d, 5, jtree, meta={"config": "llama3.2-1b-smoke"})
        restored, step, meta = tckpt.restore(d, _zeros_like(ttree))
    assert step == 5 and meta == {"config": "llama3.2-1b-smoke"}
    assert restored["opt"]["step"].dtype == torch.int32
    assert isinstance(restored["params"]["groups"][0]["slots"], tuple)
    _assert_same(restored, jtree)


def test_port_checkpoint_restores_in_jax():
    jtree, ttree = _trees("float32")
    with tempfile.TemporaryDirectory() as d:
        tckpt.save(d, 9, ttree, meta={"config": "x"})
        restored, step, meta = jckpt.restore(
            d, jax.tree.map(jnp.zeros_like, jtree))
    assert step == 9 and meta == {"config": "x"}
    for a, w in zip(jax.tree.leaves(restored), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_writes_the_jax_bytes(dtype):
    """Same manifest, same leaf files byte for byte: bf16 leaves carry the
    '<V2' header numpy writes for ml_dtypes.bfloat16, so whatever reads the
    JAX package's checkpoints reads the port's alike."""
    jtree, ttree = _trees(dtype)
    with tempfile.TemporaryDirectory() as dj, \
            tempfile.TemporaryDirectory() as dt:
        pj = jckpt.save(dj, 3, jtree, meta={"config": "c"})
        pt = tckpt.save(dt, 3, ttree, meta={"config": "c"})
        manifest = json.loads((pt / "manifest.json").read_text())
        assert manifest == json.loads((pj / "manifest.json").read_text())
        assert "['opt']['m']['groups'][0]['slots'][0]['mixer']['wq']" in \
            manifest["leaves"]
        for ent in manifest["leaves"].values():
            assert (pt / ent["file"]).read_bytes() == \
                (pj / ent["file"]).read_bytes()
        if dtype == "bfloat16":
            ent = manifest["leaves"]["['params']['embed']"]
            assert ent["dtype"] == "bfloat16"
            back = np.load(pt / ent["file"]).view(ml_dtypes.bfloat16)
            np.testing.assert_array_equal(
                back, np.asarray(jtree["params"]["embed"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_roundtrip_exact(dtype):
    _, ttree = _trees(dtype)
    with tempfile.TemporaryDirectory() as d:
        tckpt.save(d, 7, ttree, meta={"config": "c"})
        restored, step, meta = tckpt.restore(d, _zeros_like(ttree))
    assert step == 7 and meta["config"] == "c"
    for a, b in zip(tree_leaves(ttree), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_restore_checks_structure():
    _, ttree = _trees("float32")
    with tempfile.TemporaryDirectory() as d:
        tckpt.save(d, 1, {"x": torch.ones(3)})
        with pytest.raises(KeyError, match="missing leaf"):
            tckpt.restore(d, {"y": torch.zeros(3)})
        with pytest.raises(ValueError, match="shape mismatch"):
            tckpt.restore(d, {"x": torch.zeros(4)})
        with pytest.raises(FileNotFoundError):
            tckpt.restore(pathlib.Path(d) / "none", ttree)


def test_async_checkpointer_gc():
    """tests/test_train_serve_ft.py::test_async_checkpointer_gc."""
    with tempfile.TemporaryDirectory() as d:
        ck = tckpt.AsyncCheckpointer(d, keep=2)
        for s in (1, 2, 3, 4):
            ck.save(s, {"x": torch.ones(3) * s})
        ck.wait()
        assert tckpt.latest_step(d) == 4
        assert sorted(p.name for p in pathlib.Path(d).iterdir()) == [
            "step_00000003", "step_00000004"]
        restored, step, _ = tckpt.restore(d, {"x": torch.zeros(3)})
        assert float(restored["x"][0]) == 4.0


def test_async_checkpointer_snapshots_before_an_in_place_update():
    """The optimizer updates params in place right after a save: the
    checkpoint must hold the values at the save."""
    with tempfile.TemporaryDirectory() as d:
        ck = tckpt.AsyncCheckpointer(d)
        params = {"w": torch.ones(1024)}
        state = topt.make_optimizer("adamw").init(params)
        ck.save(1, {"params": params, "opt": state})
        params["w"].add_(1.0)
        state["step"].add_(1)
        ck.wait()
        restored, _, _ = tckpt.restore(d, {"params": params, "opt": state})
    assert float(restored["params"]["w"].max()) == 1.0
    assert int(restored["opt"]["step"]) == 0
