"""The port's sharding rules against the JAX package's: every param,
cache and input spec and every logical rule of ``repro_torch.parallel``
equal entry by entry to ``repro.parallel``'s on JAX's fake production
meshes, the per-device param bytes of the DTensors equal to the
arithmetic from JAX's specs, and ``hint`` placing a DTensor as JAX's spec
implies (a fake process group of 256 ranks, made and destroyed here)."""
from types import SimpleNamespace
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.optimized import optimized_config as j_optimized  # noqa: E402,E501
from repro.models import model as jmodel  # noqa: E402
from repro.models.common import SHAPE_CASES as J_SHAPES  # noqa: E402
from repro.parallel import annotate as jannotate  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.optimized import optimized_config as t_optimized  # noqa: E402,E501
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.common import (SHAPE_CASES, tree_map,  # noqa: E402
                                       tree_paths)
from repro_torch.parallel import annotate, sharding  # noqa: E402

ARCHS = jconfigs.all_arch_names()
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


class PodMesh:  # tests/test_sharding.py's fake meshes
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


class SingleMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


def _jax_paths(tree):
    return [(jax.tree_util.keystr(p), leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_shape_cases_equal_jax():
    assert SHAPE_CASES.keys() == J_SHAPES.keys()
    for k, c in SHAPE_CASES.items():
        j = J_SHAPES[k]
        assert (c.name, c.seq_len, c.global_batch, c.kind) == (
            j.name, j.seq_len, j.global_batch, j.kind)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(arch):
    """Every leaf's spec on the (2, 16, 16) mesh, and the abstract params'
    paths, shapes and dtypes, as JAX has them."""
    cfg_j, cfg_t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jleaves = _jax_paths(jmodel.abstract_params(cfg_j))
    tleaves = tree_paths(tmodel.abstract_params(cfg_t))
    assert [p for p, _ in tleaves] == [p for p, _ in jleaves]
    for (path, lt), (_, lj) in zip(tleaves, jleaves):
        assert lt.device.type == "meta"
        assert tuple(lt.shape) == tuple(lj.shape), path
        assert str(lt.dtype).split(".")[-1] == str(lj.dtype), path
    jspecs = {jax.tree_util.keystr(k): tuple(
        jsharding.param_spec(cfg_j, PodMesh(), k, leaf))
        for k, leaf in jax.tree_util.tree_flatten_with_path(
            jmodel.abstract_params(cfg_j))[0]}
    tspecs = {p: sharding.param_spec(cfg_t, PodMesh(), p, leaf)
              for p, leaf in tleaves}
    assert tspecs == jspecs


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_input_specs_equal_jax(arch, shape):
    cfg_j, cfg_t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    if shape == "long_500k" and not cfg_t.subquadratic:
        pytest.skip("full-attention arch skips long_500k")
    case = SHAPE_CASES[shape]
    jc = jmodel.abstract_cache(cfg_j, case.global_batch, 64)
    tc = tmodel.abstract_cache(cfg_t, case.global_batch, 64)
    want = {jax.tree_util.keystr(k): (tuple(leaf.shape), tuple(
        jsharding.cache_spec(cfg_j, SingleMesh(), case.global_batch, k,
                             leaf)))
        for k, leaf in jax.tree_util.tree_flatten_with_path(jc)[0]}
    got = {p: (tuple(leaf.shape), sharding.cache_spec(
        cfg_t, SingleMesh(), case.global_batch, p, leaf))
        for p, leaf in tree_paths(tc)}
    assert got == want
    jins = jsharding.input_specs(cfg_j, shape,
                                 AbstractMesh((16, 16), ("data", "model")))
    tins = sharding.input_specs(cfg_t, shape, SingleMesh())
    assert tins.keys() == jins.keys()
    for k, j in jins.items():
        t = tins[k]
        assert tuple(t.shape) == tuple(j.shape)
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        assert t.spec == tuple(j.sharding.spec), k


@pytest.mark.parametrize("batch", [1, 8, 32, 128, 256, 6])
@pytest.mark.parametrize("mesh", [PodMesh, SingleMesh])
def test_batch_axes_equal_jax(mesh, batch):
    assert sharding.batch_axes(mesh(), batch) == jsharding.batch_axes(
        mesh(), batch)


@pytest.mark.parametrize("arch", ARCHS)
def test_make_rules_equal_jax(arch):
    cfg_j, cfg_t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for mesh in (PodMesh(), SingleMesh()):
        for batch in (1, 32, 256):
            assert annotate.make_rules(cfg_t, mesh, batch) == \
                jannotate.make_rules(cfg_j, mesh, batch)


@pytest.mark.parametrize("arch", ARCHS)
def test_optimized_config_rules_equal_jax(arch):
    """seq_parallel and moe_sharding act through make_rules as in JAX."""
    cfg_j, cfg_t = j_optimized(arch), t_optimized(arch)
    assert (cfg_t.seq_parallel, cfg_t.moe_sharding) == (
        cfg_j.seq_parallel, cfg_j.moe_sharding)
    for mesh in (PodMesh(), SingleMesh()):
        assert annotate.make_rules(cfg_t, mesh, 256) == \
            jannotate.make_rules(cfg_j, mesh, 256)
    jp = jmodel.abstract_params(cfg_j)
    want = {jax.tree_util.keystr(k): tuple(
        jsharding.param_spec(cfg_j, PodMesh(), k, leaf))
        for k, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = {p: sharding.param_spec(cfg_t, PodMesh(), p, leaf)
           for p, leaf in tree_paths(tmodel.abstract_params(cfg_t))}
    assert got == want


# ---------------------------------------------------------------------------
# DTensors on a fake production mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh():
    from repro_torch.launch import mesh as meshlib
    m = meshlib.make_production_mesh(device="cpu")
    yield m
    meshlib.release()


def _jax_bytes(cfg_j, mesh_cls) -> int:
    """Per-device param bytes by JAX's specs: each leaf's bytes over the
    product of the axes its spec names."""
    total = 0
    for k, leaf in jax.tree_util.tree_flatten_with_path(
            jmodel.abstract_params(cfg_j))[0]:
        n = leaf.size * leaf.dtype.itemsize
        for e in jsharding.param_spec(cfg_j, mesh_cls(), k, leaf):
            for a in (() if e is None else e if isinstance(e, tuple)
                      else (e,)):
                n //= mesh_cls.shape[a]
        total += n
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_per_device_param_bytes_equal_jax_arithmetic(mesh, arch):
    from torch.distributed.tensor import DTensor
    cfg_j, cfg_t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    params = sharding.abstract_sharded_params(cfg_t, mesh)
    leaves = [leaf for _, leaf in tree_paths(params)]
    assert all(isinstance(t, DTensor) and t.to_local().is_meta
               for t in leaves)
    got = sum(t.to_local().numel() * t.element_size() for t in leaves)
    assert got == _jax_bytes(cfg_j, SingleMesh)
    # the placements are the specs' (param_shardings)
    same = []
    tree_map(lambda t, pl: same.append(tuple(t.placements) == pl), params,
             sharding.param_shardings(cfg_t, mesh))
    assert len(same) == len(leaves) and all(same)


def test_hint_is_identity_outside_a_context(mesh):
    from torch.distributed.tensor import DTensor, Replicate
    x = torch.zeros(4, 8)
    assert annotate.hint(x, "batch", "embed") is x
    d = DTensor.from_local(torch.zeros(4, 8, device="meta"), mesh,
                           [Replicate(), Replicate()], run_check=False)
    assert annotate.hint(d, "batch", "embed") is d
    cfg = tconfigs.get_config("llama3.2-1b")
    with annotate.logical_rules(mesh, annotate.make_rules(cfg, mesh, 256)):
        assert annotate.hint(x, "batch", "embed") is x  # not a DTensor


HINTS = [  # (shape, logical axes), from the models' hint sites
    ((256, 4096, 2048), ("batch", "seq", "embed")),
    ((256, 4096, 32, 64), ("batch", "attn_seq", "heads", None)),
    ((256, 4096, 8, 64), ("batch", "seq", "kv_heads", None)),
    ((2048, 2048), ("wt_d", "heads_out")),
    ((8192, 2048), ("ffn", "wt_d")),
    ((256, 4096, 128256), ("batch", "seq", "vocab")),
    ((1, 1, 32, 64), ("batch", "attn_seq", "heads", None)),
    ((32, 7, 5), ("batch", "batch", "ffn")),
]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-coder-33b",
                                  "grok-1-314b", "zamba2-2.7b"])
@pytest.mark.parametrize("shape,axes", HINTS)
def test_hint_places_as_jax_spec(mesh, arch, shape, axes):
    """Inside a context, hint redistributes a DTensor to the placements of
    the spec JAX's hint builds (captured from its
    ``with_sharding_constraint``), reuse and divisibility rules included."""
    from torch.distributed.tensor import DTensor, Replicate
    cfg_j, cfg_t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    amesh = AbstractMesh((16, 16), ("data", "model"))
    seen = []
    with mock.patch.object(jax.lax, "with_sharding_constraint",
                           lambda x, s: seen.append(tuple(s.spec)) or x), \
            jannotate.logical_rules(amesh, jannotate.make_rules(
                cfg_j, SingleMesh(), shape[0])):
        jannotate.hint(SimpleNamespace(shape=shape), *axes)  # reads .shape
    d = DTensor.from_local(torch.zeros(shape, device="meta"), mesh,
                           [Replicate(), Replicate()], run_check=False)
    with annotate.logical_rules(mesh, annotate.make_rules(cfg_t, mesh,
                                                          shape[0])):
        out = annotate.hint(d, *axes)
    want = seen[0] + (None,) * (len(shape) - len(seen[0]))
    assert tuple(out.placements) == sharding.to_placements(want, mesh)
    assert out.shape == d.shape


def _meta(mesh, shape, placements):
    """A meta DTensor of global ``shape`` placed by ``placements``."""
    from torch.distributed.tensor import DTensor
    loc = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            loc[p.dim] //= mesh.size(i)
    return DTensor.from_local(torch.empty(loc, device="meta"), mesh,
                              placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def test_kernel_route_refuses_layouts_that_are_not_local(mesh):
    """The DTensor route runs a kernel on local shards or raises: rmsnorm
    over a sharded last dim, causal flash over sequence-sharded K/V, and
    q and k/v sharded on different dims are refused, never gathered."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.kernels import ops
    x = _meta(mesh, (32, 64, 256), (Shard(0), Shard(2)))
    sc = _meta(mesh, (256,), (Replicate(), Replicate()))
    with pytest.raises(NotImplementedError, match="last"):
        ops.rmsnorm(x, sc)
    q = _meta(mesh, (16, 64, 32, 64), (Shard(0), Shard(2)))
    kv = _meta(mesh, (16, 64, 16, 64), (Shard(0), Shard(1)))
    with ops.fake_kernels():
        with pytest.raises(NotImplementedError, match="sequence"):
            ops.flash_attention(q, kv, kv, causal=True)
        kb = _meta(mesh, (16, 64, 16, 64), (Shard(2), Shard(0)))
        with pytest.raises(NotImplementedError, match="placed"):
            ops.flash_attention(q, kb, kb, causal=True)
        # heads over model, kv heads replicated: each rank slices its
        # queries' kv heads (G = 2, two query heads a rank)
        kr = _meta(mesh, (16, 64, 16, 64), (Shard(0), Replicate()))
        out = ops.flash_attention(q, kr, kr, causal=True)
        assert tuple(out.placements) == (Shard(0), Shard(2))
        assert out.to_local().shape == (1, 64, 2, 64)
