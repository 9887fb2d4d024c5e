"""The port's dry-run and roofline against the JAX package's: model FLOPs,
attention FLOPs and the sLSTM correction equal for every arch and shape;
the ring factors giving JAX's wire bytes on synthetic HLO lines of each
collective; ``run_cell`` on the smoke configs over a (2, 4) fake mesh
giving status ok and JAX's record keys; the useful-FLOPs ratio of full
cells on the production mesh within (0, 1.05].  Fake process groups are
made here and destroyed at the end."""
import json
import math

import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.launch import dryrun as jdryrun  # noqa: E402
from repro.launch import roofline as jrl  # noqa: E402
from repro.models.common import SHAPE_CASES as J_SHAPES  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.models.common import SHAPE_CASES  # noqa: E402

ARCHS = jconfigs.all_arch_names()
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
# the keys of a JAX dry-run record (repro.launch.dryrun.run_cell) and of
# its roofline (repro.launch.roofline.Roofline.to_dict)
RECORD_KEYS = {"arch", "shape", "mesh", "time", "full", "corrected",
               "roofline", "n_devices", "status"}
CORRECTED_KEYS = {"flops", "bytes", "wire_bytes", "collective_bytes_by_op",
                  "collective_counts"}


class PodMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


class SingleMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


@pytest.fixture(scope="module", autouse=True)
def _release_fake_group():
    yield
    meshlib.release()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_jax(arch, shape):
    cfg_j, cfg_t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    case_j, case_t = J_SHAPES[shape], SHAPE_CASES[shape]
    tokens = case_t.global_batch * (case_t.seq_len
                                    if case_t.kind != "decode" else 1)
    assert cfg_t.active_param_count() == cfg_j.active_param_count()
    assert roofline.model_flops(cfg_t.active_param_count(), tokens,
                                case_t.kind) == jrl.model_flops(
        cfg_j.active_param_count(), tokens, case_j.kind)
    assert roofline.attn_model_flops(cfg_t, case_t) == \
        jrl.attn_model_flops(cfg_j, case_j)
    for mesh in (PodMesh(), SingleMesh()):
        assert dryrun.slstm_correction(cfg_t, case_t, mesh) == \
            jdryrun.slstm_correction(cfg_j, case_j, mesh)


HLO = {  # op -> a compiled SPMD line of it, the group size 16
    "all-gather": "  %ag = bf16[256,1024]{1,0} all-gather(bf16[16,1024]{1,0} "
                  "%p), channel_id=1, replica_groups=[16,16]<=[256], "
                  "dimensions={0}",
    "all-reduce": "  %ar = f32[4096,512]{1,0} all-reduce(f32[4096,512]{1,0} "
                  "%p), channel_id=2, replica_groups=[16,16]<=[256], "
                  "to_apply=%add",
    "reduce-scatter": "  %rs = f32[64,512]{1,0} reduce-scatter(f32[1024,512]"
                      "{1,0} %p), channel_id=3, replica_groups=[16,16]<=[256]"
                      ", dimensions={0}, to_apply=%add",
    "all-to-all": "  %a2a = bf16[128,2048]{1,0} all-to-all(bf16[128,2048]"
                  "{1,0} %p), channel_id=4, replica_groups=[16,16]<=[256], "
                  "dimensions={0}",
    "collective-permute": "  %cp = bf16[8,4096]{1,0} collective-permute("
                          "bf16[8,4096]{1,0} %p), channel_id=5, "
                          "replica_groups=[16,16]<=[256]",
}
RESULT_BYTES = {"all-gather": 256 * 1024 * 2, "all-reduce": 4096 * 512 * 4,
                "reduce-scatter": 64 * 512 * 4,
                "all-to-all": 128 * 2048 * 2,
                "collective-permute": 8 * 4096 * 2}


@pytest.mark.parametrize("op", sorted(HLO))
def test_ring_factors_give_jax_wire_bytes(op):
    want = jrl.collective_stats(HLO[op])
    assert want.counts == {op: 1}
    got = roofline.CollectiveStats()
    got.record(op, RESULT_BYTES[op], 16)
    assert got.counts == want.counts
    assert math.isclose(got.wire_bytes, want.wire_bytes, rel_tol=1e-12)
    assert got.bytes_by_op.keys() == want.bytes_by_op.keys()
    one = roofline.CollectiveStats()
    one.record(op, RESULT_BYTES[op], 1)  # a group of one: no collective
    assert one.counts == {} and one.wire_bytes == 0.0


def test_roofline_keys_and_constants_are_the_h100s():
    r = roofline.Roofline(flops=2e12, bytes_accessed=1e12, wire_bytes=1e9,
                          model_flops=1e12)
    j = jrl.Roofline(flops=2e12, bytes_accessed=1e12, wire_bytes=1e9,
                     model_flops=1e12)
    assert r.to_dict().keys() == j.to_dict().keys()
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (989e12, 3.35e12)
    assert r.t_compute == 2e12 / 989e12 and r.useful_ratio == 0.5
    assert r.bottleneck == "memory"


def _mesh24():
    meshlib._fake_group(8)
    return meshlib.make_host_mesh((2, 4), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_run_cell_smoke_configs_on_a_fake_mesh(arch, tmp_path):
    """Every shape of the arch's smoke config on a (2, 4) fake mesh: status
    ok (long_500k a skip for full attention), JAX's record keys, FLOPs,
    bytes and argument bytes counted, and a record JSON can hold."""
    mesh = _mesh24()
    cfg = tconfigs.get_config(arch, smoke=True)
    for shape in SHAPES:
        rec = dryrun.run_cell(arch, shape, "host", tmp_path, smoke=True,
                              mesh=mesh)
        assert json.loads((tmp_path / f"{tconfigs.canonical(arch)}__"
                           f"{shape}__host.json").read_text()) == rec
        if shape == "long_500k" and not cfg.subquadratic:
            assert rec["status"] == "skip"
            continue
        assert rec["status"] == "ok", rec.get("trace")
        assert rec.keys() == RECORD_KEYS
        assert rec["corrected"].keys() == CORRECTED_KEYS
        assert rec["n_devices"] == 8
        assert rec["roofline"].keys() == jrl.Roofline(
            1, 1, 1, 1).to_dict().keys()
        full = rec["full"]
        assert full["flops"] > 0 and full["bytes"] > 0
        assert full["memory"]["argument_bytes_per_dev"] > 0
        if SHAPE_CASES[shape].kind == "train":
            assert full["memory"]["saved_bytes_per_dev"] > 0
            assert full["memory"]["argument_bytes_by_kind"]["opt_state"] > 0


# (arch, shape): full configs on the production (16, 16) mesh.  Not a
# prefill cell: its model FLOPs (2 N D) count the head at every position,
# and prefill computes the logits of the last one only (gemma-7b's
# prefill_32k: 1.068)
USEFUL = [("llama3.2-1b", "train_4k"), ("gemma-7b", "train_4k"),
          ("zamba2-2.7b", "decode_32k")]


@pytest.mark.parametrize("arch,shape", USEFUL)
def test_useful_flops_ratio_of_full_cells(arch, shape, tmp_path):
    rec = dryrun.run_cell(arch, shape, "single", tmp_path, device="cpu")
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["n_devices"] == 256
    ratio = rec["roofline"]["useful_flops_ratio"]
    assert 0 < ratio <= 1.05, ratio
    assert rec["full"]["collective_counts"]  # a 256-rank step communicates
