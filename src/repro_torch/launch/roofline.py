"""Roofline accounting for the dry-run (counterpart of
:mod:`repro.launch.roofline`), with an H100 SXM in place of the TPU.

Hardware model (per card; a model, not a measurement):
    peak bf16 dense compute  989e12 FLOP/s   H100 SXM datasheet
    HBM3 bandwidth           3.35e12 B/s     H100 SXM datasheet
    collective link          50e9 B/s        assumed: one 400 Gb/s NDR
                                             InfiniBand NIC a card
The datasheet's NVLink figure, 900 GB/s a card (450e9 B/s each way), holds
only inside an 8-card node.  A 16-rank mesh axis spans two nodes, and a
ring runs at its slowest link, so one link rate, the network's, stands for
every axis (``LINK_BW``; ``NVLINK_BW`` is kept for the comparison).

Terms (per-device quantities, from the local shards of the step):
    compute    = flops_per_device / PEAK_FLOPS
    memory     = bytes_per_device / HBM_BW
    collective = collective_wire_bytes_per_device / LINK_BW

Collective wire bytes use JAX's ring-algorithm cost factors over the op's
group size n (``result`` is the op's output, ``size`` its input):
    all-gather      (n-1)/n * result
    all-reduce      2 (n-1)/n * size
    reduce-scatter  (n-1)   * result        (result is the scattered shard)
    all-to-all      (n-1)/n * size
    collective-permute  1   * size
The dry-run records each collective that DTensor issues (PyTorch's
functional collectives: op, tensor bytes, group size) into
:class:`CollectiveStats` under these names.
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12      # bf16 dense FLOP/s, H100 SXM datasheet
HBM_BW = 3.35e12         # B/s, H100 SXM datasheet
NVLINK_BW = 450e9        # B/s each way, H100 SXM datasheet (900 GB/s)
LINK_BW = 50e9           # B/s, assumed 400 Gb/s NDR InfiniBand a card


def ring_bytes(op: str, nbytes: float, n: int) -> float:
    """Wire bytes a device sends for one collective ``op`` over ``n``
    ranks; ``nbytes`` is the result's bytes for all-gather and
    reduce-scatter, the operand's otherwise."""
    if n <= 1:
        return 0.0
    if op == "all-gather":
        return nbytes * (n - 1) / n
    if op == "all-reduce":
        return nbytes * 2 * (n - 1) / n
    if op == "reduce-scatter":
        return nbytes * (n - 1)
    if op == "all-to-all":
        return nbytes * (n - 1) / n
    return float(nbytes)  # collective-permute, broadcast


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float = 0.0
    counts: dict = dataclasses.field(default_factory=dict)
    bytes_by_op: dict = dataclasses.field(default_factory=dict)

    def add(self, op: str, b: float) -> None:
        self.counts[op] = self.counts.get(op, 0) + 1
        self.bytes_by_op[op] = self.bytes_by_op.get(op, 0.0) + b
        self.wire_bytes += b

    def record(self, op: str, nbytes: float, n: int) -> None:
        """Add one collective of ``op`` over ``n`` ranks (none if n = 1,
        as JAX's parser skips a group of one)."""
        if n > 1:
            self.add(op, ring_bytes(op, nbytes, n))


@dataclasses.dataclass
class Roofline:
    flops: float              # per device
    bytes_accessed: float     # per device
    wire_bytes: float         # per device
    model_flops: float        # analytic useful flops, per device

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.wire_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """The largest term: the step time if the others overlap it."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved if the dominant term
        sets step time: (model_flops/PEAK) / max-term."""
        t = self.step_time
        return (self.model_flops / PEAK_FLOPS) / t if t else 0.0

    def to_dict(self) -> dict:
        return {
            "flops_per_dev": self.flops,
            "bytes_per_dev": self.bytes_accessed,
            "wire_bytes_per_dev": self.wire_bytes,
            "model_flops_per_dev": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(param_count_active: int, tokens: int, kind: str) -> float:
    """6·N·D for training (fwd+bwd), 2·N·D for inference forward."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * param_count_active * tokens


def attn_model_flops(cfg, case) -> float:
    """Useful attention FLOPs not covered by 6·N·D (scores + AV matmuls),
    approximated per mixer family, as the JAX package counts them."""
    b = case.global_batch
    s = 1 if case.kind == "decode" else case.seq_len
    t_ctx = case.seq_len
    mult = 3.0 if case.kind == "train" else 1.0
    total = 0.0
    for g in cfg.groups:
        for spec in g.pattern:
            if spec.kind in ("attn", "mla", "cross_attn"):
                h = cfg.num_heads
                if spec.kind == "mla":
                    m = cfg.mla
                    dd = m.nope_head_dim + m.rope_head_dim + m.v_head_dim
                else:
                    dd = 2 * cfg.head_dim
                if spec.kind == "cross_attn":
                    t_avg = cfg.num_image_tokens
                elif case.kind == "decode":
                    t_avg = t_ctx
                elif spec.window:
                    t_avg = min(spec.window, t_ctx)
                else:
                    t_avg = t_ctx / 2
                total += 2.0 * b * h * dd * s * t_avg * g.repeat * mult
            elif spec.kind == "mlstm" and case.kind != "decode":
                d_inner = int(cfg.xlstm.proj_factor * cfg.d_model)
                hd = d_inner // cfg.num_heads
                total += (4.0 * b * cfg.num_heads * hd * s
                          * cfg.xlstm.chunk / 2 * g.repeat * mult)
            elif spec.kind == "mamba2" and case.kind != "decode":
                mc = cfg.mamba
                d_inner = mc.expand * cfg.d_model
                nh = d_inner // mc.head_dim
                total += (2.0 * b * s * mc.chunk / 2
                          * (nh * mc.head_dim + 2 * mc.d_state)
                          * g.repeat * mult)
    return total
