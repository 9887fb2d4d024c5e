"""The yardstick's frozen arithmetic: the H100's peaks, and the operations
and bytes of the model and of the kernels whose roofline share the
benchmark reports.

Peaks: NVIDIA's H100 SXM data sheet, dense bf16 tensor-core rate and HBM3
bandwidth, at the full 700 W power limit.  A kernel's roofline bound is
the larger of its operations over the peak rate and its bytes over the
peak bandwidth; its bytes count each input read once and each output
written once.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12    # bf16 dense, tensor cores
PEAK_BYTES = 3.35e12   # HBM3


def causal_pairs(s: int) -> int:
    """Live (query, key) pairs of causal attention over ``s`` tokens."""
    return s * (s + 1) // 2


def live_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """Live pairs of ``s`` queries at positions 0.. over ``t`` keys, under
    a causal mask and a window (0: none)."""
    if causal and not window and s <= t:
        return causal_pairs(s)
    total = 0
    for i in range(s):
        hi = min(i, t - 1) if causal else t - 1
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def attention_layers(model: dict) -> int:
    return sum(g["repeat"] * sum(1 for spec in g["pattern"]
                                 if spec.get("kind", "attn") == "attn")
               for g in model["groups"])


# --- the model: MFU_FORMULA of the port's chip_smoke, frozen here -----------

MFU_FORMULA = ("train: (6 N B S + 12 hd H B P) a step; serve: 2 N a "
               "prompt or generated token + 4 hd H a live causal pair; N "
               "the parameters (embeddings once), P the live pairs of every "
               "attention layer; over the window's seconds and 989e12")


def train_step_flops(n_params: int, model: dict, batch: int, seq: int) -> int:
    pairs = attention_layers(model) * causal_pairs(seq)
    return (6 * n_params * batch * seq
            + 12 * model["head_dim"] * model["num_heads"] * batch * pairs)


def prefill_flops(n_params: int, model: dict, tokens: int) -> int:
    """A prompt of ``tokens`` tokens, each attending causally."""
    return (2 * n_params * tokens + 4 * model["head_dim"] * model["num_heads"]
            * attention_layers(model) * causal_pairs(tokens))


def decode_flops(n_params: int, model: dict, position: int) -> int:
    """One generated token at ``position``: it attends to position + 1
    keys."""
    return (2 * n_params + 4 * model["head_dim"] * model["num_heads"]
            * attention_layers(model) * (position + 1))


# --- kernels -----------------------------------------------------------------

def flash_fwd_cost(b: int, s: int, t: int, h: int, kv: int, hd: int,
                   causal: bool, window: int, elem: int = 2
                   ) -> tuple[int, int]:
    """(operations, bytes) of one flash-attention forward: q k^T and p v
    over the live pairs; q, k, v read and o written once."""
    flops = 4 * b * h * hd * live_pairs(s, t, causal, window)
    nbytes = elem * (2 * b * s * h * hd + 2 * b * t * kv * hd)
    return flops, nbytes


def flash_bwd_cost(b: int, s: int, t: int, h: int, kv: int, hd: int,
                   causal: bool, window: int, elem: int = 2
                   ) -> tuple[int, int]:
    """(operations, bytes) of one flash-attention backward: q k^T again,
    dO v^T, P^T dO, dS k and dS^T q over the live pairs (2.5 times the
    forward's two products); q, k, v, o, dO and the log-sum-exp (fp32)
    read, dq, dk and dv written once."""
    flops = 10 * b * h * hd * live_pairs(s, t, causal, window)
    nbytes = (elem * (5 * b * s * h * hd + 4 * b * t * kv * hd)
              + 4 * b * h * s)
    return flops, nbytes


def bound_s(flops: int, nbytes: int) -> float:
    """The least time the chip could take: the larger of the two terms."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
