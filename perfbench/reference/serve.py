"""The reference side of a served model's check: logits of whole
sequences, and the gap by which a served token's logit lies below the
reference's best.

Sequences run layer by layer: each layer's weights are cast to fp32 once
and applied to every sequence before the next layer, so the reference
holds one layer in fp32 beside the benchmark's weights.
"""
from __future__ import annotations

import torch

from perfbench.reference import lm


@torch.no_grad()
def logits_at(params: dict, m: dict, seqs: list, starts: list,
              ops: lm.Ops) -> list:
    """For each token sequence (1-D int tensors on the weights' device),
    the fp32 logits (n, V) of its positions ``start ..`` its end."""
    xs = [lm.embed(params, t[None]) for t in seqs]
    for spec, p in lm.layers(params, m):
        xs = [lm.layer(p, spec, m, x, ops) for x in xs]
        del p
    head = lm.head_matrix(params)
    return [ops.mm(lm.final_norm(params, m, x[0, s:]), head)
            for x, s in zip(xs, starts)]


def served_sequences(samples: list, device) -> tuple[list, list]:
    """(sequences, starts) for served requests (prompt, tokens): the
    prompt and every served token but the last; token i was chosen at
    position ``len(prompt) - 1 + i``."""
    seqs, starts = [], []
    for prompt, out in samples:
        seq = list(prompt) + list(out[:-1])
        seqs.append(torch.tensor(seq, dtype=torch.long, device=device))
        starts.append(len(prompt) - 1)
    return seqs, starts


def widest_gap(ref_logits: list, tokens: list) -> float:
    """The widest gap, over every served token, between the reference's
    best logit and the served token's, at the position it was served."""
    worst = 0.0
    for lg, out in zip(ref_logits, tokens):
        idx = torch.as_tensor(list(out), device=lg.device)
        gap = lg.amax(-1) - lg.gather(-1, idx[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
    return worst


def control_gap(ref_logits: list, ctrl_logits: list) -> float:
    """:func:`widest_gap` of the tokens that another forward (the control)
    puts first at each position."""
    return widest_gap(ref_logits, [c.argmax(-1).tolist()
                                   for c in ctrl_logits])
