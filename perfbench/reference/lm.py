"""Plain fp32 forward of the benchmark's language models.

The model is described by a configuration's ``model`` block (the fields
of the port's ``ModelConfig``: ``groups`` of layer ``pattern`` x
``repeat``, widths, ``mamba``) and its weights are a tree in the port's
layout: ``embed`` (V, D), ``groups[g]["slots"][i]`` (a slot's leaves
stacked over the group's repeats, or not stacked where the slot is
``shared``), ``final_norm``, and ``head`` (D, V) unless the embedding is
tied.  Every leaf is read in fp32; nothing here imports the program.

Each layer is pre-norm residual: RMSNorm ``x * rsqrt(mean(x^2) + eps) *
(1 + scale)``, then the mixer that the layer's ``kind`` names
(``mixers/<kind>.py``), then its MLP (``mlps/<mlp>.py``); a layer kind
is added as a file there.

:class:`Ops` holds the matrix products, so that the same forward runs in
another precision (``Ops("fp8")``, the control of the correctness check).
"""
from __future__ import annotations

import importlib

import torch

from perfbench.reference.tree import tree_map


def exact_fp32() -> None:
    """fp32 products in fp32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


FP8_MAX = 448.0   # largest finite float8_e4m3fn


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale a tensor (its absolute
    maximum to 448), back in fp32."""
    s = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` with both operands in fp8, and the two products of its
    backward with theirs (the gradient and the saved operands) in fp8."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return fp8(a) @ fp8(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        gq = fp8(g)
        ga = gq @ fp8(b).transpose(-1, -2)
        gb = fp8(a).transpose(-1, -2) @ gq
        # b broadcast over a's leading dims: sum them out
        while gb.dim() > b.dim():
            gb = gb.sum(0)
        return ga, gb


class Ops:
    """The matrix products of the reference: ``"fp32"`` (exact) or
    ``"fp8"`` (each operand rounded to float8 e4m3, accumulated in fp32)."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.precision = precision

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp32":
            return a @ b
        if b.dim() == 2:   # a weight: the activations' rows as one matrix
            lead = a.shape[:-1]
            return _Fp8Matmul.apply(a.reshape(-1, a.shape[-1]), b).reshape(
                *lead, b.shape[-1])
        return _Fp8Matmul.apply(a, b)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (
        1.0 + scale)


def part(family: str, kind: str):
    """The ``forward(p, m, x, ops)`` of ``<family>/<kind>.py`` here: a
    layer's mixer (``mixers``) or MLP (``mlps``) of that kind."""
    return importlib.import_module(
        f"perfbench.reference.{family}.{kind}").forward


def layer(p: dict, spec: dict, m: dict, x: torch.Tensor,
          ops: Ops) -> torch.Tensor:
    """One pre-norm residual layer (mixer, then MLP)."""
    eps = m["norm_eps"]
    kind = spec.get("kind", "attn")
    if kind != "none":
        x = x + part("mixers", kind)(p["mixer"], m, rmsnorm(
            x, p["pre_norm"]["scale"], eps), ops)
    mlp = spec.get("mlp", "glu")
    if mlp != "none":
        x = x + part("mlps", mlp)(p["mlp"], m, rmsnorm(
            x, p["pre_mlp_norm"]["scale"], eps), ops)
    return x


def layers(params: dict, m: dict):
    """Each layer in order: (spec, its weights as fp32 tensors).  A stacked
    slot gives a view of one repeat, cast to fp32 (the same tensor where it
    already is fp32, so that gradients reach the stacked leaf)."""
    for g, gspec in zip(params["groups"], m["groups"]):
        for r in range(gspec["repeat"]):
            for spec, slot in zip(gspec["pattern"], g["slots"]):
                one = slot if spec.get("shared") else tree_map(
                    lambda a: a[r], slot)
                yield spec, tree_map(lambda a: a.float(), one)


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens].float()


def head_matrix(params: dict) -> torch.Tensor:
    """(D, V) fp32: the untied head, or the embedding's transpose."""
    w = params["head"] if "head" in params else params["embed"].T
    return w.float()


def final_norm(params: dict, m: dict, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(x, params["final_norm"]["scale"].float(), m["norm_eps"])
