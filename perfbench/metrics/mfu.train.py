"""The window's model FLOPs over its seconds over the H100's bf16 peak, in
%: (6 N B S + 12 hd H B P) a step (``perfbench.flops.train_step_flops``)
times the window's steps."""
from perfbench.flops import PEAK_FLOPS


def read(obs: dict):
    if not obs.get("steps"):
        return None
    return 100.0 * obs["step_flops"] * obs["steps"] / obs["window_s"] \
        / PEAK_FLOPS
