"""The window's model FLOPs over its seconds over the H100's bf16 peak, in
%.  FLOPs: 2 N a prompt token prefilled or a token generated in the
window, plus 4 hd H a live causal pair of each attention layer (the
benchmark's own lengths; ``perfbench.flops``)."""
from perfbench.flops import PEAK_FLOPS


def read(obs: dict):
    if not obs.get("model_flops"):
        return None
    return 100.0 * obs["model_flops"] / obs["window_s"] / PEAK_FLOPS
