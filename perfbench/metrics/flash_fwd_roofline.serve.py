"""The flash-attention forward's share of its roofline over the profiled
sub-window, in %: the bound of each launch (the larger of its operations
over the peak rate and its bytes over the peak bandwidth, from the shape
counter's launches in the sub-window and ``perfbench.flops``) summed, over
the device time of the ``flash_fwd_kernel`` kernels."""
from perfbench import devtrace, flops


def read(obs: dict):
    tr, shapes = obs.get("trace"), obs.get("sub_flash")
    if not tr or not shapes:
        return None
    sec, _ = devtrace.kernel_seconds(tr["kernels"], "flash_fwd_kernel")
    if sec <= 0:
        return None
    bound = sum(n * flops.bound_s(*flops.flash_fwd_cost(
        b, s, t, h, kv, hd, causal, window))
        for (b, s, t, h, kv, hd, causal, window), n in shapes.items())
    return 100.0 * bound / sec
