"""The flash-attention forward and backward kernels' share of their
roofline over the profiled steps, in %: the bound of each launch (the
larger of its operations over the peak rate and its bytes over the peak
bandwidth, from the shape counters' launches in those steps and
``perfbench.flops``) summed, over the device time of the ``flash_fwd``
and ``flash_bwd`` kernels."""
from perfbench import devtrace, flops


def read(obs: dict):
    tr = obs.get("trace")
    fwd, bwd = obs.get("sub_flash"), obs.get("sub_flash_bwd")
    if not tr or not fwd or not bwd:
        return None
    sec, _ = devtrace.kernel_seconds(tr["kernels"], "flash_fwd_kernel",
                                     "flash_bwd_")
    if sec <= 0:
        return None
    bound = sum(n * flops.bound_s(*cost(*shape))
                for shapes, cost in ((fwd, flops.flash_fwd_cost),
                                     (bwd, flops.flash_bwd_cost))
                for shape, n in shapes.items())
    return 100.0 * bound / sec
