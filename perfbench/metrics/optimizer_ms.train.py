"""The optimizer's device time a step, in ms: the median over the
window's steps of the interval between the CUDA events that open and
close their ``train.optimizer`` span (AdamW's update).  Read from the
program's span recorder ``"train"``.  The window's steps are the
``obs["steps"]`` that end ``obs["profile_steps"]`` before the highest:
the window's ``Trainer.train`` call, not the profiled steps after it.
A recorder that holds another number of them is another run's, and is
not read."""
import statistics


def window_steps(obs: dict):
    """The recorder and the window's step numbers, or None."""
    try:
        from repro_torch.core.tracing import recorder
    except ImportError:         # a program without span recording
        return None
    spans = recorder("train")
    if spans is None:
        return None
    steps = [r.step for r in list(spans.records) if r.name == "train.step"]
    if not steps:
        return None
    last = max(steps) - obs.get("profile_steps", 0)
    window = range(last - obs["steps"] + 1, last + 1)
    if sum(s in window for s in steps) != obs["steps"]:
        return None
    return spans, window


def read(obs: dict):
    found = window_steps(obs)
    if found is None:
        return None
    spans, steps = found
    dev = [r.device_s for r in list(spans.records)
           if r.name == "train.optimizer" and r.step in steps]
    dev = [d for d in dev if d is not None]
    if not dev:
        return None
    return 1e3 * statistics.median(dev)
