"""The runtime's cost of a call as the engine's loop pays it, in us: the
median over the window's ``serve.call`` spans of the call's wall time
minus that of its ``serve.task`` (the task function on the pool's
thread).  Read from the program's span recorder ``"serve"``; the window
is the ``window_s`` seconds before the recorder was closed, which the
runner does as the window closes, of a recorder built before the window
(one built later belongs to another run)."""
import statistics


def window(obs: dict):
    """The spans of the program's recorder ``"serve"`` that lie in the
    window (:meth:`Spans.window`), or None."""
    try:
        from repro_torch.core.tracing import recorder
    except ImportError:         # a program without span recording
        return None
    spans = recorder("serve")
    return spans.window(obs["window_s"]) if spans is not None else None


def read(obs: dict):
    recs = window(obs)
    if not recs:
        return None
    task = {r.parent: r for r in recs if r.name == "serve.task"}
    cost = [r.dur_ns - task[r.sid].dur_ns for r in recs
            if r.name == "serve.call" and r.sid in task]
    if not cost:
        return None
    return statistics.median(cost) / 1e3
