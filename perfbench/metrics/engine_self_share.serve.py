"""The serving loop's own time over the window, in %: the self time of
the window's ``serve.step`` spans (each one's duration minus the part
its child spans cover: admissions, the decode call, the read-back) over
the window's wall time.  That is the loop's token bookkeeping, input
building and step set-up.  Read from the program's span recorder
``"serve"`` (window as in ``call_overhead_us.serve``)."""
from perfbench import devtrace


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
    steps = [r for r in recs if r.name == "serve.step"]
    if not steps:
        return None
    kids: dict = {}
    for r in recs:
        kids.setdefault(r.parent, []).append((r.t0_ns, r.t1_ns))
    own = sum(r.dur_ns - _covered(kids.get(r.sid, ())) for r in steps)
    return 100.0 * own / (obs["window_s"] * 1e9)


def _covered(intervals) -> int:
    """Length of the union of (start, end) intervals."""
    return sum(e - s for s, e in devtrace.merge(list(intervals)))
