"""The time an engine thread is blocked on the card over the window, in
%: the union of the window's ``serve.h2d`` spans (host inputs copied to
the device on the pool's thread, which waits for the stream) and
``serve.readback`` spans (the decode step's tokens read back on the
loop thread) over the window's wall time.  Read from the program's span
recorder ``"serve"`` (window as in ``call_overhead_us.serve``)."""
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
    waits = [(r.t0_ns, r.t1_ns) for r in recs
             if r.name in ("serve.h2d", "serve.readback")]
    if not waits:
        return None
    blocked = sum(e - s for s, e in devtrace.merge(waits))
    return 100.0 * blocked / (obs["window_s"] * 1e9)
