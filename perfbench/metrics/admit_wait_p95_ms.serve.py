"""The time a request waited in the engine's inbox, in ms: the 95th
percentile (``statistics.quantiles``, inclusive) over the requests
admitted in the window of admission minus submission (the ``wait_s`` of
their ``serve.admit`` span, ``Request.admit_t - Request.submit_t``).
Read from the program's span recorder ``"serve"`` (window as in
``call_overhead_us.serve``)."""
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
    waits = [1e3 * r.attrs["wait_s"] for r in recs
             if r.name == "serve.admit" and "wait_s" in (r.attrs or {})]
    if not waits:
        return None
    if len(waits) == 1:
        return waits[0]
    return statistics.quantiles(waits, n=20, method="inclusive")[18]
