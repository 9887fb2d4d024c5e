"""The host time to enqueue one decode step, in ms: the median over the
window's decode tasks of their ``serve.model`` span (``decode_step``
and the argmax, launched on the pool's thread).  Read from the
program's span recorder ``"serve"`` (window as in
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
    decode = {r.sid for r in recs if r.name == "serve.task"
              and (r.attrs or {}).get("kind") == "decode"}
    ms = [r.dur_ns / 1e6 for r in recs
          if r.name == "serve.model" and r.parent in decode]
    if not ms:
        return None
    return statistics.median(ms)
