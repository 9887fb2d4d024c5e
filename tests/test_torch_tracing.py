"""The port's copy of the tracing module (``repro_torch.core.tracing``)
against ``repro.core.tracing`` (tests/test_tracing.py).

The synthetic event streams of tests/test_tracing.py (a worker clock
1000 s ahead of the server's, timing frames out of order, a worker lost
mid-span and its task resubmitted, a truncated stream) go through both
modules and must give equal offsets, spans, attribution, critical path,
reconciliation, Chrome trace and reports; the port's module must also
pass the reference's own assertions on them.  Then the port's thread
runtime records a trace (a log file, a rotated log chain, the live ring
through ``Cluster.trace_analysis()``): every span complete with all six
segments, every reconciliation check ok, and both modules reading the
recorded events alike.  No assertion reads the host clock."""
import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro.analysis.trace import ConformanceSink, run_trace  # noqa: E402
from repro.core import benchgraphs  # noqa: E402
from repro.core import tracing as jtracing  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import tracing as ttracing  # noqa: E402
from repro_torch.core.client import Cluster  # noqa: E402
from repro_torch.core.events import EventBus, JsonlEventLog  # noqa: E402

MODULES = [jtracing, ttracing]


def _ev(seq, t, type_, **f):
    return {"v": 1, "seq": seq, "t": t, "type": type_, **f}


def _synthetic_stream(offset=1000.0, lost=False, shuffle_timing=False):
    """tests/test_tracing.py::_synthetic_stream: two tasks on one worker
    whose clock reads ``offset`` seconds ahead of the server's; transport
    delay 1 ms on the first dispatch (the min pair), 3 ms on the
    second."""
    evs = [
        _ev(0, 0.0, "stream-open", wall=1.0, pid=1),
        _ev(1, 0.005, "epoch-open", eid=0, n_tasks=2, lo=0, hi=2,
            t_submit=0.001),
        _ev(2, 0.010, "task-queued", tid=0, wid=0, deps=[]),
        _ev(3, 0.012, "task-dispatched", tid=0, wid=0),
        _ev(4, 0.020, "task-queued", tid=1, wid=0, deps=[0]),
        _ev(5, 0.022, "task-dispatched", tid=1, wid=0),
    ]
    timing = [
        _ev(6, 0.060, "task-timing", tid=0, wid=0,
            recv=offset + 0.013, start=offset + 0.014,
            end=offset + 0.050, fetch=0.002),
        _ev(7, 0.090, "task-timing", tid=1, wid=0,
            recv=offset + 0.025, start=offset + 0.052,
            end=offset + 0.080, fetch=0.0),
    ]
    finishes = [
        _ev(8, 0.062, "task-finished", tid=0, wid=0),
        _ev(9, 0.092, "task-finished", tid=1, wid=0),
    ]
    if shuffle_timing:
        evs += [finishes[0], finishes[1], timing[1], timing[0]]
    else:
        evs += [timing[0], finishes[0], timing[1], finishes[1]]
    if lost:
        evs = evs[:6] + [timing[0], finishes[0],
                         _ev(9, 0.070, "worker-lost", wid=0, n_lost=1)]
    return evs


def _resubmitted():
    """The lost stream, then task 1 completed on worker 1."""
    return _synthetic_stream(lost=True) + [
        _ev(10, 0.080, "task-queued", tid=1, wid=1, deps=[0]),
        _ev(11, 0.081, "task-dispatched", tid=1, wid=1),
        _ev(12, 0.095, "task-finished", tid=1, wid=1),
    ]


STREAMS = {
    "aligned": lambda: _synthetic_stream(1000.0),
    "no-offset": lambda: _synthetic_stream(0.0),
    "shuffled-timing": lambda: _synthetic_stream(1000.0,
                                                 shuffle_timing=True),
    "lost-worker": lambda: _synthetic_stream(1000.0, lost=True),
    "resubmitted": _resubmitted,
    "partial": lambda: _synthetic_stream(1000.0)[4:],
    "empty": lambda: [],
}


def _views(mod, evs, stats=None, makespan=None):
    """Everything ``mod`` derives from ``evs``, as plain data."""
    ta = mod.TraceAnalysis.from_events(evs)
    checks = ta.reconcile(stats, makespan=makespan)
    return {
        "offsets": mod.worker_offsets(evs),
        "spans": [dataclasses.asdict(s) for s in mod.build_spans(evs)],
        "segments": [s.segments() for s in ta.spans],
        "exec": [(s.exec_s, s.end_to_end) for s in ta.spans],
        "attribution": ta.attribution(),
        "critical_path": ta.critical_path(),
        "reconcile": checks,
        "chrome": ta.to_chrome_trace(),
        "report": mod.format_attribution(ta),
        "reconciliation": mod.format_reconciliation(checks),
        "n_workers": ta.n_workers, "n_lost": ta.n_lost,
        "makespan": ta.makespan,
    }


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_synthetic_stream_gives_equal_results(stream):
    evs = STREAMS[stream]()
    want = _views(jtracing, evs)
    got = _views(ttracing, evs)
    assert got == want
    assert ttracing.SEGMENTS == jtracing.SEGMENTS
    assert (ttracing.REL_TOL, ttracing.ABS_TOL) == \
        (jtracing.REL_TOL, jtracing.ABS_TOL)


@pytest.mark.parametrize("mod", MODULES, ids=["jax", "port"])
def test_min_delay_offset_estimation(mod):
    offs = mod.worker_offsets(_synthetic_stream(offset=1000.0))
    assert offs == {0: pytest.approx(1000.001)}


def test_aligned_spans_and_segments():
    spans = {s.tid: s for s in ttracing.build_spans(
        _synthetic_stream(1000.0))}
    s0 = spans[0]
    assert s0.t_dispatched - 1e-9 <= s0.t_recv <= s0.t_start \
        <= s0.t_end <= s0.t_observed + 1e-9
    seg = s0.segments()
    assert seg["submit->ingest"] == pytest.approx(0.004)
    assert seg["ingest->schedulable"] == pytest.approx(0.005)
    assert seg["schedulable->dispatched"] == pytest.approx(0.002)
    assert seg["started->finished"] == pytest.approx(0.036)
    assert s0.exec_s == pytest.approx(0.034)
    assert spans[1].segments()["dispatched->started"] == \
        pytest.approx(0.030 - 0.001, abs=1e-6)
    assert spans[1].deps == (0,)


def test_out_of_order_timing_arrival():
    a = ttracing.build_spans(_synthetic_stream(1000.0, shuffle_timing=True))
    b = ttracing.build_spans(_synthetic_stream(1000.0))
    for sa, sb in zip(a, b):
        assert sa.segments() == sb.segments()
        assert sa.status == sb.status == "ok"


def test_lost_worker_closes_span_as_lost():
    evs = _synthetic_stream(1000.0, lost=True)
    spans = {s.tid: s for s in ttracing.build_spans(evs)}
    assert spans[0].status == "ok"
    assert spans[1].status == "lost"
    assert spans[1].t_observed == pytest.approx(0.070)
    ta = ttracing.TraceAnalysis.from_events(evs)
    assert ta.n_lost == 1
    assert ta.attribution()["n_ok"] == 1
    assert not any(c["ok"] is False for c in ta.reconcile())
    s1b = {s.tid: s for s in ttracing.build_spans(_resubmitted())}[1]
    assert s1b.status == "ok" and s1b.wid == 1


def test_span_tolerates_partial_stream():
    for s in ttracing.build_spans(_synthetic_stream(1000.0)[4:]):
        assert all(v >= 0 for v in s.segments().values())
    assert ttracing.TraceAnalysis.from_events([]).attribution()[
        "n_spans"] == 0
    assert ttracing.build_spans([]) == []


def test_task_span_defaults():
    s = ttracing.TaskSpan(tid=7)
    assert s.segments() == {}
    assert s.exec_s == 0.0 and s.end_to_end is None


# ---------------------------------------------------------------------------
# the port's thread runtime, traced
# ---------------------------------------------------------------------------

def _port_graph(g):
    """The JAX benchmark graph ``g`` as the port's TaskGraph (the same
    tids, inputs, durations and sizes; no callables)."""
    return tcore.TaskGraph([tcore.Task(t.tid, tuple(t.inputs), t.duration,
                                       t.output_size) for t in g.tasks],
                           name=g.name)


def _trace(tmp_path, graph=None, **kw):
    log = os.path.join(str(tmp_path), "tr-port.jsonl")
    g = graph if graph is not None else benchgraphs.merge(40)
    r = tcore.run_graph(_port_graph(g), server="rsds", runtime="thread",
                        n_workers=3, simulate_durations=False, events=log,
                        tracing=True, timeout=60.0, **kw)
    assert not r.timed_out
    return r, log


def _assert_reconciles(ta, r):
    checks = ta.reconcile(r.stats, makespan=r.makespan)
    assert not [c for c in checks if c["ok"] is False], \
        ttracing.format_reconciliation(checks)
    # the stats carry the references of the timing and dispatch checks
    assert {"timing-count", "dispatch-floor"} <= {c["check"] for c in checks
                                                  if c["ok"]}


@pytest.mark.parametrize("server", ["rsds", "dask"])
def test_record_attribute_reconcile(tmp_path, server):
    """tests/test_tracing.py::test_record_attribute_reconcile on the
    port's thread runtime, both servers: every task yields a complete
    span, and the run reconciles against its own meters."""
    log = os.path.join(str(tmp_path), f"tr-{server}.jsonl")
    r = tcore.run_graph(_port_graph(benchgraphs.merge(40)), server=server,
                        runtime="thread", n_workers=3,
                        simulate_durations=False, events=log, tracing=True,
                        timeout=60.0)
    assert not r.timed_out
    ta = ttracing.TraceAnalysis.from_jsonl(log)
    assert r.stats["n_timing"] == len(ta.spans) == 41
    for s in ta.spans:
        assert s.status == "ok"
        seg = s.segments()
        assert set(seg) == set(ttracing.SEGMENTS), (s.tid, seg)
        assert all(v >= 0 for v in seg.values())
        assert s.eid == 0
    a = ta.attribution()
    assert a["n_ok"] == 41 and a["n_lost"] == 0
    assert a["worker_seconds"] > 0
    _assert_reconciles(ta, r)
    cp = ta.critical_path()
    assert len(cp["path"]) >= 2 and cp["path"][-1] == 40
    assert cp["length_s"] >= cp["exec_s"]


def test_both_modules_read_the_port_trace_alike(tmp_path):
    """The events the port's runtime recorded give the same views through
    the reference's module as through the port's."""
    from repro_torch.core.events import load_jsonl
    r, log = _trace(tmp_path)
    evs = load_jsonl(log)
    assert _views(ttracing, evs, r.stats, r.makespan) == \
        _views(jtracing, evs, r.stats, r.makespan)


def test_rotated_log_chain(tmp_path):
    """A rotated multi-file log stitches back oldest-first, its spans
    stay complete, and the offline protocol checker is clean over it."""
    path = os.path.join(str(tmp_path), "rot.jsonl")
    bus = EventBus()
    bus.add_sink(JsonlEventLog(path, max_bytes=2048, keep=16,
                               flush_every=1))
    r = tcore.run_graph(_port_graph(benchgraphs.merge(30)), server="rsds",
                        runtime="thread", n_workers=3,
                        simulate_durations=False, events=bus, tracing=True,
                        timeout=60.0)
    assert not r.timed_out
    assert os.path.exists(f"{path}.1"), "log never rotated"
    ta = ttracing.TraceAnalysis.from_jsonl(path)
    assert len(ta.spans) == 31
    assert all(s.status == "ok" for s in ta.spans)
    _assert_reconciles(ta, r)
    findings, _ = run_trace([path])
    assert findings == [], findings


def test_cluster_trace_analysis(tmp_path):
    """Cluster.trace_analysis() reads the live ring, over two epochs of a
    warm pool whose bus also feeds the protocol checker; without events=
    it refuses."""
    bus = EventBus()
    sink = ConformanceSink(path="<repro_torch.core>")
    bus.add_sink(sink)
    with Cluster(server="rsds", runtime="thread", n_workers=2,
                 simulate_durations=False, events=bus, tracing=True,
                 name="tr-live") as c:
        for n in (20, 10):
            c.client.submit_graph(_port_graph(benchgraphs.merge(n))
                                  ).result(30)
        ta = c.trace_analysis()
        stats = c.runtime.run_stats()
    assert len(ta.spans) == 21 + 11
    assert {s.eid for s in ta.spans} == {0, 1}
    assert all(set(s.segments()) == set(ttracing.SEGMENTS)
               for s in ta.spans)
    checks = ta.reconcile(stats)
    assert not [c for c in checks if c["ok"] is False], \
        ttracing.format_reconciliation(checks)
    assert ttracing.format_attribution(ta).startswith("trace attribution")
    assert not sink.findings and sink.n_internal_errors == 0
    stub = type("NoEvents", (), {"events": None})()
    with pytest.raises(RuntimeError):
        Cluster.trace_analysis(stub)


def test_chrome_trace_shape(tmp_path):
    """One lane per worker plus a server lane; execution slices within a
    lane never overlap; epoch slices ride the server lane; the file is
    plain JSON."""
    _, log = _trace(tmp_path)
    ta = ttracing.TraceAnalysis.from_jsonl(log)
    ct = ta.to_chrome_trace()
    names = {e["args"]["name"] for e in ct["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert "server" in names
    assert {n for n in names if n.startswith("worker ")}
    by_lane: dict = {}
    for e in ct["traceEvents"]:
        if e["ph"] == "X" and e.get("cat") == "exec":
            assert e["dur"] >= 0 and e["ts"] >= 0
            by_lane.setdefault(e["tid"], []).append((e["ts"], e["dur"]))
    assert by_lane
    for slices in by_lane.values():
        slices.sort()
        for (t0, d0), (t1, _) in zip(slices, slices[1:]):
            assert t0 + d0 <= t1 + 1.0
    assert any(e.get("cat") == "epoch" for e in ct["traceEvents"])
    out = os.path.join(str(tmp_path), "out.trace.json")
    ta.write_chrome_trace(out)
    with open(out, encoding="utf-8") as fh:
        assert json.load(fh)["traceEvents"]


def test_attribution_report_format(tmp_path):
    r, log = _trace(tmp_path)
    ta = ttracing.TraceAnalysis.from_jsonl(log)
    text = ttracing.format_attribution(ta)
    for name in ttracing.SEGMENTS:
        assert name in text
    assert "critical path" in text
    rep = ttracing.format_reconciliation(ta.reconcile(r.stats,
                                                      makespan=r.makespan))
    assert "0 failed" in rep


def _traced_pool(owner):
    """A CPU run of a ServingEngine (two requests) or a
    MicrobatchCoordinator (one step) of llama3.2-1b's smoke model, built
    with ``events=True, tracing=True``; returns its pool's trace and
    meters after the run, and the number of tasks it ran."""
    import numpy as np
    from repro_torch import configs as tconfigs
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models import model as tmodel
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.train.trainer import MicrobatchCoordinator
    cfg = tconfigs.get_config("llama3.2-1b", smoke=True)
    if owner == "engine":
        params = tmodel.init_params(torch.Generator().manual_seed(0), cfg,
                                    device="cpu")
        eng = ServingEngine(cfg, params, max_batch=2, max_len=64,
                            events=True, tracing=True, device="cpu")
        rng = np.random.default_rng(0)
        eng.start()
        reqs = [eng.submit(rng.integers(0, cfg.vocab_size, n),
                           max_new_tokens=3) for n in (5, 9)]
        try:
            assert all(r.done.wait(120) for r in reqs)
        finally:
            eng.stop()
        return (eng._cluster.trace_analysis(),
                eng._cluster.runtime.run_stats(),
                eng.n_prefills + eng.n_decode_steps)
    mc = MicrobatchCoordinator(cfg, n_executors=2, n_microbatches=4,
                               events=True, tracing=True, device="cpu")
    try:
        mc.train_step(SyntheticDataset(cfg, 4, 16).batch_at(0))
        return (mc._cluster.trace_analysis(),
                mc._cluster.runtime.run_stats(), 4 + 1)
    finally:
        mc.close()


@pytest.mark.parametrize("owner", ["engine", "coordinator"])
def test_engine_and_coordinator_hand_tracing_to_their_pool(owner):
    """``tracing=True`` on a ServingEngine or a MicrobatchCoordinator
    reaches the Cluster it builds: every task of the run (each prefill
    and decode step; each microbatch and the reduce) gives a span with
    all six segments, and the trace reconciles against the pool's
    meters."""
    ta, stats, n_tasks = _traced_pool(owner)
    assert len(ta.spans) == n_tasks
    assert all(s.status == "ok" and set(s.segments()) ==
               set(ttracing.SEGMENTS) for s in ta.spans)
    checks = ta.reconcile(stats)
    assert not [c for c in checks if c["ok"] is False], \
        ttracing.format_reconciliation(checks)


# ---------------------------------------------------------------------------
# program spans (repro_torch.core.tracing.Spans)
# ---------------------------------------------------------------------------

def test_spans_ring_is_bounded_and_totals_count_every_span():
    sp = ttracing.Spans("test-ring", capacity=4)
    for i in range(10):
        with sp.span("a" if i % 2 else "b", step=i):
            pass
    assert len(sp.records) == 4
    assert [r.step for r in sp.records] == [6, 7, 8, 9]
    tot = sp.totals()
    assert {k: v["n"] for k, v in tot.items()} == {"a": 5, "b": 5}
    assert all(v["s"] >= 0 for v in tot.values())
    assert ttracing.recorder("test-ring") is sp


def test_spans_nest_on_a_thread_and_link_across_threads():
    """Nested spans take the enclosing one as parent, with its rid and
    step; a span on another thread links by ``parent=`` and nests its
    own children there."""
    import threading
    sp = ttracing.Spans("test-links")
    seen = {}

    def worker(parent):
        with sp.span("task", parent=parent) as t:
            with sp.span("inner"):
                pass
        seen["task"] = t.sid

    with sp.span("outer", rid=3, step=5) as outer:
        with sp.span("child", k=1) as child:
            child.set(live=2)
        th = threading.Thread(target=worker, args=(outer.sid,),
                              name="pool")
        th.start()
        th.join(10)
    assert not th.is_alive()
    by = {r.name: r for r in sp.records}
    assert by["outer"].parent is None
    assert by["child"].parent == outer.sid
    assert (by["child"].rid, by["child"].step) == (3, 5)
    assert by["child"].attrs == {"k": 1, "live": 2}
    assert by["task"].parent == outer.sid and by["task"].thread == "pool"
    assert by["task"].rid is None
    assert by["inner"].parent == seen["task"]
    assert by["outer"].thread == threading.current_thread().name
    for r in sp.records:
        assert r.t1_ns >= r.t0_ns and r.device_s is None
    o = by["outer"]
    for name in ("child", "task", "inner"):
        assert o.t0_ns <= by[name].t0_ns <= by[name].t1_ns <= o.t1_ns


def test_disabled_spans_record_nothing():
    bus = EventBus()
    sp = ttracing.Spans("test-off", enabled=False, bus=bus)
    with sp.span("a", device=True) as a:
        a.set(x=1)
        with sp.span("b", parent=a.sid):
            pass
    sp.close()
    assert list(sp.records) == [] and sp.totals() == {}
    assert bus.counts["span"] == 0
    assert ttracing.recorder("test-off") is sp


def test_spans_publish_span_events_into_the_chrome_trace():
    """With a bus each closed span is one ``span`` event carrying every
    field the vocabulary declares, in the envelope's clock; the trace's
    Chrome export draws them in one lane per thread."""
    from repro_torch.core.events import EVENT_TYPES
    bus = EventBus()
    sp = ttracing.Spans("test-bus", bus=bus)
    with sp.span("outer", step=1):
        with sp.span("inner", kind="x"):
            pass
    evs = [e for e in bus.since(-1) if e["type"] == "span"]
    assert [e["name"] for e in evs] == ["inner", "outer"]
    for e, r in zip(evs, sp.records):
        assert set(EVENT_TYPES["span"]) <= set(e)
        assert (e["sid"], e["parent"], e["step"], e["attrs"]) == \
            (r.sid, r.parent, r.step, r.attrs)
        assert e["t0"] == r.t0_ns / 1e9 and e["t1"] <= e["t"]
    ta = ttracing.TraceAnalysis.from_events(bus.since(-1))
    ct = ta.to_chrome_trace()
    lanes = [e for e in ct["traceEvents"] if e["ph"] == "M"
             and e["args"]["name"].startswith("program ")]
    assert len(lanes) == 1
    slices = [e for e in ct["traceEvents"] if e.get("cat") == "span"]
    assert {e["name"] for e in slices} == {"inner", "outer"}
    assert all(e["tid"] == lanes[0]["tid"] and e["ts"] >= 0
               for e in slices)
    assert {e["args"]["step"] for e in slices} == {1}


def test_close_stamps_the_end_once():
    sp = ttracing.Spans("test-close")
    assert sp.t_closed_ns is None
    sp.close()
    t = sp.t_closed_ns
    sp.close()
    assert sp.t_closed_ns == t >= sp.t_open_ns


def test_window_keeps_the_spans_before_close_of_an_older_recorder():
    """``window(s)`` gives the closed spans inside the ``s`` seconds before
    ``close()``; an open recorder, or one built inside those seconds (it
    recorded another run), gives None."""
    ms = 1_000_000
    sp = ttracing.Spans("test-window")
    assert sp.window(0.1) is None
    sp.t_open_ns, sp.t_closed_ns = 0, 1000 * ms
    sp.records.extend(ttracing.SpanRecord(i, None, "s", "t", t0 * ms,
                                          t1 * ms)
                      for i, (t0, t1) in enumerate(
                          [(850, 860), (895, 905), (900, 950),
                           (990, 1000), (995, 1005)]))
    assert [r.sid for r in sp.window(0.1)] == [2, 3]
    sp.t_open_ns = 901 * ms
    assert sp.window(0.1) is None


def test_a_train_step_without_spans_registers_no_recorder():
    from repro_torch import configs as tconfigs
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import make_train_step
    before = dict(ttracing._RECORDERS)
    make_train_step(tconfigs.get_config("llama3.2-1b", smoke=True),
                    make_optimizer("adamw"))
    assert ttracing._RECORDERS == before


def _profiled_events(fn, **kw):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU], **kw) as prof:
        fn()
    return {e.name(): e for e in prof.profiler.kineto_results.events()}


def test_span_lands_on_the_profilers_clock():
    """A span opened on the profiling thread is a profiler range of the
    same name, and ``to_profiler_ns`` puts its ends within 100 us of the
    range's."""
    import time
    sp = ttracing.Spans("test-clock")

    def work():
        for i in range(3):
            with sp.span(f"clock-{i}"):
                time.sleep(0.002)

    got = _profiled_events(work)
    for r in sp.records:
        e = got[r.name]
        assert abs(e.start_ns() - sp.to_profiler_ns(r.t0_ns)) < 100_000
        assert abs(e.start_ns() + e.duration_ns()
                   - sp.to_profiler_ns(r.t1_ns)) < 100_000


def test_a_loop_thread_span_reaches_an_all_threads_profile():
    """Spans opened on another thread appear in a profile that captures
    every thread (where this PyTorch offers that)."""
    import threading
    import time
    make = torch._C._profiler._ExperimentalConfig
    try:
        cfg = make(profile_all_threads=True)
    except TypeError:
        pytest.skip("this PyTorch cannot profile every thread")
    sp = ttracing.Spans("test-threads")

    def loop():
        with sp.span("loop-span"):
            time.sleep(0.001)

    def work():
        th = threading.Thread(target=loop, name="loop")
        th.start()
        th.join(10)

    assert "loop-span" in _profiled_events(work, experimental_config=cfg)
    assert [r.thread for r in sp.records] == ["loop"]


def test_spans_from_many_threads_lose_no_count():
    """Threads closing spans of one name at once: the totals count every
    span and the ids are unique (a lost update would break either)."""
    import sys
    import threading
    sp = ttracing.Spans("test-stress", capacity=100_000)
    n_threads, n_spans = 16, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_spans):
                with sp.span("same"):
                    pass
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert sp.totals()["same"]["n"] == n_threads * n_spans
    assert len({r.sid for r in sp.records}) == n_threads * n_spans
    assert all(r.parent is None for r in sp.records)
