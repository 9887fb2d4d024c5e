"""The port's protocol checker (``repro_torch.analysis``: ``protocol``,
``trace``, ``explore``), live half, against the reference's.

The spec module equals the reference's constant for constant.  Every
hand-built stream of ``tests/test_protocol.py`` (one violation each, and
the clean ones with the documented races) goes through both
``TraceChecker`` s, which must give the same findings, key for key and line
for line.  Streams recorded from the port's thread runtime and process
runtime (both servers, p2p on, a worker killed) pass both checkers with
no finding.  The explorer runs the port's simulator and thread runtime
at the reference tests' parameters.  No assertion reads the host clock."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import protocol as jprotocol
from repro.analysis.trace import TraceChecker as JTraceChecker
from repro_torch.analysis import protocol
from repro_torch.analysis.explore import (Controller, explore_inproc,
                                          explore_sim, shrink)
from repro_torch.analysis.trace import (ConformanceSink, TraceChecker,
                                        load_trace, run_trace)

from torch_core_tasks import _slow_plus, fn_graph, fn_graph_want

REPO = Path(__file__).resolve().parents[1]


def mk(seq: int, type_: str, **payload) -> dict:
    ev = {"v": 1, "seq": seq, "t": float(seq), "type": type_}
    ev.update(payload)
    return ev


def stream(*events) -> list[dict]:
    out = [mk(0, "stream-open", wall=0.0, pid=1)]
    for i, (type_, payload) in enumerate(events, start=1):
        out.append(mk(i, type_, **payload))
    return out


def _findings(cls, events, path="<test>"):
    checker = cls(path=path)
    checker.check_many(events)
    return checker, [(f.rule, f.key, f.path, f.line, f.severity, f.message)
                     for f in checker.findings]


def both(events, path="<test>") -> list:
    """The two checkers' findings on ``events``, which must be equal."""
    tc, got = _findings(TraceChecker, events, path)
    jc, want = _findings(JTraceChecker, events, path)
    assert got == want
    assert (tc.n_events, tc.n_gaps, tc.strict) == \
        (jc.n_events, jc.n_gaps, jc.strict)
    return got


# ---------------------------------------------------------------------------
# the spec module
# ---------------------------------------------------------------------------

def test_protocol_constants_equal_the_reference():
    for name in ("EVENT_FIELDS", "TASK_EVENTS", "WORKER_EVENTS",
                 "EPOCH_EVENTS", "STATELESS_EVENTS", "TASK_STATES",
                 "WORKER_STATES", "TASK_TRANSITIONS", "WORKER_TRANSITIONS",
                 "INVARIANTS", "LEDGER_FIELDS", "SHARED_STORE_WID"):
        assert getattr(protocol, name) == getattr(jprotocol, name), name
    public = {n for n in vars(jprotocol) if n.isupper()}
    assert public == {n for n in vars(protocol) if n.isupper()}
    assert protocol.initial_task_state() == jprotocol.initial_task_state()
    assert protocol.initial_worker_state() == \
        jprotocol.initial_worker_state()
    assert TraceChecker.IMPLEMENTS == JTraceChecker.IMPLEMENTS


def test_spec_agrees_with_the_port_runtime_vocabulary():
    from repro_torch.core.events import EVENT_TYPES
    for typ, fields in protocol.EVENT_FIELDS.items():
        assert tuple(EVENT_TYPES[typ]) == tuple(fields), typ


# ---------------------------------------------------------------------------
# the reference's hand-built streams through both checkers
# ---------------------------------------------------------------------------

W0 = ("worker-join", {"wid": 0})
Q0 = ("task-queued", {"tid": 0, "wid": 0})
D0 = ("task-dispatched", {"tid": 0, "wid": 0})
F0 = ("task-finished", {"tid": 0, "wid": 0})
LOST0 = ("worker-lost", {"wid": 0, "n_lost": 0})


def _dup_seq():
    events = stream(W0, ("worker-join", {"wid": 1}))
    events[2]["seq"] = 1
    return events


def _windowed():
    return [mk(5, "task-finished", tid=9, wid=9),
            mk(6, "worker-lost", wid=3, n_lost=0),
            mk(7, "worker-lost", wid=3, n_lost=0)]


CLEAN_RACES = stream(
    W0, ("worker-join", {"wid": 1}),
    ("epoch-open", {"eid": 0, "n_tasks": 3, "lo": 0, "hi": 3}),
    Q0, D0, ("task-started", {"tid": 0, "wid": 0}), F0,
    ("task-queued", {"tid": 1, "wid": 1}),
    ("task-dispatched", {"tid": 1, "wid": 1}),
    ("task-steal", {"tid": 1, "wid": 0}),
    ("task-queued", {"tid": 1, "wid": 0}),
    ("task-dispatched", {"tid": 1, "wid": 0}),
    ("task-finished", {"tid": 1, "wid": 1}),
    ("task-finished", {"tid": 1, "wid": 0}),
    ("task-queued", {"tid": 2, "wid": 1}),
    ("task-dispatched", {"tid": 2, "wid": 1}),
    ("worker-lost", {"wid": 1, "n_lost": 1}),
    ("task-queued", {"tid": 2, "wid": 0}),
    ("task-dispatched", {"tid": 2, "wid": 0}),
    ("task-started", {"tid": 2, "wid": 0}),
    ("task-finished", {"tid": 2, "wid": 0}),
    ("epoch-close", {"eid": 0, "error": None}),
    ("release", {"n": 3, "tids": [0, 1, 2]}),
    ("compact", {"base": 3}))

IN_FLIGHT_FINISH = stream(
    W0, ("worker-join", {"wid": 1}), ("worker-join", {"wid": 2}),
    ("task-queued", {"tid": 0, "wid": 1}),
    ("task-dispatched", {"tid": 0, "wid": 1}),
    ("worker-lost", {"wid": 1, "n_lost": 1}),
    Q0, D0,
    ("task-finished", {"tid": 0, "wid": 1}),
    ("task-steal", {"tid": 0, "wid": 2}),
    ("task-queued", {"tid": 0, "wid": 2}),
    ("task-dispatched", {"tid": 0, "wid": 2}),
    ("task-started", {"tid": 0, "wid": 2}),
    ("task-finished", {"tid": 0, "wid": 2}))

# name -> (stream, the finding keys it must give)
STREAMS = {
    "double_finish": (stream(W0, Q0, D0, F0, F0), {"RA6:double-finish:0"}),
    "finish_without_dispatch": (stream(W0, Q0, F0),
                                {"RA6:finish-without-dispatch:0"}),
    "lost_worker_finish": (stream(W0, Q0, D0, F0, LOST0, F0),
                           {"RA6:lost-worker-finish:0"}),
    "start_without_dispatch": (
        stream(W0, Q0, ("task-started", {"tid": 0, "wid": 0})),
        {"RA6:start-without-dispatch:0"}),
    "dispatch_to_lost_worker": (stream(W0, LOST0, Q0),
                                {"RA6:dispatch-to-lost:0"}),
    "double_join": (stream(W0, W0), {"RA6:double-join:w0"}),
    "double_lost": (stream(W0, LOST0, LOST0), {"RA6:double-lost:w0"}),
    "illegal_task_transition": (
        stream(W0, ("task-steal", {"tid": 0, "wid": 0})),
        {"RA6:illegal-transition:task:new:task-steal"}),
    "out_of_order_seq": (_dup_seq(), {"RA7:out-of-order-seq:seq1"}),
    "missing_required_field": (stream(("task-queued", {"tid": 0})),
                               {"RA7:missing-field:task-queued:wid"}),
    "negative_ledger": (
        stream(W0, ("worker-pressure", {"wid": 0, "pressured": True,
                                        "mem_bytes": -5})),
        {"RA7:negative-ledger:worker-pressure:mem_bytes"}),
    "gather_after_release": (
        stream(W0, ("release", {"n": 1, "tids": [3]}),
               ("gather", {"wid": 0, "n": 1, "tids": [3]})),
        {"RA7:gather-after-release:3"}),
    "epoch_close_with_pending": (
        stream(W0, ("epoch-open", {"eid": 0, "n_tasks": 2, "lo": 0,
                                   "hi": 2}),
               Q0, D0, F0, ("epoch-close", {"eid": 0, "error": None})),
        {"RA7:epoch-close-with-pending:e0"}),
    "close_unopened_epoch": (
        stream(("epoch-close", {"eid": 7, "error": None})),
        {"RA7:close-unopened-epoch:e7"}),
    "double_epoch_close": (
        stream(("epoch-open", {"eid": 0, "n_tasks": 0, "lo": 0, "hi": 0}),
               ("epoch-close", {"eid": 0, "error": None}),
               ("epoch-close", {"eid": 0, "error": None})),
        {"RA7:double-epoch-close:e0"}),
    "spill_without_put": (stream(W0, ("spill", {"wid": 0, "nbytes": 10})),
                          {"RA7:spill-without-put:w0"}),
    "clean_lifecycle_with_races": (CLEAN_RACES, set()),
    "in_flight_finish_from_lost_worker": (IN_FLIGHT_FINISH, set()),
    "windowed_mode": (_windowed(), {"RA6:double-lost:w3"}),
    "concatenated_streams": (stream(W0) + stream(W0), set()),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_stream_findings_equal_the_reference(name):
    events, want = STREAMS[name]
    got = both(events)
    keys = {f[1] for f in got}
    if name == "out_of_order_seq":   # the reference test asks "in"
        assert want <= keys
    else:
        assert keys == want
    if name == "windowed_mode":
        checker, _ = _findings(TraceChecker, events)
        assert not checker.strict and checker.n_gaps == 1


def test_conformance_sink_over_the_port_bus():
    from repro_torch.core.events import EventBus
    bus = EventBus()
    sink = ConformanceSink(path="<t>")
    bus.add_sink(sink)
    bus.publish("worker-join", wid=0)
    bus.publish("worker-join", wid=0)
    bus.close()
    assert [f.key for f in sink.findings] == ["RA6:double-join:w0"]
    assert sink.n_internal_errors == 0 and sink.strict


# ---------------------------------------------------------------------------
# streams recorded from the port's runtime
# ---------------------------------------------------------------------------

def _recorded(server, runtime, graph, kill=None, **kw):
    """Run ``graph`` on the port's runtime with a bus; its events and the
    run's result.  ``kill``: SIGKILL that worker mid-graph."""
    from repro_torch import core as tcore
    from repro_torch.core.events import EventBus
    from repro_torch.ft import faults
    events = []
    bus = EventBus()
    bus.add_sink(events.append)
    if kill is None:
        r = tcore.run_graph(graph, server=server, runtime=runtime,
                            n_workers=3, events=bus, timeout=60.0, **kw)
        return events, r.results, r.timed_out
    with tcore.Cluster(server=server, runtime=runtime, n_workers=3,
                       events=bus, timeout=60.0, **kw) as c:
        futs = c.client.map(_slow_plus, list(range(6)))
        timer = faults.kill_worker_after(c.runtime, kill, 0.05)
        got = c.client.submit_graph(graph).result(60.0)
        assert [f.result(30.0) for f in futs] == list(range(1, 7))
        timer.join(10.0)
        assert kill in c.runtime.dead
    return events, got, False


RECORDED = [("rsds", "thread", False), ("dask", "thread", False),
            ("rsds", "process", False), ("dask", "process", False),
            ("rsds", "process", True), ("dask", "thread", True)]


@pytest.mark.parametrize("server,runtime,kill", RECORDED,
                         ids=[f"{s}-{r}{'-kill' if k else ''}"
                              for s, r, k in RECORDED])
def test_recorded_port_stream_is_clean_under_both(server, runtime, kill):
    from repro_torch import core as tcore
    kw = {"p2p": True} if runtime == "process" else {}
    events, results, timed_out = _recorded(
        server, runtime, fn_graph(tcore), kill=1 if kill else None, **kw)
    assert not timed_out
    assert {k: results[k] for k in fn_graph_want()} == fn_graph_want()
    assert events[0]["type"] == "stream-open" and len(events) > 20
    types = {e["type"] for e in events}
    assert {"task-dispatched", "task-finished", "epoch-close"} <= types
    if kill:
        assert "worker-lost" in types
    assert both(events, f"<{server} {runtime}>") == []


# ---------------------------------------------------------------------------
# the explorer on the port's simulator and thread runtime
# ---------------------------------------------------------------------------

def _small_graph():
    from repro_torch.core import benchgraphs
    return benchgraphs.merge(12)


def test_shrink_and_controller_as_the_reference():
    def still_fails(d):
        return len(d) >= 3 and d[2] == 2

    assert shrink([1, 2, 2, 1, 2, 0], still_fails) == [0, 0, 2]
    ctl = Controller(seed=7, width=3)
    taken = [ctl.choose(3) for _ in range(20)]
    from repro.analysis.explore import Controller as JController
    jctl = JController(seed=7, width=3)
    assert [jctl.choose(3) for _ in range(20)] == taken
    replay = Controller(decisions=taken, width=3)
    assert [replay.choose(3) for _ in range(20)] == taken
    assert replay.choose(3) == 0


@pytest.mark.parametrize("server", ["rsds", "dask"])
def test_explore_sim_is_clean_distinct_and_deterministic(server):
    r = explore_sim(server, graph=_small_graph(), n_workers=3,
                    n_schedules=20, seed=0, width=3, depth=2)
    assert r.ok, "\n".join(str(v) for v in r.violations)
    assert r.n_distinct >= 20
    a = explore_sim(server, graph=_small_graph(), n_workers=3,
                    n_schedules=6, seed=3, width=2, depth=1)
    b = explore_sim(server, graph=_small_graph(), n_workers=3,
                    n_schedules=6, seed=3, width=2, depth=1)
    assert (a.n_runs, a.n_distinct) == (b.n_runs, b.n_distinct)
    assert a.ok and b.ok


def test_explore_sim_with_failure_injection_is_clean():
    r = explore_sim("dask", graph=_small_graph(), n_workers=3,
                    n_schedules=8, seed=1, width=2, depth=1,
                    failures=((0.002, 0),))
    assert r.ok, "\n".join(str(v) for v in r.violations)


def test_explore_sim_shrinks_injected_violation_deterministically():
    def dup_first_finish(events, _i):
        out = list(events)
        for j, ev in enumerate(out):
            if ev.get("type") == "task-finished":
                out.insert(j + 1, dict(ev))
                break
        return out

    results = []
    for _ in range(2):
        r = explore_sim("rsds", graph=_small_graph(), n_workers=3,
                        n_schedules=1, seed=0, width=2, depth=1,
                        trace_mutator=dup_first_finish)
        assert not r.ok
        v = r.violations[0]
        assert any(k.startswith("RA7:out-of-order-seq")
                   or k.startswith("RA6:double-finish")
                   for k in v.finding_keys)
        results.append((v.decisions, tuple(v.finding_keys)))
    assert results[0] == results[1]
    assert results[0][0] == []


@pytest.mark.parametrize("server", ["rsds", "dask"])
def test_explore_inproc_port_runtime_is_clean(server):
    r = explore_inproc(server, graph=_small_graph(), n_schedules=2, seed=0,
                       n_workers=3)
    assert r.ok, "\n".join(str(v) for v in r.violations)
    assert r.n_runs == 2


# ---------------------------------------------------------------------------
# a recorded port trace through the offline pipeline
# ---------------------------------------------------------------------------

def _write_jsonl(path: Path, events) -> None:
    path.write_text("".join(json.dumps(e) + "\n" for e in events))


def test_recorded_port_trace_passes_offline_check(tmp_path):
    from repro_torch.core import run_graph
    log = tmp_path / "events.jsonl"
    r = run_graph(_small_graph(), server="rsds", runtime="thread",
                  n_workers=3, simulate_durations=False, timeout=60.0,
                  events=str(log))
    assert not r.timed_out
    assert len(load_trace(log)) > 20
    findings, n_suppressed = run_trace([log])
    assert findings == [] and n_suppressed == 0, [f.key for f in findings]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--trace", str(log),
         "--format", "json"], capture_output=True, text=True, cwd=REPO,
        timeout=120, env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert json.loads(proc.stdout)["n_findings"] == 0


def test_run_trace_on_violating_and_missing_logs(tmp_path):
    bad = tmp_path / "bad.jsonl"
    _write_jsonl(bad, stream(W0, F0))
    findings, _ = run_trace([bad])
    assert [f.key for f in findings] == ["RA6:finish-without-dispatch:0"]
    assert findings[0].line == 3
    findings, _ = run_trace([tmp_path / "gone.jsonl"])
    assert [f.key for f in findings] == ["RA0:no-trace:gone.jsonl"]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--trace", str(bad)],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert proc.returncode == 1 and "RA6:finish-without-dispatch" in \
        proc.stdout
