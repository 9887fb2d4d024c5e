"""Per-task distributed tracing over the structured event feed.

A copy of :mod:`repro.core.tracing` for the port.

This module turns a recorded (or live) event stream — the vocabulary
in :mod:`repro_torch.core.events`, plus the ``tracing=True``
additions (``task-timing``, ``epoch-open.t_submit``,
``task-queued.deps``) — into **spans**: one :class:`TaskSpan` per task,
decomposed into the six latency segments of the paper's overhead model:

====================  ==============================================
segment               what it prices
====================  ==============================================
submit->ingest        client submit call to server epoch ingest
ingest->schedulable   graph bookkeeping + dependency wait
schedulable->dispatch scheduler decision + dispatch/codec work
dispatch->started     transport + worker inbox queueing
started->finished     worker execution (p2p dep-fetch nested inside)
finished->observed    result frame transport + server fold
====================  ==============================================

Server-side boundaries come from event envelope timestamps (``t`` is
``time.perf_counter()`` on the server).  Worker-side boundaries
(``recv``/``start``/``end``/``fetch``) ride ``task-timing`` events in
the **worker's own** ``perf_counter_ns`` domain; process workers share
no clock origin with the server, so :func:`worker_offsets` aligns them
with a min-delay estimator before spans are assembled:

    ``offset(w) = min over w's tasks of (recv_w - t_dispatched_srv)``

i.e. the smallest observed dispatch->receive gap is attributed entirely
to clock skew, and every other gap's excess over it is genuine
transport + queueing delay.  The estimator is exact up to the minimum
one-way latency (which it under-reports as zero); for thread/inproc
runtimes both clocks are the same ``perf_counter`` so the offset
degenerates to the true minimum dispatch latency (microseconds).

A worker lost mid-task closes the affected spans with ``status="lost"``
at the ``worker-lost`` timestamp — they carry their server-side
segments but no worker timing, and are excluded from reconciliation
sums.  A task re-dispatched after a loss (or steal) keeps only its
*final* attempt: last ``task-queued``/``task-dispatched`` wins.

:class:`TraceAnalysis` layers the aggregate views on top: the
overhead-attribution table (:meth:`TraceAnalysis.attribution`,
rendered by :func:`format_attribution`), the critical path through the
task graph with its overhead-vs-compute split
(:meth:`TraceAnalysis.critical_path`), the reconciliation gate against
:class:`~repro_torch.core.client.RunResult` meters
(:meth:`TraceAnalysis.reconcile`, contract in ``docs/tracing.md``),
and Chrome-trace/Perfetto export (:meth:`TraceAnalysis.to_chrome_trace`).

Everything here is offline and allocation-free for the runtime: the
hot path only ever publishes events; span assembly happens in whoever
calls this module (tests, scripts, ``Cluster.trace_analysis()``).

Above the runtime, :class:`Spans` records the program's own spans (the
serving engine's loop and pool threads, the trainer's step) in memory,
on the same ``perf_counter`` clock, each also opened as a profiler range
of the same name; with a bus they ride the feed as ``span`` events, and
:meth:`TraceAnalysis.to_chrome_trace` draws them one lane per thread.
"""
from __future__ import annotations

import bisect
import collections
import itertools
import json
import threading
import time
from dataclasses import dataclass
from typing import Iterable, Mapping, Sequence

#: Segment keys, in pipeline order.  ``segments()`` and the attribution
#: table both iterate this tuple so every consumer agrees on naming.
SEGMENTS = (
    "submit->ingest",
    "ingest->schedulable",
    "schedulable->dispatched",
    "dispatched->started",
    "started->finished",
    "finished->observed",
)

#: Reconciliation tolerances (see docs/tracing.md): a check passes when
#: ``value <= reference * (1 + REL_TOL) + ABS_TOL`` (or the symmetric
#: band, per check).  Generous on purpose — segment boundaries are
#: timestamps taken on different threads, not a closed ledger.
REL_TOL = 0.25
ABS_TOL = 0.05


@dataclass
class TaskSpan:
    """One task's life, stitched from events.  All times are server-clock
    ``perf_counter`` seconds (worker-side boundaries already aligned);
    ``None`` marks a boundary the stream did not contain."""

    tid: int
    wid: int | None = None
    eid: int | None = None
    status: str = "ok"                  # "ok" | "lost" | "open"
    t_submit: float | None = None       # client-side submit stamp
    t_ingest: float | None = None       # epoch-open envelope t
    t_queued: float | None = None       # task became schedulable
    t_dispatched: float | None = None   # compute frame handed to wire
    t_recv: float | None = None         # worker popped the frame (aligned)
    t_start: float | None = None        # execution began (aligned)
    t_end: float | None = None          # execution ended (aligned)
    t_observed: float | None = None     # server folded the finish
    fetch_s: float = 0.0                # p2p dep-fetch nested in exec
    deps: tuple = ()

    def segments(self) -> dict:
        """Per-segment durations in seconds (absent boundaries skipped,
        clamped at zero so alignment jitter never yields negatives)."""
        bounds = (
            ("submit->ingest", self.t_submit, self.t_ingest),
            ("ingest->schedulable", self.t_ingest, self.t_queued),
            ("schedulable->dispatched", self.t_queued, self.t_dispatched),
            ("dispatched->started", self.t_dispatched, self.t_start),
            ("started->finished", self.t_start, self.t_end),
            ("finished->observed", self.t_end, self.t_observed),
        )
        return {name: max(0.0, b - a)
                for name, a, b in bounds if a is not None and b is not None}

    @property
    def exec_s(self) -> float:
        """Pure execution time: started->finished minus nested fetch."""
        seg = self.segments().get("started->finished")
        return max(0.0, seg - self.fetch_s) if seg is not None else 0.0

    @property
    def end_to_end(self) -> float | None:
        lo = next((t for t in (self.t_submit, self.t_ingest, self.t_queued,
                               self.t_dispatched) if t is not None), None)
        if lo is None or self.t_observed is None:
            return None
        return max(0.0, self.t_observed - lo)


def worker_offsets(events: Iterable[Mapping]) -> dict:
    """Per-worker clock offset (worker ns-domain seconds minus server
    seconds) via the min-delay estimator described in the module
    docstring.  Workers that never reported timing get no entry."""
    dispatched: dict = {}
    offsets: dict = {}
    for ev in events:
        k = ev.get("type")
        if k == "task-dispatched":
            dispatched[ev["tid"]] = (ev["wid"], ev["t"])
        elif k == "task-timing":
            hit = dispatched.get(ev["tid"])
            if hit is None or hit[0] != ev["wid"]:
                continue        # re-dispatched elsewhere since: skip pair
            gap = ev["recv"] - hit[1]
            wid = ev["wid"]
            if wid not in offsets or gap < offsets[wid]:
                offsets[wid] = gap
    return offsets


def build_spans(events: Sequence[Mapping]) -> list:
    """Assemble :class:`TaskSpan` objects from an event stream (oldest
    first, e.g. ``load_jsonl`` output or ``EventBus.since(-1)``).

    Tolerates out-of-order ``task-timing`` arrival (it is matched by
    tid, not position), missing boundaries (partial streams, ring
    drops), and worker loss (spans on the lost worker close as
    ``"lost"`` unless a later re-dispatch completed them)."""
    offsets = worker_offsets(events)
    spans: dict = {}
    epochs: list = []           # (lo, hi, eid, t_submit, t_ingest)
    lost_at: dict = {}

    def span(tid: int) -> TaskSpan:
        s = spans.get(tid)
        if s is None:
            s = spans[tid] = TaskSpan(tid=int(tid))
        return s

    for ev in events:
        k = ev.get("type")
        if k == "task-queued":
            s = span(ev["tid"])
            # last attempt wins: a resubmission resets the downstream
            # boundaries so a stale dispatch can't pollute the span
            s.t_queued, s.wid = ev["t"], ev["wid"]
            s.t_dispatched = s.t_recv = s.t_start = s.t_end = None
            s.status = "open"
            if "deps" in ev:
                s.deps = tuple(ev["deps"])
        elif k == "task-dispatched":
            s = span(ev["tid"])
            s.t_dispatched, s.wid = ev["t"], ev["wid"]
        elif k == "task-timing":
            s = span(ev["tid"])
            off = offsets.get(ev["wid"], 0.0)
            s.t_recv = ev["recv"] - off
            s.t_start = ev["start"] - off
            s.t_end = ev["end"] - off
            s.fetch_s = ev["fetch"]
        elif k == "task-finished":
            s = span(ev["tid"])
            s.t_observed, s.wid = ev["t"], ev["wid"]
            s.status = "ok"
        elif k == "epoch-open":
            epochs.append((ev["lo"], ev["hi"], ev["eid"],
                           ev.get("t_submit"), ev["t"]))
        elif k == "worker-lost":
            lost_at[ev["wid"]] = ev["t"]

    # epoch membership + submit/ingest boundaries by tid range
    epochs.sort()
    los = [e[0] for e in epochs]
    for tid, s in spans.items():
        i = bisect.bisect_right(los, tid) - 1
        if 0 <= i < len(epochs) and tid < epochs[i][1]:
            _, _, s.eid, s.t_submit, s.t_ingest = epochs[i]

    # close spans orphaned by a worker loss
    for s in spans.values():
        if s.status != "open" or s.t_observed is not None:
            continue
        t_lost = lost_at.get(s.wid)
        if t_lost is not None and s.t_dispatched is not None \
                and s.t_dispatched <= t_lost:
            s.status = "lost"
            s.t_observed = t_lost
    return [spans[tid] for tid in sorted(spans)]


class TraceAnalysis:
    """Aggregate views over a set of spans (see module docstring)."""

    def __init__(self, spans: Sequence[TaskSpan], offsets: Mapping,
                 events: Sequence[Mapping] = ()):
        self.spans = list(spans)
        self.offsets = dict(offsets)
        wids = {s.wid for s in self.spans if s.wid is not None}
        self.n_workers = len(wids)
        done = [s for s in self.spans if s.t_observed is not None]
        lo = [t for s in done
              for t in (s.t_submit, s.t_ingest, s.t_queued) if t is not None]
        self.t0 = min(lo) if lo else 0.0
        self.t1 = max((s.t_observed for s in done), default=self.t0)
        self.makespan = max(0.0, self.t1 - self.t0)
        self.n_lost = sum(1 for s in self.spans if s.status == "lost")
        self._events = events
        #: the program's ``span`` events (:class:`Spans` with a bus)
        self.program_spans = [e for e in events if e.get("type") == "span"]

    # -- construction ---------------------------------------------------
    @classmethod
    def from_events(cls, events: Sequence[Mapping]) -> "TraceAnalysis":
        return cls(build_spans(events), worker_offsets(events), events)

    @classmethod
    def from_jsonl(cls, path) -> "TraceAnalysis":
        """Build from a recorded JSONL log, following the whole rotation
        chain (``load_jsonl`` semantics: oldest file first)."""
        from .events import load_jsonl
        return cls.from_events(load_jsonl(path))

    # -- attribution ----------------------------------------------------
    def attribution(self) -> dict:
        """Overhead-attribution table: per-segment totals and their
        share of **worker-seconds** (``n_workers * makespan``, i.e. the
        cluster's wall-clock capacity over the traced window).  Pure
        execution and the nested p2p dep-fetch are broken out so
        ``exec + fetch == started->finished`` by construction."""
        ok = [s for s in self.spans if s.status == "ok"]
        cap = self.n_workers * self.makespan
        segs: dict = {}
        for name in SEGMENTS:
            vals = [d[name] for s in ok
                    if (d := s.segments()).get(name) is not None]
            tot = sum(vals)
            segs[name] = {
                "total_s": tot,
                "n": len(vals),
                "mean_ms": (tot / len(vals) * 1e3) if vals else 0.0,
                "pct_worker_seconds": (tot / cap * 100.0) if cap else 0.0,
            }
        fetch = sum(s.fetch_s for s in ok)
        execp = sum(s.exec_s for s in ok)
        return {
            "n_spans": len(self.spans), "n_ok": len(ok),
            "n_lost": self.n_lost, "n_workers": self.n_workers,
            "makespan_s": self.makespan, "worker_seconds": cap,
            "segments": segs,
            "exec_pure_s": execp, "fetch_s": fetch,
            "utilization_pct": (execp / cap * 100.0) if cap else 0.0,
        }

    # -- critical path --------------------------------------------------
    def critical_path(self) -> dict:
        """Longest dependency chain by completion time: start from the
        last task to finish, walk back through the dep (from the traced
        ``task-queued.deps``) that finished last, and split the chain's
        wall time into compute vs overhead.  Overhead on the chain is
        scheduling + transport + observation + nested dep-fetch; the
        residue (``gap_s``) is time the chain head waited on a sibling
        that the traced deps did not cover (e.g. released inputs)."""
        done = {s.tid: s for s in self.spans
                if s.status == "ok" and s.t_observed is not None}
        if not done:
            return {"path": [], "length_s": 0.0, "exec_s": 0.0,
                    "overhead_s": 0.0, "fetch_s": 0.0, "gap_s": 0.0}
        head = max(done.values(), key=lambda s: s.t_observed)
        path = [head]
        while True:
            preds = [done[d] for d in path[-1].deps if d in done]
            if not preds:
                break
            path.append(max(preds, key=lambda s: s.t_observed))
        path.reverse()
        exec_s = sum(s.exec_s for s in path)
        fetch_s = sum(s.fetch_s for s in path)
        overhead = fetch_s
        for s in path:
            seg = s.segments()
            overhead += sum(seg.get(n, 0.0) for n in (
                "schedulable->dispatched", "dispatched->started",
                "finished->observed"))
        first = path[0]
        t_from = next((t for t in (first.t_submit, first.t_ingest,
                                   first.t_queued) if t is not None),
                      head.t_observed)
        length = max(0.0, head.t_observed - t_from)
        return {
            "path": [s.tid for s in path],
            "length_s": length,
            "exec_s": exec_s,
            "overhead_s": overhead,
            "fetch_s": fetch_s,
            "gap_s": max(0.0, length - exec_s - overhead),
        }

    # -- reconciliation -------------------------------------------------
    def reconcile(self, stats: Mapping | None = None,
                  makespan: float | None = None) -> list:
        """Cross-check the spans against the runtime's own meters.

        Returns a list of ``{"check", "value", "reference", "ok",
        "detail"}`` dicts; the contract (and why each tolerance is what
        it is) lives in ``docs/tracing.md``.  ``stats`` is
        ``RunResult.stats`` / ``ServerCore.run_stats()``; ``makespan``
        the runtime-reported epoch makespan.  Checks whose reference is
        unavailable are reported with ``ok=None`` (skipped), so the gate
        is ``not any(c["ok"] is False for c in checks)``."""
        checks: list = []

        def add(check, value, reference, ok, detail=""):
            checks.append({"check": check, "value": value,
                           "reference": reference, "ok": ok,
                           "detail": detail})

        ok_spans = [s for s in self.spans if s.status == "ok"]

        # 1. worker boundaries are internally monotonic
        bad = sum(1 for s in ok_spans
                  if s.t_recv is not None
                  and not (s.t_recv <= s.t_start <= s.t_end
                           and s.fetch_s <= (s.t_end - s.t_start) + 1e-9))
        add("worker-monotonic", bad, 0, bad == 0,
            "recv<=start<=end and fetch nested within exec")

        # 2. span window fits the reported makespan
        if makespan is not None:
            add("span-window", self.makespan,
                makespan, self.makespan <= makespan * (1 + REL_TOL)
                + ABS_TOL,
                "trace t0..t1 within the runtime-reported makespan")
        else:
            add("span-window", self.makespan, None, None, "no makespan")

        # 3. execution never exceeds cluster capacity
        cap = self.n_workers * self.makespan
        exec_tot = sum(s.segments().get("started->finished", 0.0)
                       for s in ok_spans)
        add("exec-capacity", exec_tot, cap,
            None if not cap else exec_tot <= cap * (1 + REL_TOL) + ABS_TOL,
            "sum(started->finished) <= n_workers * makespan")

        if stats:
            # 4. every worker timing record became exactly one span
            n_tim = stats.get("n_timing")
            if n_tim is not None:
                timed = sum(1 for s in self.spans if s.t_start is not None)
                add("timing-count", timed, n_tim, timed == n_tim,
                    "spans with worker timing == stats['n_timing']")
            # 5. per-task scheduling segment is bounded below by the
            # measured per-task dispatch cost (the segment contains it)
            d_ns = stats.get("dispatch_ns_per_task")
            sched = [s.segments().get("schedulable->dispatched")
                     for s in ok_spans]
            sched = [v for v in sched if v is not None]
            if d_ns and sched:
                mean = sum(sched) / len(sched)
                ref = d_ns / 1e9
                add("dispatch-floor", mean, ref,
                    mean >= ref * (1 - REL_TOL) - ABS_TOL,
                    "mean schedulable->dispatched >= dispatch_ns_per_task")
            # 6. total scheduling segment covers the server's dispatch
            # busy time (each task's own encode sits inside its segment)
            d_s = stats.get("dispatch_s")
            if d_s is not None and sched:
                tot = sum(sched)
                add("dispatch-cover", tot, d_s,
                    tot >= d_s * (1 - REL_TOL) - ABS_TOL,
                    "sum schedulable->dispatched >= stats['dispatch_s']")
        return checks

    # -- export ---------------------------------------------------------
    def to_chrome_trace(self) -> dict:
        """Chrome-trace (Perfetto-loadable) JSON: one thread lane per
        worker carrying that worker's execution slices (single-threaded
        workers guarantee the slices never overlap; queueing/transport
        live in each slice's ``args``), plus a server lane with one
        slice per epoch, plus one lane per program thread carrying its
        ``span`` events.  Timestamps are microseconds from the first
        traced boundary."""
        t0 = min([self.t0] + [e["t0"] for e in self.program_spans])
        us = lambda t: (t - t0) * 1e6
        evs: list = [
            {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
             "args": {"name": "repro cluster"}},
            {"ph": "M", "name": "thread_name", "pid": 0, "tid": 0,
             "args": {"name": "server"}},
        ]
        wids = sorted({s.wid for s in self.spans if s.wid is not None})
        lane = {w: i + 1 for i, w in enumerate(wids)}
        for w in wids:
            evs.append({"ph": "M", "name": "thread_name", "pid": 0,
                        "tid": lane[w], "args": {"name": f"worker {w}"}})
        eids: dict = {}
        for s in self.spans:
            if s.eid is not None and s.t_ingest is not None:
                lo, hi = eids.get(s.eid, (s.t_ingest, s.t_ingest))
                hi = max(hi, s.t_observed or hi)
                eids[s.eid] = (min(lo, s.t_ingest), hi)
            if s.t_start is None or s.t_end is None:
                continue
            seg = s.segments()
            evs.append({
                "ph": "X", "name": f"task {s.tid}", "cat": "exec",
                "pid": 0, "tid": lane.get(s.wid, 0),
                "ts": us(s.t_start),
                "dur": max(0.0, (s.t_end - s.t_start) * 1e6),
                "args": {
                    "tid": s.tid, "status": s.status,
                    "fetch_ms": s.fetch_s * 1e3,
                    "sched_ms": seg.get(
                        "schedulable->dispatched", 0.0) * 1e3,
                    "xfer_ms": seg.get("dispatched->started", 0.0) * 1e3,
                    "observe_ms": seg.get(
                        "finished->observed", 0.0) * 1e3,
                },
            })
        for eid, (lo, hi) in sorted(eids.items()):
            evs.append({"ph": "X", "name": f"epoch {eid}", "cat": "epoch",
                        "pid": 0, "tid": 0, "ts": us(lo),
                        "dur": max(0.0, (hi - lo) * 1e6)})
        threads: dict = {}
        for e in self.program_spans:
            lane = threads.get(e["thread"])
            if lane is None:
                lane = threads[e["thread"]] = len(wids) + 1 + len(threads)
                evs.append({"ph": "M", "name": "thread_name", "pid": 0,
                            "tid": lane,
                            "args": {"name": f"program {e['thread']}"}})
            evs.append({"ph": "X", "name": e["name"], "cat": "span",
                        "pid": 0, "tid": lane, "ts": us(e["t0"]),
                        "dur": max(0.0, (e["t1"] - e["t0"]) * 1e6),
                        "args": {"sid": e["sid"], "parent": e["parent"],
                                 "rid": e["rid"], "step": e["step"],
                                 **(e["attrs"] or {})}})
        return {"displayTimeUnit": "ms", "traceEvents": evs,
                "otherData": {"n_spans": len(self.spans),
                              "n_workers": self.n_workers,
                              "makespan_s": self.makespan}}

    def write_chrome_trace(self, path) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_chrome_trace(), f)


def format_attribution(analysis: TraceAnalysis, width: int = 72) -> str:
    """Human-readable attribution report."""
    a = analysis.attribution()
    cp = analysis.critical_path()
    out = [
        f"trace attribution — {a['n_ok']}/{a['n_spans']} spans "
        f"({a['n_lost']} lost), {a['n_workers']} workers, "
        f"makespan {a['makespan_s'] * 1e3:.1f} ms",
        f"  {'segment':<26}{'total_s':>10}{'mean_ms':>10}"
        f"{'%worker-s':>11}",
    ]
    for name in SEGMENTS:
        seg = a["segments"][name]
        out.append(f"  {name:<26}{seg['total_s']:>10.4f}"
                   f"{seg['mean_ms']:>10.3f}"
                   f"{seg['pct_worker_seconds']:>10.1f}%")
    out.append(f"  {'exec (pure)':<26}{a['exec_pure_s']:>10.4f}"
               f"{'':>10}{a['utilization_pct']:>10.1f}%")
    out.append(f"  {'p2p dep-fetch (nested)':<26}{a['fetch_s']:>10.4f}")
    if cp["path"]:
        out.append(
            f"critical path: {len(cp['path'])} tasks, "
            f"{cp['length_s'] * 1e3:.1f} ms "
            f"(exec {cp['exec_s'] * 1e3:.1f} ms / overhead "
            f"{cp['overhead_s'] * 1e3:.1f} ms / gap "
            f"{cp['gap_s'] * 1e3:.1f} ms)")
    else:
        out.append("critical path: no completed spans")
    return "\n".join(out)


def format_reconciliation(checks: Sequence[Mapping]) -> str:
    """One line per reconciliation check, ``OK``/``SKIP``/``FAIL``."""
    out = []
    for c in checks:
        tag = "SKIP" if c["ok"] is None else ("OK" if c["ok"] else "FAIL")
        ref = "n/a" if c["reference"] is None else f"{c['reference']:.6g}"
        out.append(f"  [{tag}] {c['check']:<18} value={c['value']:.6g} "
                   f"ref={ref} — {c['detail']}")
    n_fail = sum(1 for c in checks if c["ok"] is False)
    out.append(f"reconciliation: {len(checks)} checks, {n_fail} failed")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# Program spans: the layers above the runtime
# ---------------------------------------------------------------------------

@dataclass(slots=True)
class SpanRecord:
    """One closed program span.  ``t0_ns``/``t1_ns`` are
    ``time.perf_counter_ns`` (the clock of the event envelopes and of the
    thread runtime's task timings); ``thread`` is the opening thread's
    name; ``parent`` the id of the span it ran under (None at the top)."""

    sid: int
    parent: int | None
    name: str
    thread: str
    t0_ns: int
    t1_ns: int
    rid: int | None = None
    step: int | None = None
    attrs: dict | None = None
    events: tuple | None = None         # CUDA (start, end), device=True
    _device_s: float | None = None

    @property
    def dur_ns(self) -> int:
        return self.t1_ns - self.t0_ns

    @property
    def device_s(self) -> float | None:
        """Seconds between the span's two CUDA events, once the end event
        has completed (None before, or without ``device=True``).  Reading
        it never waits for the card."""
        if self._device_s is None and self.events is not None:
            start, end = self.events
            if end.query():
                self._device_s = start.elapsed_time(end) / 1e3
                self.events = None
        return self._device_s


class _Open:
    """A span while it is open: ``sid`` links a span on another thread to
    it (``parent=sid``), and ``set()`` adds attributes."""

    __slots__ = ("rec", "sid", "parent", "name", "rid", "step", "attrs",
                 "device", "t0", "_range", "_ev0")

    def __init__(self, rec, sid, parent, name, rid, step, attrs, device):
        self.rec, self.sid, self.parent, self.name = rec, sid, parent, name
        self.rid, self.step, self.attrs, self.device = rid, step, attrs, \
            device

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        if stack:
            top = stack[-1]
            if self.parent is None:
                self.parent = top.sid
            if self.rid is None:
                self.rid = top.rid
            if self.step is None:
                self.step = top.step
        stack.append(self)
        self._range = rec._range_of(self.name)
        self._range.__enter__()
        if self.device:
            self._ev0 = rec._cuda_event()
        self.t0 = time.perf_counter_ns()
        return self

    def set(self, **attrs) -> None:
        """Set attributes of the open span."""
        self.attrs.update(attrs)

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        rec = self.rec
        events = None
        if self.device:
            ev1 = rec._cuda_event()
            if self._ev0 is not None:
                events = (self._ev0, ev1)
        self._range.__exit__(*exc)
        stack = rec._stack()
        if stack and stack[-1] is self:
            stack.pop()
        rec._close(SpanRecord(self.sid, self.parent, self.name,
                              threading.current_thread().name, self.t0, t1,
                              self.rid, self.step, self.attrs or None,
                              events))
        return False


class _Null:
    """The open span of a disabled recorder: records nothing."""

    sid = parent = rid = step = None

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _NoSpans:
    """A recorder that records nothing and is not registered with
    :func:`recorder`: the default of code that takes an optional one."""

    enabled = False

    def span(self, name: str, **kw) -> _Null:
        return _NULL


NO_SPANS = _NoSpans()

#: name -> the newest :class:`Spans` built under it (:func:`recorder`)
_RECORDERS: dict = {}


def recorder(name: str) -> "Spans | None":
    """The newest recorder built under ``name``: a reader finds a stopped
    engine's or trainer's spans here after their owner is gone."""
    return _RECORDERS.get(name)


class Spans:
    """An in-memory recorder of program spans.

    ``with spans.span(name, parent=None, device=False, rid=None,
    step=None, **attrs) as sp:`` opens a span on the current thread.
    Spans nested on one thread take the enclosing span as their parent
    (and its ``rid``/``step`` unless given); ``parent=sp.sid`` links a
    span to one opened on another thread.  Each span is also a profiler
    range of the same name, so a profiler that captures the thread shows
    the program's names.  ``device=True`` records a CUDA event on the
    current stream at entry and exit; :attr:`SpanRecord.device_s` reads
    their interval once the end has completed.  Nothing here waits for
    the card.

    Closed spans go to a ring of ``capacity`` (:attr:`records`) and to
    per-name totals (:meth:`totals`); with ``bus`` each is also published
    as a ``span`` event.  ``enabled=False`` makes every call a no-op.
    The newest recorder of each ``name`` is kept for :func:`recorder`.
    """

    def __init__(self, name: str, capacity: int = 65536,
                 enabled: bool = True, bus=None):
        self.name = name
        self.enabled = enabled
        self.bus = bus
        self.records: collections.deque = collections.deque(maxlen=capacity)
        self._totals: dict = {}
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()
        self.t_open_ns = time.perf_counter_ns()
        self.t_closed_ns: int | None = None
        self._anchor = _clock_anchor()
        if enabled:     # a profiler range a span, ~0.5 us with none on
            from torch._C._profiler import _RecordFunctionFast
            self._range_of = _RecordFunctionFast
        self._cuda = None
        _RECORDERS[name] = self

    # -- recording ------------------------------------------------------
    def span(self, name: str, parent: int | None = None,
             device: bool = False, rid: int | None = None,
             step: int | None = None, **attrs):
        if not self.enabled:
            return _NULL
        return _Open(self, next(self._ids), parent, name, rid, step, attrs,
                     device)

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _cuda_event(self):
        """A CUDA event recorded on the current stream, or None without a
        card."""
        if self._cuda is None:
            import torch
            self._cuda = torch.cuda if torch.cuda.is_available() else False
        if not self._cuda:
            return None
        ev = self._cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _close(self, rec: SpanRecord) -> None:
        self.records.append(rec)
        with self._lock:    # the loop and pool threads both close spans
            tot = self._totals.get(rec.name)
            if tot is None:
                tot = self._totals[rec.name] = [0, 0]
            tot[0] += 1
            tot[1] += rec.t1_ns - rec.t0_ns
        if self.bus is not None:
            self.bus.publish("span", sid=rec.sid, parent=rec.parent,
                             name=rec.name, thread=rec.thread,
                             t0=rec.t0_ns / 1e9, t1=rec.t1_ns / 1e9,
                             rid=rec.rid, step=rec.step,
                             attrs=rec.attrs)

    def close(self) -> None:
        """Stamp the end of the recorder's life (``t_closed_ns``); spans
        still open may close after it."""
        if self.t_closed_ns is None:
            self.t_closed_ns = time.perf_counter_ns()

    # -- reading --------------------------------------------------------
    def window(self, seconds: float) -> list | None:
        """The closed spans that lie in the ``seconds`` before
        :meth:`close`, or None while the recorder is open or where it was
        built inside that window (it then recorded another run)."""
        hi = self.t_closed_ns
        if hi is None:
            return None
        lo = hi - int(seconds * 1e9)
        if self.t_open_ns > lo:
            return None
        return [r for r in list(self.records)
                if r.t0_ns >= lo and r.t1_ns <= hi]

    def totals(self) -> dict:
        """Per span name: ``{"n": count, "s": seconds}`` over every span
        closed so far (the ring's bound does not apply)."""
        with self._lock:
            return {k: {"n": n, "s": ns / 1e9}
                    for k, (n, ns) in self._totals.items()}

    def to_profiler_ns(self, t_ns: int) -> int:
        """``t_ns`` (``perf_counter_ns``) on the profiler's clock: the
        Unix-epoch nanoseconds of ``torch.profiler``'s events."""
        perf, wall = self._anchor
        return t_ns - perf + wall


def _clock_anchor(samples: int = 5) -> tuple:
    """A (``perf_counter_ns``, ``time_ns``) pair read together, from the
    tightest of ``samples`` reads."""
    best = None
    for _ in range(samples):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, wall)
    return best[1:]
