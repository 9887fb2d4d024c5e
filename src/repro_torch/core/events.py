"""Structured event feed: typed vocabulary, ring-buffer bus, replayable log.

A copy of :mod:`repro.core.events` for the port.

The paper's claim — Dask's bottleneck is runtime overhead, not scheduling
— is only checkable against a runtime that exposes what it is doing.
Real Dask ships a bokeh task-stream/worker-monitor dashboard for exactly
this reason; this module is that observability substrate for every
server driver, and the ingestion point for a trace-driven scale
harness.

Three pieces:

* **Event vocabulary** (:data:`EVENT_TYPES`) — a typed, versioned schema
  (:data:`SCHEMA_VERSION`).  Every event is a flat JSON-safe dict::

      {"v": 1, "seq": 17, "t": 3.0521, "type": "task-finished",
       "tid": 42, "wid": 3}

  ``seq`` is a global monotonically increasing id (allocation order ==
  publish order), ``t`` is a ``time.perf_counter`` timestamp (deltas are
  meaningful; the ``stream-open`` event anchors it to wall time).

* :class:`EventBus` — a bounded ring buffer (``collections.deque`` with
  ``maxlen``; appends are GIL-atomic, hence "lock-free-ish") plus
  optional push sinks.  The bus only exists when a caller opts in
  (``Cluster(events=...)``): the disabled path in
  :class:`repro_torch.core.server.ServerCore` is a single ``is None`` check,
  so the hot dispatch path pays nothing by default.  One instrumentation
  pass in ServerCore covers all four drivers (inproc / selector /
  asyncio / uvloop) because they all consult that one state machine.

* :class:`JsonlEventLog` — an append-only JSONL sink with bounded
  rotation, plus :func:`load_jsonl` / :func:`replay` which reconstruct
  per-worker occupancy timelines and task-stream summaries from a
  recorded log (``scripts/replay.py`` is the CLI; ``scripts/
  dashboard.py`` renders the live view from ``ServerCore.observe()``).

Ordering guarantees (documented in ``docs/events.md``): ``seq`` is
globally unique and increasing; all control-plane events (dispatch,
finish, steal, epoch, gather, release) are published from the server
loop thread in protocol order — a ``task-finished`` always carries a
larger ``seq`` than the ``task-dispatched`` that placed it, and a
``task-started`` (worker-side, inproc driver only) always lands between
its dispatch and its finish.  Events published from other threads
(inproc ``task-started``, in-process store spills) interleave with the
loop's events but never violate those per-task orderings.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import Any, Callable, Iterable, Iterator

#: Version stamped on every event as ``"v"``.  Policy (docs/events.md):
#: adding event types or optional fields is backward compatible and does
#: NOT bump the version; renaming/removing a type or field, or changing
#: a field's meaning/units, bumps it.  Consumers should ignore unknown
#: types and fields.
SCHEMA_VERSION = 1

#: The full vocabulary: event type -> required payload fields (beyond
#: the envelope ``v``/``seq``/``t``/``type``).  ``wid == -1`` denotes
#: the node-level shared store of the in-process drivers (thread
#: workers share the server's ObjectStore).
EVENT_TYPES: dict[str, tuple[str, ...]] = {
    # stream lifecycle
    "stream-open": ("wall", "pid"),
    # epoch ledger
    "epoch-open": ("eid", "n_tasks", "lo", "hi"),
    "epoch-close": ("eid", "error"),
    # task lifecycle
    "task-queued": ("tid", "wid"),
    "task-dispatched": ("tid", "wid"),
    "task-started": ("tid", "wid"),          # inproc driver only
    "task-finished": ("tid", "wid"),
    "task-steal": ("tid", "wid"),            # wid = steal target
    "steal-failed": ("tid",),
    "task-rehint": ("tid", "wid"),           # proactive hint rewrite
    "fetch-failed": ("tid", "wid", "n_missing"),
    # tracing (Cluster(tracing=True)): worker-clock timestamps in the
    # worker's own perf_counter domain — repro_torch.core.tracing aligns them
    "task-timing": ("tid", "wid", "recv", "start", "end", "fetch"),
    # worker membership / memory ledger
    "worker-join": ("wid",),
    "worker-lost": ("wid", "n_lost"),
    "worker-pressure": ("wid", "pressured", "mem_bytes"),
    "spill": ("wid", "nbytes"),
    "unspill": ("wid", "nbytes"),
    # data plane / key lifetime
    "gather": ("wid", "n"),
    "gather-reply": ("wid", "n_present", "n_absent"),
    "release": ("n",),
    "compact": ("base",),
    # layered extensions (serve/train publish through the same bus)
    "request-enter": ("rid", "tenant"),
    "request-admit": ("rid", "tenant", "slot"),
    "request-exit": ("rid", "tenant", "n_tokens", "latency_s"),
    "train-step": ("step", "makespan"),
}


class EventBus:
    """Bounded in-memory event ring + optional push sinks.

    Appends ride a ``deque(maxlen=capacity)`` — old events fall off the
    back, so a long-lived server's bus is bounded no matter how many
    epochs flow through it.  ``publish`` takes a small lock only to keep
    sinks and the sequence counter coherent across threads (worker
    threads publish ``task-started`` / in-process spill events); the
    *disabled* path never reaches this module at all.
    """

    def __init__(self, capacity: int = 65536,
                 clock: Callable[[], float] = time.perf_counter):
        self.capacity = capacity
        self._clock = clock
        self._ring: collections.deque[dict] = collections.deque(
            maxlen=capacity)
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._sinks: list[Callable[[dict], None]] = []
        self.n_published = 0
        self.counts: collections.Counter = collections.Counter()
        self._closed = False
        self.publish("stream-open", wall=time.time(), pid=os.getpid())

    # -- publishing ----------------------------------------------------
    def publish(self, type_: str, **fields: Any) -> dict:
        """Append one event to the ring and push it to every sink.
        Returns the event dict (callers on the hot path ignore it)."""
        with self._lock:
            ev = {"v": SCHEMA_VERSION, "seq": next(self._seq),
                  "t": self._clock(), "type": type_, **fields}
            self._ring.append(ev)
            self.n_published += 1
            self.counts[type_] += 1
            for sink in self._sinks:
                try:
                    sink(ev)
                except Exception:
                    pass    # a broken sink must never take the loop down
        return ev

    @property
    def n_dropped(self) -> int:
        """Events that fell off the ring (sinks saw them; ``tail`` and
        ``since`` no longer can)."""
        return max(0, self.n_published - self.capacity)

    # -- subscription --------------------------------------------------
    def add_sink(self, sink: Callable[[dict], None]) -> None:
        """Attach a push sink.  Events already in the ring are replayed
        into it first, so a sink attached just after construction (the
        ``make_bus`` path) still sees the ``stream-open`` anchor and a
        recorded log is complete from event zero."""
        with self._lock:
            for ev in self._ring:
                try:
                    sink(ev)
                except Exception:
                    pass
            self._sinks.append(sink)

    def tail(self, n: int = 100) -> list[dict]:
        """Most recent ``n`` events, oldest first (snapshot copy)."""
        with self._lock:
            ring = list(self._ring)
        return ring[-n:]

    def since(self, seq: int) -> list[dict]:
        """Events with ``seq`` strictly greater than ``seq`` still in
        the ring (dashboard incremental poll)."""
        with self._lock:
            ring = list(self._ring)
        return [e for e in ring if e["seq"] > seq]

    def close(self) -> None:
        """Flush and close every sink (idempotent).  The ring stays
        readable after close — postmortems outlive the server loop."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            sinks, self._sinks = self._sinks, []
        for sink in sinks:
            closer = getattr(sink, "close", None)
            if closer is not None:
                try:
                    closer()
                except Exception:
                    pass


class JsonlEventLog:
    """Append-only JSONL sink with bounded rotation.

    One JSON object per line.  When the live file exceeds ``max_bytes``
    it is rotated to ``<path>.1`` (existing rotations shift to ``.2`` …
    ``.keep``; the oldest is unlinked), so a recording can run for days
    without growing unboundedly.  :func:`load_jsonl` reads the rotation
    chain back oldest-first.
    """

    def __init__(self, path: str | os.PathLike, *,
                 max_bytes: int = 64 * 2**20, keep: int = 2,
                 flush_every: int = 256):
        self.path = os.fspath(path)
        self.max_bytes = max_bytes
        self.keep = keep
        self.flush_every = flush_every
        self._lock = threading.Lock()
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        self._fh = open(self.path, "w", encoding="utf-8")
        self._size = 0
        self._since_flush = 0

    def __call__(self, ev: dict) -> None:
        with self._lock:
            if self._fh is None:
                return
            line = json.dumps(ev, separators=(",", ":"),
                              default=repr) + "\n"
            self._fh.write(line)
            self._size += len(line)
            self._since_flush += 1
            if self._since_flush >= self.flush_every:
                self._fh.flush()
                self._since_flush = 0
            if self._size >= self.max_bytes:
                self._rotate()

    def _rotate(self) -> None:
        self._fh.close()
        oldest = f"{self.path}.{self.keep}"
        if os.path.exists(oldest):
            try:
                os.unlink(oldest)
            except OSError:
                pass
        for i in range(self.keep - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        os.replace(self.path, f"{self.path}.1")
        self._fh = open(self.path, "w", encoding="utf-8")
        self._size = 0

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                self._fh.close()
                self._fh = None


def make_bus(spec: Any) -> EventBus | None:
    """Normalize the user-facing ``events=`` knob:

    * ``None`` / ``False`` -> no bus (the zero-cost default),
    * ``True`` -> ring buffer only,
    * a path string / ``os.PathLike`` -> ring + :class:`JsonlEventLog`
      recording to that path,
    * an :class:`EventBus` -> used as-is (shared buses are how the
      serve/train layers publish into their cluster's feed).
    """
    if not spec:
        return None
    if isinstance(spec, EventBus):
        return spec
    bus = EventBus()
    if isinstance(spec, (str, os.PathLike)):
        bus.add_sink(JsonlEventLog(spec))
    elif spec is not True:
        raise TypeError(
            f"events= wants True, a log path or an EventBus, got {spec!r}")
    return bus


# ---------------------------------------------------------------------------
# Replay: reconstruct timelines from a recorded log
# ---------------------------------------------------------------------------

def load_jsonl(path: str | os.PathLike,
               max_rotations: int = 16) -> list[dict]:
    """Read a (possibly rotated) JSONL event log back, oldest event
    first.  Unparseable lines (a crash mid-write) are skipped."""
    path = os.fspath(path)
    files = [f"{path}.{i}" for i in range(max_rotations, 0, -1)
             if os.path.exists(f"{path}.{i}")]
    if os.path.exists(path):
        files.append(path)
    events: list[dict] = []
    for fname in files:
        with open(fname, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except ValueError:
                    continue
    return events


def stream_integrity(events: Iterable[dict]) -> dict:
    """Completeness report for a recorded stream: seq coverage and gap
    count.  A recorded log is written by a push sink, so it normally
    has every seq from 0; missing seqs mean rotated files beyond the
    ``load_jsonl`` ``max_rotations`` window were dropped, a crash ate a
    tail, or a ring snapshot (``EventBus.since``) aged events out —
    either way downstream reconstructions (replay, tracing) are partial
    and the UIs surface it.  A ``stream-open`` event resets the seq
    expectation (logs can hold several recording sessions)."""
    n_events = 0
    n_gaps = n_missing = 0
    first_seq = last_seq = None
    prev = None
    for ev in events:
        n_events += 1
        seq = ev.get("seq")
        if seq is None:
            continue
        if ev.get("type") == "stream-open":
            prev = None
        if first_seq is None:
            first_seq = seq
        if prev is not None and seq > prev + 1:
            n_gaps += 1
            n_missing += seq - prev - 1
        prev = last_seq = seq
    return {"n_events": n_events, "first_seq": first_seq,
            "last_seq": last_seq, "n_gaps": n_gaps,
            "n_missing": n_missing,
            "complete": n_gaps == 0 and (first_seq in (None, 0))}


def replay(events: Iterable[dict]) -> dict:
    """Reconstruct per-worker occupancy timelines and task-stream
    summaries from an event stream (recorded log or live ring).

    Occupancy spans run from a task's ``task-started`` (inproc) or —
    when start is unobservable, as on the process drivers — its last
    ``task-dispatched``, to its ``task-finished``; dispatch-based spans
    therefore include queue wait, and concurrent spans on one worker
    mean its queue ran deep, not that it ran two tasks at once.

    The returned totals are defined to agree with the recording run's
    ``RunResult.stats``: ``tasks_per_worker`` counts ``task-finished``
    events per worker (the same records ServerCore counts), ``n_steals``
    counts ``task-steal`` events, and ``spill_bytes``/``unspill_bytes``
    sum the corresponding event deltas — the agreement
    ``scripts/ci_smoke.py`` and ``tests/test_events.py`` gate on.
    """
    by_type: collections.Counter = collections.Counter()
    tasks_per_worker: dict[int, int] = {}
    streams: dict[int, list[tuple[int, float, float]]] = {}
    busy_s: dict[int, float] = {}
    last_dispatch: dict[int, float] = {}
    last_start: dict[int, float] = {}
    epochs: dict[int, dict] = {}
    workers_seen: set[int] = set()
    lost: set[int] = set()
    pressured: set[int] = set()
    n_events = 0
    n_steals = 0
    spill_bytes = unspill_bytes = 0
    t0 = t1 = None
    wall_anchor = None
    for ev in events:
        n_events += 1
        typ = ev.get("type")
        by_type[typ] += 1
        t = ev.get("t")
        if t is not None:
            t0 = t if t0 is None else min(t0, t)
            t1 = t if t1 is None else max(t1, t)
        if typ == "stream-open":
            wall_anchor = (ev.get("wall"), t)
        elif typ == "task-dispatched":
            last_dispatch[ev["tid"]] = t
        elif typ == "task-started":
            last_start[ev["tid"]] = t
        elif typ == "task-finished":
            wid, tid = ev["wid"], ev["tid"]
            workers_seen.add(wid)
            tasks_per_worker[wid] = tasks_per_worker.get(wid, 0) + 1
            start = last_start.pop(tid, None)
            if start is None:
                start = last_dispatch.pop(tid, None)
            else:
                last_dispatch.pop(tid, None)
            if start is not None and t is not None:
                streams.setdefault(wid, []).append((tid, start, t))
                busy_s[wid] = busy_s.get(wid, 0.0) + max(t - start, 0.0)
        elif typ == "task-steal":
            n_steals += 1
        elif typ == "spill":
            spill_bytes += int(ev.get("nbytes", 0))
        elif typ == "unspill":
            unspill_bytes += int(ev.get("nbytes", 0))
        elif typ == "worker-join":
            workers_seen.add(ev["wid"])
        elif typ == "worker-lost":
            lost.add(ev["wid"])
        elif typ == "worker-pressure":
            (pressured.add if ev.get("pressured")
             else pressured.discard)(ev["wid"])
        elif typ == "epoch-open":
            epochs[ev["eid"]] = {"n_tasks": ev.get("n_tasks"),
                                 "t_open": t, "t_close": None,
                                 "error": None}
        elif typ == "epoch-close":
            e = epochs.setdefault(ev["eid"], {"n_tasks": None,
                                              "t_open": None,
                                              "t_close": None,
                                              "error": None})
            e["t_close"] = t
            e["error"] = ev.get("error")
    wall = (t1 - t0) if (t0 is not None and t1 is not None) else 0.0
    for e in epochs.values():
        e["makespan"] = (e["t_close"] - e["t_open"]
                         if e["t_open"] is not None
                         and e["t_close"] is not None else None)
    workers = {}
    for wid in sorted(workers_seen):
        b = busy_s.get(wid, 0.0)
        workers[wid] = {
            "n_finished": tasks_per_worker.get(wid, 0),
            "busy_s": b,
            "occupancy": (b / wall) if wall > 0 else 0.0,
            "lost": wid in lost,
            "pressured": wid in pressured,
        }
    return {
        "schema": SCHEMA_VERSION,
        "n_events": n_events,
        "by_type": dict(by_type),
        "wall_s": wall,
        "wall_anchor": wall_anchor,
        "workers": workers,
        "tasks_per_worker": tasks_per_worker,
        "n_finished": sum(tasks_per_worker.values()),
        "n_steals": n_steals,
        "spill_bytes": spill_bytes,
        "unspill_bytes": unspill_bytes,
        "epochs": epochs,
        "task_stream": streams,
    }


def format_summary(summary: dict, width: int = 72,
                   max_stream_rows: int = 12) -> str:
    """Human-readable postmortem: per-worker occupancy bars plus a
    task-stream tail (what ``scripts/replay.py`` prints)."""
    out: list[str] = []
    out.append(f"events: {summary['n_events']}  "
               f"wall: {summary['wall_s']:.3f}s  "
               f"finished: {summary['n_finished']}  "
               f"steals: {summary['n_steals']}  "
               f"spill: {summary['spill_bytes']}B")
    by_type = summary["by_type"]
    out.append("  " + "  ".join(f"{k}={by_type[k]}"
                                for k in sorted(by_type)))
    out.append("")
    out.append("worker occupancy (dispatch->finish spans; includes "
               "queue wait):")
    barw = max(width - 40, 10)
    for wid, w in summary["workers"].items():
        occ = min(w["occupancy"], 1.0)
        bar = "#" * int(round(occ * barw))
        flags = ("  LOST" if w["lost"] else
                 "  PRESSURED" if w["pressured"] else "")
        out.append(f"  w{wid:<3d} [{bar:<{barw}}] "
                   f"{w['occupancy']:6.1%}  "
                   f"{w['n_finished']:6d} tasks{flags}")
    eps = summary["epochs"]
    if eps:
        out.append("")
        out.append("epochs:")
        for eid in sorted(eps):
            e = eps[eid]
            mk = (f"{e['makespan'] * 1e3:9.2f} ms"
                  if e["makespan"] is not None else "   (open)   ")
            err = f"  ERROR: {e['error']}" if e.get("error") else ""
            out.append(f"  e{eid:<4d} {str(e['n_tasks'] or '?'):>6s} "
                       f"tasks  {mk}{err}")
    stream = summary["task_stream"]
    if stream:
        out.append("")
        out.append(f"task stream (last {max_stream_rows} per worker):")
        for wid in sorted(stream):
            rows = stream[wid][-max_stream_rows:]
            cells = " ".join(f"{tid}:{(b - a) * 1e3:.1f}ms"
                             for tid, a, b in rows)
            out.append(f"  w{wid}: {cells}")
    return "\n".join(out)
