"""Trace conformance: validate an event stream against the protocol spec.

The checker consumes the runtime's event vocabulary one event at a time and
enforces :mod:`repro_torch.analysis.protocol` — the per-task and per-worker
state machines plus the cross-entity invariants — producing the same
:class:`repro_torch.analysis.engine.Finding` objects as the static rules, so
keys, allowlisting, formatting and exit codes are uniform across
``python -m repro_torch.analysis`` (``--trace``) and the online :class:`ConformanceSink`.

Two operating modes:

* **strict** — the stream is complete from ``stream-open`` (an offline
  JSONL log, or a sink attached at bus construction).  Every guard runs.
* **windowed** — the stream has a hole: the sink attached after ring
  overflow (``EventBus.n_dropped > 0``), or rotation dropped the head of
  a log.  Detected from the ``seq`` envelope (any forward gap); history
  -dependent guards (dispatch credentials, epoch membership, spill
  provenance) are disabled instead of producing false positives, and
  unknown transitions re-bootstrap entity state from the observed event.
  Memoryless checks (envelope fields, negative ledgers, decreasing seq,
  double-lost/join/close, released-key gathers) stay on.

Like every ``repro_torch.analysis`` module this imports nothing from the
runtime — it runs in a bare interpreter and is safe to attach to the
server loop (the bus additionally crash-contains sinks; the sink also
self-contains, counting internal errors instead of raising).
"""
from __future__ import annotations

import json
import os
from pathlib import Path

from repro_torch.analysis import engine, protocol
from repro_torch.analysis.engine import Finding

TRACE_RULES = ("RA6", "RA7")

_ENVELOPE = ("v", "seq", "t", "type")


class _Task:
    __slots__ = ("state", "creds", "finished")

    def __init__(self):
        self.state = protocol.initial_task_state()
        self.creds: dict[int, int] = {}     # wid -> outstanding finishes
        self.finished = False


class _Worker:
    __slots__ = ("state", "explicit")

    def __init__(self):
        self.state = protocol.initial_worker_state()
        self.explicit = False               # saw an explicit worker-join


class TraceChecker:
    """Feed events (dicts) in stream order; collect Finding objects.

    ``path`` labels findings (the trace file, or a live-bus tag);
    ``line`` on each finding is the 1-based event index in the stream.
    """

    #: Violation kinds this implementation enforces.  RA7 statically
    #: pins this literal against ``protocol.INVARIANTS`` — adding an
    #: invariant to the spec without implementing it (or vice versa) is
    #: a repo finding.
    IMPLEMENTS = (
        "finish-without-dispatch", "double-finish", "lost-worker-finish",
        "start-without-dispatch", "dispatch-to-lost", "double-join",
        "double-lost", "illegal-transition",
        "out-of-order-seq", "missing-field", "negative-ledger",
        "gather-after-release", "spill-without-put",
        "epoch-close-with-pending", "close-unopened-epoch",
        "double-epoch-close",
    )

    def __init__(self, *, path: str = "<events>", windowed: bool = False,
                 max_findings: int = 1000):
        self.path = path
        self.max_findings = max_findings
        self.findings: list[Finding] = []
        self.n_overflow = 0        # findings dropped past max_findings
        self.n_events = 0
        self.n_gaps = 0
        self.strict = not windowed
        self._reset_stream()

    def _reset_stream(self) -> None:
        self._last_seq: int | None = None
        self._tasks: dict[int, _Task] = {}
        self._workers: dict[int, _Worker] = {}
        self._epochs: dict[int, dict] = {}
        self._released: set[int] = set()
        self._dispatched_wids: set[int] = set()
        self._any_dispatch = False

    # -- reporting -----------------------------------------------------
    def _viol(self, kind: str, line: int, detail: str, msg: str) -> None:
        if len(self.findings) >= self.max_findings:
            self.n_overflow += 1
            return
        rule = protocol.event_rule(kind)
        self.findings.append(Finding(
            rule, self.path, line, msg, key=f"{rule}:{kind}:{detail}"))

    # -- stream ingestion ----------------------------------------------
    def check_many(self, events) -> list[Finding]:
        for ev in events:
            self.feed(ev)
        return self.findings

    def feed(self, ev) -> None:
        self.n_events += 1
        line = self.n_events
        if not isinstance(ev, dict):
            self._viol("missing-field", line, "envelope:event",
                       f"event #{line} is not an object: {ev!r}")
            return
        type_ = ev.get("type")
        # a fresh stream-open (seq restarts at 0) begins a new stream:
        # concatenated logs / reused sinks reset entity state
        if type_ == "stream-open" and ev.get("seq") == 0 \
                and self._last_seq is not None:
            self._reset_stream()
        ok = True
        for f in _ENVELOPE:
            if f not in ev:
                self._viol("missing-field", line, f"envelope:{f}",
                           f"event #{line} lacks envelope field {f!r}")
                ok = False
        if not ok:
            return
        self._check_seq(ev, line)
        fields = protocol.EVENT_FIELDS.get(type_)
        if fields is None:
            return      # unknown type: forward-compatible, ignored
        for f in fields:
            if f not in ev:
                self._viol("missing-field", line, f"{type_}:{f}",
                           f"{type_} event #{line} lacks required "
                           f"field {f!r}")
                ok = False
        if not ok:
            return
        for f in protocol.LEDGER_FIELDS.get(type_, ()):
            v = ev.get(f)
            if isinstance(v, (int, float)) and v < 0:
                self._viol("negative-ledger", line, f"{type_}:{f}",
                           f"{type_} event #{line} carries negative "
                           f"{f}={v}")
        if type_ in protocol.TASK_EVENTS:
            self._task_event(type_, ev, line)
        elif type_ in protocol.WORKER_EVENTS:
            self._worker_event(type_, ev, line)
        elif type_ in protocol.EPOCH_EVENTS:
            self._epoch_event(type_, ev, line)
        elif type_ == "release":
            for tid in ev.get("tids") or ():
                self._released.add(int(tid))
                self._mark_terminal(int(tid))
        elif type_ == "compact":
            base = int(ev.get("base") or 0)
            for tid in [t for t in self._tasks if t < base]:
                del self._tasks[tid]
            self._released = {t for t in self._released if t >= base}

    def _check_seq(self, ev: dict, line: int) -> None:
        seq = ev.get("seq")
        if not isinstance(seq, int):
            return
        last = self._last_seq
        if last is None:
            if seq != 0 and self.strict:
                self._gap()
        elif seq <= last:
            self._viol("out-of-order-seq", line, f"seq{seq}",
                       f"event #{line} seq {seq} after seq {last} "
                       f"(duplicate or reordered stream)")
            return      # keep the high-water mark
        elif seq > last + 1 and self.strict:
            self._gap()
        self._last_seq = max(last if last is not None else seq, seq)

    def _gap(self) -> None:
        """Hole in the stream (late attach / ring overflow / rotation):
        downgrade to windowed checking instead of false positives."""
        self.strict = False
        self.n_gaps += 1

    # -- entity lookup -------------------------------------------------
    def _task(self, tid: int) -> _Task:
        t = self._tasks.get(tid)
        if t is None:
            t = self._tasks[tid] = _Task()
        return t

    def _worker(self, wid: int) -> _Worker:
        w = self._workers.get(wid)
        if w is None:
            w = self._workers[wid] = _Worker()
        return w

    def _live(self, wid: int) -> _Worker:
        """First activity implies membership (elastic scale-up joins
        without a worker-join event)."""
        w = self._worker(wid)
        if w.state == "new":
            w.state = "live"
        return w

    # -- task machine + credential ledger ------------------------------
    def _task_event(self, type_: str, ev: dict, line: int) -> None:
        tid, wid = int(ev["tid"]), int(ev.get("wid", -1))
        t = self._task(tid)
        if type_ in ("task-queued", "task-dispatched", "task-steal"):
            # these *target* a worker; the server reroutes dead ones
            # before publishing, so a lost target is a protocol bug
            w = self._live(wid)
            if w.state == "lost":
                self._viol("dispatch-to-lost", line, str(tid),
                           f"{type_} #{line}: task {tid} targets lost "
                           f"worker {wid}")
                return
        if type_ == "task-dispatched":
            t.creds[wid] = t.creds.get(wid, 0) + 1
            self._dispatched_wids.add(wid)
            self._any_dispatch = True
        if type_ == "task-started":
            if t.creds.get(wid, 0) <= 0 and self.strict:
                self._viol("start-without-dispatch", line, str(tid),
                           f"task-started #{line}: task {tid} started "
                           f"on worker {wid} with no outstanding "
                           f"dispatch")
            nxt = protocol.TASK_TRANSITIONS.get((t.state, type_))
            if nxt is not None:
                t.state = nxt
            return
        if type_ == "task-finished":
            self._finish(t, tid, wid, line)
            return
        nxt = protocol.TASK_TRANSITIONS.get((t.state, type_))
        if nxt is None:
            if self.strict:
                self._viol("illegal-transition", line,
                           f"task:{t.state}:{type_}",
                           f"{type_} #{line}: no edge from task state "
                           f"{t.state!r} (task {tid})")
            # windowed: re-bootstrap from the observed event
            t.state = {"task-queued": "queued",
                       "task-dispatched": "dispatched",
                       "task-steal": "stolen",
                       "fetch-failed": "parked"}.get(type_, t.state)
        else:
            t.state = nxt

    def _finish(self, t: _Task, tid: int, wid: int, line: int) -> None:
        """A finish consumes one dispatch credential on that worker.
        Credentials survive steals (optimistic wire retraction) and
        worker loss (in-flight completions) — see protocol.py."""
        w = self._live(wid)
        if t.creds.get(wid, 0) > 0:
            t.creds[wid] -= 1
        elif self.strict:
            if w.state == "lost":
                self._viol("lost-worker-finish", line, str(tid),
                           f"task-finished #{line}: task {tid} finished "
                           f"on lost worker {wid} with no in-flight "
                           f"dispatch from before the loss")
            elif t.state == "finished":
                self._viol("double-finish", line, str(tid),
                           f"task-finished #{line}: task {tid} finished "
                           f"again on worker {wid} without a re-dispatch")
            else:
                self._viol("finish-without-dispatch", line, str(tid),
                           f"task-finished #{line}: task {tid} finished "
                           f"on worker {wid} but was never dispatched "
                           f"there")
        t.state = "finished"
        t.finished = True
        self._mark_terminal(tid)

    def _mark_terminal(self, tid: int) -> None:
        for e in self._epochs.values():
            if not e["closed"] and e["lo"] <= tid < e["hi"]:
                e["done"].add(tid)
                return

    # -- worker machine ------------------------------------------------
    def _worker_event(self, type_: str, ev: dict, line: int) -> None:
        wid = int(ev["wid"])
        if wid == protocol.SHARED_STORE_WID:
            # the node-level shared store: no membership machine, but
            # spills still require a prior put somewhere on the node
            if type_ == "spill" and self.strict \
                    and not self._any_dispatch:
                self._viol("spill-without-put", line, f"w{wid}",
                           f"spill #{line} from the shared store before "
                           f"any dispatch placed data")
            return
        w = self._worker(wid)
        if type_ == "worker-join":
            if w.state == "lost":
                if self.strict:
                    self._viol("illegal-transition", line,
                               f"worker:lost:worker-join",
                               f"worker-join #{line}: worker {wid} "
                               f"rejoined after loss (ids are never "
                               f"reused)")
                return
            if w.explicit:
                self._viol("double-join", line, f"w{wid}",
                           f"worker-join #{line}: worker {wid} joined "
                           f"twice")
                return
            w.state = "live"
            w.explicit = True
            return
        if type_ == "worker-lost":
            if w.state == "lost":
                self._viol("double-lost", line, f"w{wid}",
                           f"worker-lost #{line}: worker {wid} reported "
                           f"lost twice")
                return
            w.state = "lost"
            return
        if w.state == "new":
            w.state = "live"
        nxt = protocol.WORKER_TRANSITIONS.get((w.state, type_))
        if nxt is None:
            if self.strict:
                self._viol("illegal-transition", line,
                           f"worker:{w.state}:{type_}",
                           f"{type_} #{line}: no edge from worker state "
                           f"{w.state!r} (worker {wid})")
            w.state = "live"
        else:
            w.state = nxt
        if type_ == "spill" and self.strict \
                and wid not in self._dispatched_wids:
            self._viol("spill-without-put", line, f"w{wid}",
                       f"spill #{line}: worker {wid} spilled before any "
                       f"dispatch placed data on it")
        if type_ == "gather":
            for tid in ev.get("tids") or ():
                if int(tid) in self._released:
                    self._viol("gather-after-release", line, str(int(tid)),
                               f"gather #{line}: key {int(tid)} was "
                               f"already released")

    # -- epoch ledger --------------------------------------------------
    def _epoch_event(self, type_: str, ev: dict, line: int) -> None:
        eid = int(ev["eid"])
        if type_ == "epoch-open":
            self._epochs[eid] = {"lo": int(ev["lo"]), "hi": int(ev["hi"]),
                                 "closed": False, "done": set()}
            return
        e = self._epochs.get(eid)
        if e is None:
            if self.strict:
                self._viol("close-unopened-epoch", line, f"e{eid}",
                           f"epoch-close #{line}: epoch {eid} was never "
                           f"opened")
            return
        if e["closed"]:
            self._viol("double-epoch-close", line, f"e{eid}",
                       f"epoch-close #{line}: epoch {eid} closed twice")
            return
        e["closed"] = True
        if ev.get("error") is None and self.strict:
            pending = [t for t in range(e["lo"], e["hi"])
                       if t not in e["done"] and t not in self._released]
            if pending:
                self._viol("epoch-close-with-pending", line, f"e{eid}",
                           f"epoch-close #{line}: epoch {eid} closed "
                           f"clean with {len(pending)} non-terminal "
                           f"task(s), e.g. {pending[:5]}")
        e["done"] = set()       # membership ledger no longer needed


class ConformanceSink:
    """Online conformance: attach to an :class:`EventBus` via
    ``add_sink``.  Crash-contained twice over — the bus swallows sink
    exceptions, and the sink itself catches checker errors and counts
    them instead of losing the stream.  Pass ``windowed=True`` when
    attaching to a bus that has already dropped events
    (``bus.n_dropped > 0``); seq gaps downgrade automatically either
    way, so a late attach never manufactures false positives."""

    def __init__(self, *, path: str = "<live>", windowed: bool = False,
                 max_findings: int = 1000):
        self._checker = TraceChecker(path=path, windowed=windowed,
                                     max_findings=max_findings)
        self.n_internal_errors = 0

    def __call__(self, ev: dict) -> None:
        try:
            self._checker.feed(ev)
        except Exception:
            self.n_internal_errors += 1

    @property
    def findings(self) -> list[Finding]:
        return self._checker.findings

    @property
    def n_events(self) -> int:
        return self._checker.n_events

    @property
    def n_gaps(self) -> int:
        return self._checker.n_gaps

    @property
    def strict(self) -> bool:
        return self._checker.strict

    def close(self) -> None:    # sinks may expose close(); nothing to do
        pass


# ---------------------------------------------------------------------------
# offline entry: JSONL logs -> findings (allowlist-aware)
# ---------------------------------------------------------------------------

def load_trace(path: str | os.PathLike, max_rotations: int = 16
               ) -> list[dict]:
    """Read a (possibly rotated) JSONL event log oldest-first.  Local
    twin of ``repro_torch.core.events.load_jsonl`` so the checker keeps its
    no-runtime-imports property."""
    path = os.fspath(path)
    files = [f"{path}.{i}" for i in range(max_rotations, 0, -1)
             if os.path.exists(f"{path}.{i}")]
    if os.path.exists(path):
        files.append(path)
    events: list[dict] = []
    for fname in files:
        with open(fname, "r", encoding="utf-8") as fh:
            for ln in fh:
                ln = ln.strip()
                if not ln:
                    continue
                try:
                    events.append(json.loads(ln))
                except ValueError:
                    continue
    return events


def run_trace(paths, allowlist=engine.DEFAULT_ALLOWLIST
              ) -> tuple[list[Finding], int]:
    """Conformance-check JSONL logs; same contract as
    ``engine.run_rules``: (surviving findings, n_suppressed)."""
    found: list[Finding] = []
    for p in paths:
        label = Path(p).as_posix()
        events = load_trace(p)
        if not events:
            found.append(Finding(
                "RA0", label, 0, "trace is missing or empty",
                key=f"RA0:no-trace:{Path(p).name}"))
            continue
        checker = TraceChecker(path=label)
        checker.check_many(events)
        found.extend(checker.findings)
        if checker.n_overflow:
            found.append(Finding(
                "RA0", label, 0,
                f"{checker.n_overflow} further finding(s) suppressed "
                f"past the {checker.max_findings} cap", severity="warn",
                key=f"RA0:finding-overflow:{Path(p).name}"))
    allow, problems = engine.load_allowlist(allowlist)
    kept = [f for f in found if f.key not in allow]
    n_suppressed = len(found) - len(kept)
    used = {f.key for f in found if f.key in allow}
    kept.extend(problems)
    for key in sorted(set(allow) - used):
        if key.split(":", 1)[0] in TRACE_RULES:
            kept.append(Finding(
                "RA0", Path(str(allowlist)).name, 0,
                f"allowlist entry {key!r} matches no finding "
                f"(fixed? delete the entry)", severity="warn",
                key=f"RA0:unused:{key}"))
    kept.sort(key=lambda f: (f.rule, f.path, f.line, f.message))
    return kept, n_suppressed
