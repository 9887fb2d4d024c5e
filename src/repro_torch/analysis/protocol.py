"""Executable spec of the server<->worker protocol (the runtime's event
vocabulary).

This module is the machine-readable definition of a *legal execution*:
per-task and per-worker finite state machines over the event vocabulary
published by ``repro_torch.core`` (``EVENT_TYPES`` in ``core/events.py``),
plus the registry of cross-entity invariants the trace checker
(:mod:`repro_torch.analysis.trace`) enforces.  Everything here is a **pure
literal** — no imports of runtime modules, no computed values — for two
reasons:

* the static rules (RA6/RA7/RA8) diff this spec against the runtime's
  vocabulary, the checker implementation and ``docs/protocol.md`` by
  *parsing source text with ast*, same as every other analysis rule, so
  fixtures can seed drift and the checker never needs numpy/msgpack;
* the spec must stay independently auditable: what you read below IS
  the contract, not code that computes one.

The state machines deliberately model the runtime's documented races —
they are part of the protocol, not noise:

* **steal retraction is optimistic over a wire** — a retract frame can
  lose the race against the worker popping the task, so a stolen task
  may legally finish on its *old* worker too (the reactor dedups).
  Hence finishes are validated against the *dispatch-credential ledger*
  (every ``task-dispatched``/re-dispatch grants ``(tid, wid)`` one
  finish credential), not against "the last dispatch target".
* **worker-lost vs in-flight finish** — a completion sent before the
  loss was noticed may be processed after ``worker-lost`` (the inproc
  inbox is not filtered by liveness).  A finish from a lost worker is
  therefore legal iff a credential from *before* the loss is still
  outstanding; without one it is a ``lost-worker-finish`` violation.
* **re-dispatch edges** — steal (``stolen -> queued``), fetch-failure
  parking (``dispatched -> parked -> dispatched``), rehints, and
  lost-worker resubmission (``* -> queued``, including ``finished ->
  queued`` for lineage re-execution) all re-enter the dispatch cycle.
"""
from __future__ import annotations

#: Spec-side copy of the event vocabulary: type -> required payload
#: fields beyond the ``v``/``seq``/``t``/``type`` envelope.  RA6 pins
#: this against ``EVENT_TYPES`` in ``core/events.py`` type-for-type and
#: field-for-field, so the two cannot drift.
EVENT_FIELDS = {
    "stream-open": ("wall", "pid"),
    "epoch-open": ("eid", "n_tasks", "lo", "hi"),
    "epoch-close": ("eid", "error"),
    "task-queued": ("tid", "wid"),
    "task-dispatched": ("tid", "wid"),
    "task-started": ("tid", "wid"),
    "task-finished": ("tid", "wid"),
    "task-steal": ("tid", "wid"),
    "steal-failed": ("tid",),
    "task-rehint": ("tid", "wid"),
    "fetch-failed": ("tid", "wid", "n_missing"),
    "task-timing": ("tid", "wid", "recv", "start", "end", "fetch"),
    "worker-join": ("wid",),
    "worker-lost": ("wid", "n_lost"),
    "worker-pressure": ("wid", "pressured", "mem_bytes"),
    "spill": ("wid", "nbytes"),
    "unspill": ("wid", "nbytes"),
    "gather": ("wid", "n"),
    "gather-reply": ("wid", "n_present", "n_absent"),
    "release": ("n",),
    "compact": ("base",),
    "request-enter": ("rid", "tenant"),
    "request-admit": ("rid", "tenant", "slot"),
    "request-exit": ("rid", "tenant", "n_tokens", "latency_s"),
    "train-step": ("step", "makespan"),
    "span": ("sid", "parent", "name", "thread", "t0", "t1", "rid", "step",
             "attrs"),
}

#: Partition of the vocabulary by which state machine consumes it.
#: Every type must be in exactly one set (RA6 checks the partition).
TASK_EVENTS = (
    "task-queued", "task-dispatched", "task-started", "task-finished",
    "task-steal", "steal-failed", "task-rehint", "fetch-failed",
)
WORKER_EVENTS = (
    "worker-join", "worker-lost", "worker-pressure", "spill", "unspill",
    "gather", "gather-reply",
)
EPOCH_EVENTS = ("epoch-open", "epoch-close")
#: No per-entity state: envelope/field/ledger checks only.
#: ``task-timing`` is stateless by design: it reports worker-clock
#: measurements about an already-validated finish, and may legally
#: arrive for a task whose worker was since lost (in-flight frame).
STATELESS_EVENTS = (
    "stream-open", "release", "compact", "task-timing",
    "request-enter", "request-admit", "request-exit", "train-step",
    "span",
)

TASK_STATES = ("new", "queued", "dispatched", "running", "parked",
               "stolen", "finished")
WORKER_STATES = ("new", "live", "lost")

#: Per-task machine: ``(state, event) -> state``.  ``task-started`` and
#: ``task-finished`` are additionally guarded by the dispatch-credential
#: ledger (see module docstring); a ``(state, event)`` pair absent from
#: this table is an ``illegal-transition`` violation.
TASK_TRANSITIONS = {
    ("new", "task-queued"): "queued",
    ("queued", "task-dispatched"): "dispatched",
    # a lost-worker resubmission can land while a worker thread is
    # between popping the task and publishing task-started
    ("queued", "task-started"): "queued",
    ("dispatched", "task-dispatched"): "dispatched",
    ("dispatched", "task-queued"): "queued",
    ("dispatched", "task-started"): "running",
    ("dispatched", "task-finished"): "finished",
    ("dispatched", "task-steal"): "stolen",
    ("dispatched", "steal-failed"): "dispatched",
    ("dispatched", "fetch-failed"): "parked",
    ("dispatched", "task-rehint"): "dispatched",
    ("running", "task-finished"): "finished",
    ("running", "steal-failed"): "running",
    ("running", "task-queued"): "queued",
    ("parked", "task-dispatched"): "dispatched",
    ("parked", "fetch-failed"): "parked",
    ("parked", "task-queued"): "queued",
    ("stolen", "task-queued"): "queued",
    ("finished", "task-queued"): "queued",
    ("finished", "task-finished"): "finished",
    # redundant-copy race: a lost worker's in-flight finish completes
    # the task while its resubmitted copy is still live elsewhere; the
    # copy can then be rebalanced — or popped — before the reactor's
    # dedup makes it moot
    ("finished", "task-steal"): "stolen",
    ("finished", "task-started"): "running",
}

#: Per-worker machine.  ``worker-join`` on an implicitly-joined worker
#: records the explicit join (elastic scale-up publishes no join, so
#: first activity implies membership); a second *explicit* join is a
#: ``double-join`` violation, a second loss a ``double-lost`` one.
WORKER_TRANSITIONS = {
    ("new", "worker-join"): "live",
    ("live", "worker-join"): "live",
    ("live", "worker-lost"): "lost",
    ("live", "worker-pressure"): "live",
    ("live", "spill"): "live",
    ("live", "unspill"): "live",
    ("live", "gather"): "live",
    ("live", "gather-reply"): "live",
    ("lost", "gather-reply"): "lost",
}

#: Every violation kind the conformance checker can emit: id ->
#: (owning rule, one-line contract).  RA7 statically requires
#: :data:`repro_torch.analysis.trace.TraceChecker.IMPLEMENTS` to equal this
#: key set; RA8 requires ``docs/protocol.md`` to list it row-for-row.
INVARIANTS = {
    # RA6 — state-machine / credential guards
    "finish-without-dispatch": (
        "RA6", "a task finishes only on a worker holding an outstanding"
               " dispatch credential for it"),
    "double-finish": (
        "RA6", "one finish per dispatch credential: a repeat finish"
               " from the same worker without a re-dispatch is illegal"),
    "lost-worker-finish": (
        "RA6", "a finish from a lost worker is legal only as an"
               " in-flight completion dispatched before the loss"),
    "start-without-dispatch": (
        "RA6", "task-started requires an outstanding dispatch"
               " credential on that worker"),
    "dispatch-to-lost": (
        "RA6", "queue/dispatch/steal never target a worker already"
               " reported lost (the server reroutes first)"),
    "double-join": (
        "RA6", "a worker id joins explicitly at most once (ids are"
               " never reused)"),
    "double-lost": (
        "RA6", "a worker id is reported lost at most once"),
    "illegal-transition": (
        "RA6", "every event must match a declared state-machine edge"
               " for its entity"),
    # RA7 — cross-entity invariants
    "out-of-order-seq": (
        "RA7", "envelope seq is strictly increasing within a stream"),
    "missing-field": (
        "RA7", "every event of a known type carries the envelope and"
               " its declared required fields"),
    "negative-ledger": (
        "RA7", "byte/count ledger fields never go negative (worker-lost"
               " n_lost=-1 is a documented sentinel, not a count)"),
    "gather-after-release": (
        "RA7", "gather never targets a released key"),
    "spill-without-put": (
        "RA7", "a worker spills only after a put, i.e. after at least"
               " one dispatch placed work (and thus data) on it"),
    "epoch-close-with-pending": (
        "RA7", "a clean epoch-close (error=None) implies every member"
               " task is terminal (finished or released)"),
    "close-unopened-epoch": (
        "RA7", "epoch-close refers to a previously opened epoch id"),
    "double-epoch-close": (
        "RA7", "an epoch id closes at most once"),
}

#: ``worker-lost`` uses ``n_lost=-1`` as a "queue snapshot reclaimed by
#: the caller" sentinel (see ``ServerCore._worker_lost``), so that field
#: is exempt from the negative-ledger check.
LEDGER_FIELDS = {
    "worker-pressure": ("mem_bytes",),
    "spill": ("nbytes",),
    "unspill": ("nbytes",),
    "gather": ("n",),
    "gather-reply": ("n_present", "n_absent"),
    "release": ("n",),
    "epoch-open": ("n_tasks",),
    "fetch-failed": ("n_missing",),
}

#: The shared node-level store of the in-process drivers publishes
#: spill/unspill with this pseudo worker id; it never joins or dies.
SHARED_STORE_WID = -1


def initial_task_state() -> str:
    return TASK_STATES[0]


def initial_worker_state() -> str:
    return WORKER_STATES[0]


def event_rule(kind: str) -> str:
    """Owning rule id ("RA6"/"RA7") for a violation kind."""
    return INVARIANTS[kind][0]
