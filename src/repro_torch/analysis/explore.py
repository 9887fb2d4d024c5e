"""Deterministic schedule exploration: permute delivery order, check
every interleaving against the protocol spec, shrink failures.

Two drivers:

* :func:`explore_sim` — the virtual-time simulator under a seeded
  :class:`Controller` that, at every step, picks among the ``width``
  earliest pending events instead of always the earliest.  With
  ``fixed_server_cost`` the whole run is a pure function of the
  decision list, so any conformance violation replays from ``(seed,
  decisions)`` and shrinks to a minimal decision list
  (:func:`shrink`, delta-debugging where decision ``0`` == "follow the
  normal heap order").
* :func:`explore_inproc` — the real thread runtime with a
  :class:`BatchPerturb` hook on ``ServerCore.schedule_hook`` that
  defers a seeded subset of each control batch's completion records to
  the next loop tick, reordering finish processing the way a slow wire
  would.  The worker threads stay genuinely concurrent, so this axis is
  reproducible in distribution, not per-run — violations report the
  seed, not a replayable decision list.

Every interleaving's event stream is validated by
:class:`repro_torch.analysis.trace.TraceChecker`; distinct interleavings are
counted by fingerprinting the control-plane event order.
"""
from __future__ import annotations

import dataclasses
import itertools
import random

from repro_torch.analysis.trace import TraceChecker


class Controller:
    """Schedule controller for ``Simulator._pop``.

    Replays a fixed ``decisions`` list (out-of-range or exhausted
    entries fall back to ``0`` == earliest event — that is what makes
    zeroing/truncating decisions a valid shrink move), or random-walks
    from ``seed``.  Every choice actually taken is recorded in
    ``taken`` for later shrinking.
    """

    def __init__(self, *, seed: int | None = None, decisions=None,
                 width: int = 3):
        self.width = width
        self._fixed = None if decisions is None else [int(d) for d
                                                      in decisions]
        self._rng = random.Random(seed)
        self._i = 0
        self.taken: list[int] = []

    def choose(self, n: int) -> int:
        if self._fixed is not None:
            d = (self._fixed[self._i] if self._i < len(self._fixed)
                 else 0) % n
            self._i += 1
        else:
            d = self._rng.randrange(n)
        self.taken.append(d)
        return d


def shrink(decisions, still_fails) -> list[int]:
    """Minimize a failing decision list, deterministically.

    ``still_fails(candidate)`` must re-run the schedule and report
    whether the violation persists.  Three passes: binary-search the
    shortest failing prefix, zero out single surviving decisions
    (``0`` follows the normal heap order), drop trailing zeros (the
    controller defaults to ``0`` past the list, so that is a pure
    no-op rewrite, verified once at the end).
    """
    best = [int(d) for d in decisions]
    lo, hi = 0, len(best)
    while lo < hi:
        mid = (lo + hi) // 2
        if still_fails(best[:mid]):
            hi = mid
        else:
            lo = mid + 1
    best = best[:hi]
    for i in range(len(best)):
        if best[i] != 0:
            cand = best[:i] + [0] + best[i + 1:]
            if still_fails(cand):
                best = cand
    while best and best[-1] == 0:
        best.pop()
    assert still_fails(best)
    return best


@dataclasses.dataclass
class ScheduleFailure:
    seed: int | None            # replay seed (sim: with decisions)
    decisions: list             # shrunk decision list (sim) or []
    finding_keys: list          # conformance finding keys
    n_events: int

    def __str__(self) -> str:
        return (f"seed={self.seed} decisions={self.decisions} "
                f"findings={self.finding_keys}")


@dataclasses.dataclass
class ExploreResult:
    n_runs: int
    n_distinct: int             # distinct control-plane event orders
    violations: list            # [ScheduleFailure]
    seed: int
    width: int = 0

    @property
    def ok(self) -> bool:
        return not self.violations


def _fingerprint(events) -> int:
    return hash(tuple((e.get("type"), e.get("tid"), e.get("wid"))
                      for e in events))


def _check(events, label: str):
    checker = TraceChecker(path=label)
    checker.check_many(events)
    return checker.findings


# ---------------------------------------------------------------------------
# simulator axis
# ---------------------------------------------------------------------------

def _run_sim(graph, server, *, n_workers, width, timeout,
             decisions=None, seed=None, failures=()):
    """One fully deterministic simulated schedule; returns (events,
    controller)."""
    from repro_torch.core.events import EventBus
    from repro_torch.core.simulator import simulate

    captured: list[dict] = []
    bus = EventBus()
    bus.add_sink(captured.append)
    ctl = Controller(seed=seed, decisions=decisions, width=width)
    simulate(graph, server=server, n_workers=n_workers, timeout=timeout,
             events=bus, controller=ctl, fixed_server_cost=50e-6,
             failures=failures)
    return captured, ctl


def explore_sim(server: str = "rsds", *, graph=None, n_workers: int = 4,
                n_schedules: int = 200, seed: int = 0, width: int = 3,
                depth: int = 3, failures=(), timeout: float = 60.0,
                trace_mutator=None, max_attempts: int | None = None
                ) -> ExploreResult:
    """Explore until ``n_schedules`` *distinct* interleavings ran (or
    ``max_attempts``), conformance-checking each.  Systematic
    small-depth reorderings first (every decision prefix up to
    ``depth``), then seeded random walks.  ``trace_mutator(events,
    run_index)`` is a test hook that corrupts the recorded stream
    before checking."""
    if graph is None:
        from repro_torch.core import benchgraphs
        graph = benchgraphs.merge(40)
    if max_attempts is None:
        max_attempts = 5 * n_schedules
    systematic = [list(t) for k in range(1, depth + 1)
                  for t in itertools.product(range(width), repeat=k)]
    prints: set[int] = set()
    violations: list[ScheduleFailure] = []
    runs = 0
    while len(prints) < n_schedules and runs < max_attempts:
        if runs < len(systematic):
            decisions, walk_seed = systematic[runs], None
        else:
            decisions, walk_seed = None, seed * 100_003 + runs
        events, ctl = _run_sim(graph, server, n_workers=n_workers,
                               width=width, timeout=timeout,
                               decisions=decisions, seed=walk_seed,
                               failures=failures)
        if trace_mutator is not None:
            events = trace_mutator(events, runs)
        run_i = runs
        runs += 1
        prints.add(_fingerprint(events))
        findings = _check(events, f"<sim:{server} run={run_i}>")
        if not findings:
            continue

        def still_fails(cand, _i=run_i):
            evs, _ = _run_sim(graph, server, n_workers=n_workers,
                              width=width, timeout=timeout,
                              decisions=cand, failures=failures)
            if trace_mutator is not None:
                evs = trace_mutator(evs, _i)
            return bool(_check(evs, "<shrink>"))

        taken = list(ctl.taken)
        shrunk = (shrink(taken, still_fails) if still_fails(taken)
                  else taken)  # non-replayable mutators keep the walk
        violations.append(ScheduleFailure(
            seed=walk_seed, decisions=shrunk,
            finding_keys=[f.key for f in findings],
            n_events=len(events)))
    return ExploreResult(n_runs=runs, n_distinct=len(prints),
                         violations=violations, seed=seed, width=width)


# ---------------------------------------------------------------------------
# inproc (thread-runtime) axis
# ---------------------------------------------------------------------------

class BatchPerturb:
    """``ServerCore.schedule_hook``: defer a seeded subset of each
    control batch's ``finished`` records to the next loop tick.  The
    loop polls on a timeout, so every tick flushes the previous hold —
    nothing is ever lost, only reordered across batch boundaries."""

    def __init__(self, seed: int = 0, defer_p: float = 0.4):
        self._rng = random.Random(seed)
        self.defer_p = defer_p
        self._held: list = []

    def __call__(self, events):
        out, self._held = self._held, []
        for ev in events:
            if ev[0] == "finished" and self._rng.random() < self.defer_p:
                self._held.append(ev)
            else:
                out.append(ev)
        return out


def explore_inproc(server: str = "rsds", *, graph=None,
                   n_schedules: int = 10, seed: int = 0,
                   n_workers: int = 3, timeout: float = 30.0
                   ) -> ExploreResult:
    """Run the real thread runtime ``n_schedules`` times with seeded
    batch perturbation, conformance-checking each recorded stream."""
    from repro_torch.core import run_graph
    from repro_torch.core.events import EventBus
    from repro_torch.core.server import ServerCore

    if graph is None:
        from repro_torch.core import benchgraphs
        graph = benchgraphs.merge(40)
    prints: set[int] = set()
    violations: list[ScheduleFailure] = []
    for i in range(n_schedules):
        run_seed = seed * 7919 + i
        captured: list[dict] = []
        bus = EventBus()
        bus.add_sink(captured.append)
        hook = BatchPerturb(seed=run_seed)
        orig_init = ServerCore.__init__

        def patched(self, *a, _orig=orig_init, _bus=bus, _hook=hook,
                    **kw):
            kw["events"] = _bus
            _orig(self, *a, **kw)
            self.schedule_hook = _hook

        ServerCore.__init__ = patched
        try:
            r = run_graph(graph, server=server, runtime="thread",
                          n_workers=n_workers, simulate_durations=False,
                          timeout=timeout)
        finally:
            ServerCore.__init__ = orig_init
        if r.timed_out:
            raise TimeoutError(
                f"perturbed inproc run timed out (seed={run_seed})")
        prints.add(_fingerprint(captured))
        findings = _check(captured, f"<inproc:{server} seed={run_seed}>")
        if findings:
            violations.append(ScheduleFailure(
                seed=run_seed, decisions=[],
                finding_keys=[f.key for f in findings],
                n_events=len(captured)))
    return ExploreResult(n_runs=n_schedules, n_distinct=len(prints),
                         violations=violations, seed=seed)
