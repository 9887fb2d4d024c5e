"""Benchmark task graphs (paper §V, Table I).

A copy of :mod:`repro.core.benchgraphs` for the port: the same seeds give
the same graphs.

Each generator reproduces the *structure* of the corresponding Dask
workload; durations and output sizes are drawn around the Table I averages
(AD [ms], S [KiB]) with seeded lognormal jitter, so the simulated suite has
the same #T / #I / LP / AD / S profile as the paper's measured one.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core.graph import Task, TaskGraph


def _sizes(rng, n, mean_kib, sigma=0.5):
    if mean_kib <= 0:
        return np.zeros(n)
    mu = math.log(mean_kib * 1024.0) - sigma ** 2 / 2
    return rng.lognormal(mu, sigma, size=n)


def _durs(rng, n, mean_ms, sigma=0.4):
    mu = math.log(max(mean_ms, 1e-4) / 1e3) - sigma ** 2 / 2
    return rng.lognormal(mu, sigma, size=n)


def merge(n: int, dur_ms: float = 0.006, size_kib: float = 0.027,
          seed: int = 0) -> TaskGraph:
    """n independent trivial tasks merged by one final task (LP=1)."""
    rng = np.random.default_rng(seed)
    durs = _durs(rng, n + 1, dur_ms)
    sizes = _sizes(rng, n + 1, size_kib)
    tasks = [Task(i, (), durs[i], sizes[i]) for i in range(n)]
    tasks.append(Task(n, tuple(range(n)), durs[n], sizes[n]))
    return TaskGraph(tasks, name=f"merge-{n}")


def merge_slow(n: int, t_sec: float, seed: int = 0) -> TaskGraph:
    g = merge(n, dur_ms=t_sec * 1e3, size_kib=0.023, seed=seed)
    g.name = f"merge_slow-{n}-{t_sec}"
    return g


def tree(levels: int, dur_ms: float = 0.007, size_kib: float = 0.027,
         seed: int = 0) -> TaskGraph:
    """Binary-tree reduction of 2**levels numbers: the first task layer
    consumes raw pairs, so #T = 2**levels - 1 and LP = levels - 1
    (paper tree-15: 32767 tasks, LP 14)."""
    rng = np.random.default_rng(seed)
    tasks: list[Task] = []
    prev = []
    for i in range(2 ** (levels - 1)):
        tasks.append(Task(len(tasks), (), _durs(rng, 1, dur_ms)[0],
                          _sizes(rng, 1, size_kib)[0]))
        prev.append(tasks[-1].tid)
    while len(prev) > 1:
        nxt = []
        for i in range(0, len(prev), 2):
            tasks.append(Task(len(tasks), (prev[i], prev[i + 1]),
                              _durs(rng, 1, dur_ms)[0],
                              _sizes(rng, 1, size_kib)[0]))
            nxt.append(tasks[-1].tid)
        prev = nxt
    return TaskGraph(tasks, name=f"tree-{levels}")


def _map_stage(tasks, rng, parents, fanout, dur_ms, size_kib):
    out = []
    for p in parents:
        for _ in range(fanout):
            tasks.append(Task(len(tasks), (p,), _durs(rng, 1, dur_ms)[0],
                              _sizes(rng, 1, size_kib)[0]))
            out.append(tasks[-1].tid)
    return out


def _reduce_stage(tasks, rng, parents, arity, dur_ms, size_kib):
    out = []
    for i in range(0, len(parents), arity):
        grp = tuple(parents[i:i + arity])
        tasks.append(Task(len(tasks), grp, _durs(rng, 1, dur_ms)[0],
                          _sizes(rng, 1, size_kib)[0]))
        out.append(tasks[-1].tid)
    return out


def xarray(parts: int, stages: int = 4, dur_ms: float = 3.1,
           size_kib: float = 55.7, seed: int = 0) -> TaskGraph:
    """Gridded aggregation: per-partition map chains + tree reduces."""
    rng = np.random.default_rng(seed)
    tasks: list[Task] = []
    layer = [Task(i, (), _durs(rng, 1, dur_ms)[0],
                  _sizes(rng, 1, size_kib)[0]) for i in range(parts)]
    tasks.extend(layer)
    cur = [t.tid for t in layer]
    for _ in range(stages):
        cur = _map_stage(tasks, rng, cur, 1, dur_ms, size_kib)
    while len(cur) > 1:
        cur = _reduce_stage(tasks, rng, cur, 4, dur_ms, size_kib)
    return TaskGraph(tasks, name=f"xarray-{parts}")


def bag(parts: int, dur_ms: float = 13.9, size_kib: float = 3.2,
        seed: int = 0) -> TaskGraph:
    """Cartesian product + filter + aggregation (dask.bag)."""
    rng = np.random.default_rng(seed)
    tasks = [Task(i, (), _durs(rng, 1, dur_ms)[0],
                  _sizes(rng, 1, size_kib)[0]) for i in range(parts)]
    pairs = []
    for i in range(parts):
        for j in range(parts):
            tasks.append(Task(len(tasks), (i, j), _durs(rng, 1, dur_ms)[0],
                              _sizes(rng, 1, size_kib)[0]))
            pairs.append(tasks[-1].tid)
    filt = _map_stage(tasks, rng, pairs, 1, dur_ms / 2, size_kib / 2)
    cur = filt
    while len(cur) > 1:
        cur = _reduce_stage(tasks, rng, cur, 8, dur_ms, size_kib)
    return TaskGraph(tasks, name=f"bag-{parts}")


def numpy_transpose(parts: int, dur_ms: float = 2.6, size_kib: float = 760,
                    seed: int = 0) -> TaskGraph:
    """Transpose + aggregate a (p x p)-blocked array (dask.array)."""
    rng = np.random.default_rng(seed)
    tasks: list[Task] = []
    blocks = {}
    for i in range(parts):
        for j in range(parts):
            tasks.append(Task(len(tasks), (), _durs(rng, 1, dur_ms)[0],
                              _sizes(rng, 1, size_kib)[0]))
            blocks[i, j] = tasks[-1].tid
    summed = {}
    for i in range(parts):
        for j in range(parts):
            tasks.append(Task(len(tasks), (blocks[i, j], blocks[j, i]),
                              _durs(rng, 1, dur_ms)[0],
                              _sizes(rng, 1, size_kib)[0]))
            summed[i, j] = tasks[-1].tid
    rows = [_reduce_stage(tasks, rng, [summed[i, j] for j in range(parts)],
                          parts, dur_ms, size_kib)[0] for i in range(parts)]
    _reduce_stage(tasks, rng, rows, parts, dur_ms, size_kib)
    return TaskGraph(tasks, name=f"numpy-{parts}")


def shuffle(parts: int, out_parts: int | None = None, dur_ms: float = 7.7,
            size_kib: float = 503, stages: int = 2, seed: int = 0,
            name: str = "groupby") -> TaskGraph:
    """Map -> all-to-all shuffle -> aggregate (groupby / join shape)."""
    rng = np.random.default_rng(seed)
    out_parts = out_parts or parts
    tasks = [Task(i, (), _durs(rng, 1, dur_ms)[0],
                  _sizes(rng, 1, size_kib)[0]) for i in range(parts)]
    cur = [t.tid for t in tasks]
    for _ in range(stages - 1):
        cur = _map_stage(tasks, rng, cur, 1, dur_ms, size_kib)
    splits = []
    for p in cur:  # split each input partition into out_parts shards
        splits.append(_map_stage(tasks, rng, [p], out_parts, dur_ms / 4,
                                 size_kib / out_parts))
    outs = []
    for o in range(out_parts):  # each output gathers one shard per input
        grp = tuple(s[o] for s in splits)
        tasks.append(Task(len(tasks), grp, _durs(rng, 1, dur_ms)[0],
                          _sizes(rng, 1, size_kib)[0]))
        outs.append(tasks[-1].tid)
    while len(outs) > 1:
        outs = _reduce_stage(tasks, rng, outs, 8, dur_ms, size_kib)
    return TaskGraph(tasks, name=f"{name}-{parts}")


def pipeline(parts: int, stages: int = 4, dur_ms: float = 33.0,
             size_kib: float = 15.3, seed: int = 0,
             name: str = "vectorizer") -> TaskGraph:
    """Per-partition map pipeline + concat (wordbatch vectorizer shape)."""
    rng = np.random.default_rng(seed)
    tasks = [Task(i, (), _durs(rng, 1, dur_ms)[0],
                  _sizes(rng, 1, size_kib)[0]) for i in range(parts)]
    cur = [t.tid for t in tasks]
    for _ in range(stages - 1):
        cur = _map_stage(tasks, rng, cur, 1, dur_ms, size_kib)
    tasks.append(Task(len(tasks), tuple(cur), _durs(rng, 1, dur_ms)[0],
                      _sizes(rng, 1, size_kib)[0]))
    return TaskGraph(tasks, name=f"{name}-{parts}")


# ---------------------------------------------------------------------------
# The benchmark suite (paper Table I subset used in the evaluation figures)
# ---------------------------------------------------------------------------

def _vr_leaf(v):
    return v


def _vr_agg(*vals):
    return sum(vals)


def _ar_leaf(i, n):
    return np.full(n, float(i + 1))


def _ar_sum(*vals):
    out = vals[0].copy()
    for v in vals[1:]:
        out += v
    return out


def _ar_total(*vals):
    return float(sum(float(v.sum()) for v in vals))


def value_reduction(n_leaves: int = 12, fan: int = 0) -> TaskGraph:
    """Value-carrying reduction for the wall-clock engines (real
    payloads cross the wire): ``n_leaves`` leaves producing ``i + 1``,
    an optional partial-sum layer every ``fan`` leaves (``fan=0`` skips
    it), and a total-sum sink.  The sink's expected value is
    ``n_leaves * (n_leaves + 1) / 2``."""
    tasks = [Task(i, (), fn=_vr_leaf, args=(i + 1,))
             for i in range(n_leaves)]
    if fan > 0:
        mids = []
        for j in range(0, n_leaves, fan):
            tid = len(tasks)
            tasks.append(Task(tid, tuple(range(j, min(j + fan, n_leaves))),
                              fn=_vr_agg))
            mids.append(tid)
        tasks.append(Task(len(tasks), tuple(mids), fn=_vr_agg))
    else:
        tasks.append(Task(n_leaves, tuple(range(n_leaves)), fn=_vr_agg))
    return TaskGraph(tasks, name="reduce")


def array_reduction(n_leaves: int = 16, elems: int = 1024,
                    fan: int = 4) -> TaskGraph:
    """Array-carrying reduction for the memory subsystem: each leaf
    produces an ``elems``-long float64 array (so the live intermediate
    set has a real, controllable byte footprint), partial sums every
    ``fan`` leaves, and a scalar total sink.  Expected sink value:
    ``elems * n_leaves * (n_leaves + 1) / 2``.  Run it with a
    ``memory_limit`` below ``n_leaves * elems * 8`` bytes to force the
    workers' object stores to spill."""
    tasks = [Task(i, (), fn=_ar_leaf, args=(i, elems),
                  output_size=float(elems * 8))
             for i in range(n_leaves)]
    mids = []
    for j in range(0, n_leaves, fan):
        tid = len(tasks)
        tasks.append(Task(tid, tuple(range(j, min(j + fan, n_leaves))),
                          fn=_ar_sum, output_size=float(elems * 8)))
        mids.append(tid)
    tasks.append(Task(len(tasks), tuple(mids), fn=_ar_total,
                      output_size=8.0))
    return TaskGraph(tasks, name="array-reduce")


def suite(scale: float = 1.0, seed: int = 0) -> list[TaskGraph]:
    """The diverse benchmark set.  ``scale`` < 1 shrinks task counts for CI
    while keeping every structural family."""
    s = lambda n: max(int(n * scale), 2)
    return [
        merge(s(10000), seed=seed),
        merge(s(25000), seed=seed),
        merge_slow(s(5000), 0.1, seed=seed),
        tree(max(int(15 + math.log2(scale or 1)), 4), seed=seed),
        xarray(s(500), dur_ms=3.1, size_kib=55.7, seed=seed),
        bag(max(int(14 * math.sqrt(scale)), 3), seed=seed),
        numpy_transpose(max(int(38 * math.sqrt(scale)), 3), dur_ms=2.6,
                        size_kib=760, seed=seed),
        shuffle(s(150), dur_ms=11.9, size_kib=1005, seed=seed,
                name="groupby"),
        shuffle(s(75), dur_ms=7.7, size_kib=503, seed=seed, name="join"),
        pipeline(s(300), stages=3, dur_ms=33.0, size_kib=15.3, seed=seed,
                 name="vectorizer"),
        pipeline(s(100), stages=5, dur_ms=301.0, size_kib=5136, seed=seed,
                 name="wordbag"),
    ]


GENERATORS = {
    "merge": merge, "merge_slow": merge_slow, "tree": tree,
    "xarray": xarray, "bag": bag, "numpy": numpy_transpose,
    "groupby": shuffle, "join": shuffle, "vectorizer": pipeline,
    "wordbag": pipeline,
}
