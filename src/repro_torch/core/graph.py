"""Task graph representation (paper §III-A).

A copy of :mod:`repro.core.graph` for the port.

A :class:`TaskGraph` is a DAG whose vertices carry a duration model (for the
simulator / zero-worker studies) and an output size (for transfer-cost
modelling), and optionally a real Python callable (for the wall-clock
runtime).  Both reactor implementations consume the same graph; the
RSDS-style :class:`repro_torch.core.array_reactor.ArrayReactor` uses the CSR
arrays built here.

Graphs are no longer construct-once: :meth:`TaskGraph.extend` appends a
new dense tid range (an *epoch* of tasks), which is how the persistent
:class:`repro_torch.core.client.Cluster` ingests work incrementally.  User-facing
code never has to produce dense topologically-ordered tids by hand —
:class:`GraphBuilder` accepts tasks under arbitrary hashable keys, in any
order (forward references buffer until their dependencies arrive), and
assigns dense tids at flush time.

Storage is amortized for fine-grained submitters: every per-task column
lives in a doubling-capacity buffer (the public arrays are views of the
used prefix), and the consumers CSR absorbs new epoch edges into an
overflow side table that is merged back in bulk only when it has grown to
a constant fraction of the merged part — so a warm ``submit_graph`` epoch
costs O(new tasks) amortized instead of the old full-array
``np.concatenate``/``np.insert`` O(total) rebuild.

Storage is also *bounded* for long-lived clusters: tids stay dense and
global forever, but :meth:`TaskGraph.compact_prefix` advances
``tid_base`` past a fully-released tid prefix and drops those rows from
every column, so row index = ``tid - tid_base``.  The scalar accessors
(:meth:`task`, :meth:`dur_of`, :meth:`size_of`, :meth:`inputs_of`,
:meth:`consumers_of`) translate internally; vectorized consumers of the
raw column views subtract ``tid_base`` themselves.  Compaction finalizes
the dropped keys — their rows (and callables) are unrecoverable, the
same trade Dask makes when it forgets a released key.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Sequence

import numpy as np

_EMPTY_I32 = np.zeros(0, dtype=np.int32)


def grow_to(buf: np.ndarray, used: int, need: int) -> np.ndarray:
    """Amortized-doubling capacity buffer: a buffer with room for ``need``
    entries, copying only the ``used`` prefix when reallocation is due."""
    if need <= len(buf):
        return buf
    out = np.empty(max(need, 2 * len(buf), 16), dtype=buf.dtype)
    out[:used] = buf[:used]
    return out


def csr_gather(indptr: np.ndarray, data: np.ndarray,
               tids: np.ndarray) -> np.ndarray:
    """Vectorized concatenation of CSR rows (no per-row Python loop)."""
    starts = indptr[tids]
    lens = (indptr[tids + 1] - starts).astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=data.dtype)
    offs = np.repeat(starts - np.concatenate(
        ([0], np.cumsum(lens)[:-1])), lens)
    return data[np.arange(total, dtype=np.int64) + offs]


@dataclasses.dataclass
class Task:
    tid: int
    inputs: tuple[int, ...] = ()
    duration: float = 0.0          # seconds (simulated / expected)
    output_size: float = 1024.0    # bytes
    fn: Callable | None = None     # real callable for the wall-clock runtime
    args: tuple = ()
    name: str = ""


class TaskGraph:
    def __init__(self, tasks: Sequence[Task], name: str = "graph"):
        self.name = name
        self.tasks = list(tasks)
        self._validate(self.tasks, 0)
        self._build_arrays()

    @staticmethod
    def _validate(tasks: Sequence[Task], base: int) -> None:
        for i, t in enumerate(tasks, start=base):
            if t.tid != i:
                raise ValueError(f"task ids must be dense, got {t.tid}!={i}")
            for d in t.inputs:
                if not (0 <= d < i):
                    raise ValueError(
                        f"bad dep {d} for task {i} (must be an earlier tid)")

    def extend(self, tasks: Sequence[Task]) -> tuple[int, int]:
        """Append a new epoch of tasks (dense tids continuing from
        ``n_tasks``; inputs may reference any earlier tid, including prior
        epochs).  Returns the appended ``(lo, hi)`` tid range.

        Incremental and amortized: Python-level work is O(new tasks),
        array growth rides the doubling-capacity buffers, and new
        consumer edges land in an overflow side table merged back in
        bulk on a doubling schedule — a long-lived Cluster ingesting
        many epochs pays O(new) per epoch, not O(total)."""
        tasks = list(tasks)
        lo = self.n_tasks
        self._validate(tasks, lo)
        self.tasks.extend(tasks)
        self._append_arrays(tasks)
        return lo, self.n_tasks

    @property
    def n_rows(self) -> int:
        """Stored (non-compacted) rows; row index = tid - tid_base."""
        return self.n_tasks - self.tid_base

    def _build_arrays(self) -> None:
        self.n_tasks = 0
        self.tid_base = 0
        self.n_deps = 0
        self._dur_buf = np.zeros(0, dtype=np.float64)
        self._siz_buf = np.zeros(0, dtype=np.float64)
        self._deg_buf = np.zeros(0, dtype=np.int32)
        self._iflat_buf = np.zeros(0, dtype=np.int32)
        self._iptr_buf = np.zeros(1, dtype=np.int64)
        # consumers CSR: merged part + per-row overflow lists for edges
        # appended since the last compaction
        self._cons_buf = np.zeros(0, dtype=np.int32)
        self._cons_ptr_buf = np.zeros(1, dtype=np.int64)
        self._cons_rows = 0          # rows covered by the merged part
        self._cons_used = 0          # edges in the merged part
        self._extra_cons: dict[int, list[int]] = {}
        self._n_extra = 0
        self._refresh_views()
        if self.tasks:
            self._append_arrays(self.tasks)

    def _refresh_views(self) -> None:
        n = self.n_rows
        self.durations = self._dur_buf[:n]
        self.sizes = self._siz_buf[:n]
        self.in_degree = self._deg_buf[:n]
        self.inputs_flat = self._iflat_buf[:self.n_deps]
        self.inputs_indptr = self._iptr_buf[:n + 1]

    def _append_arrays(self, new: Sequence[Task]) -> None:
        n_old = self.n_rows
        n_new = len(new)
        n = n_old + n_new
        self._dur_buf = grow_to(self._dur_buf, n_old, n)
        self._dur_buf[n_old:n] = [t.duration for t in new]
        self._siz_buf = grow_to(self._siz_buf, n_old, n)
        self._siz_buf[n_old:n] = [t.output_size for t in new]
        new_deg = np.fromiter((len(t.inputs) for t in new),
                              dtype=np.int32, count=n_new)
        self._deg_buf = grow_to(self._deg_buf, n_old, n)
        self._deg_buf[n_old:n] = new_deg
        tot_new = int(new_deg.sum())
        # inputs CSR: rows arrive in tid order, so flat inputs and the
        # indptr are pure appends into the capacity buffers
        if tot_new:
            new_flat = np.concatenate(
                [np.asarray(t.inputs, dtype=np.int32) for t in new])
            self._iflat_buf = grow_to(self._iflat_buf, self.n_deps,
                                      self.n_deps + tot_new)
            self._iflat_buf[self.n_deps:self.n_deps + tot_new] = new_flat
        self._iptr_buf = grow_to(self._iptr_buf, n_old + 1, n + 1)
        self._iptr_buf[n_old + 1:n + 1] = \
            self._iptr_buf[n_old] + np.cumsum(new_deg, dtype=np.int64)
        self.n_deps += tot_new
        # consumers CSR: new edges go to the overflow side table (new
        # dsts are larger than every existing consumer, so merged row +
        # overflow stays in ascending order); bulk-merge on a doubling
        # schedule keeps the amortized cost O(1) per edge
        if tot_new:
            extra = self._extra_cons
            for t in new:
                for d in t.inputs:
                    extra.setdefault(int(d), []).append(t.tid)
            self._n_extra += tot_new
        self.n_tasks = n + self.tid_base
        self._refresh_views()
        if self._n_extra >= max(64, self._cons_used):
            self._compact_consumers()

    def _compact_consumers(self) -> None:
        """Merge overflow consumer edges into the contiguous CSR (one
        vectorized pass over the merged part, O(new) Python over rows
        that gained edges).  Rows are local (tid - tid_base); edge
        VALUES stay global tids."""
        b = self.tid_base
        n = self.n_rows
        m = self._cons_rows
        used = self._cons_used
        mptr = self._cons_ptr_buf[:m + 1]
        counts = np.zeros(n, dtype=np.int64)
        mlen = np.diff(mptr)
        counts[:m] = mlen
        for t, v in self._extra_cons.items():
            counts[t - b] += len(v)
        new_ptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=new_ptr[1:])
        total = int(new_ptr[-1])
        new_dat = np.empty(total, dtype=np.int32)
        if used:
            idx = np.arange(used, dtype=np.int64) + \
                np.repeat(new_ptr[:m] - mptr[:-1], mlen)
            new_dat[idx] = self._cons_buf[:used]
        for t, v in self._extra_cons.items():
            r = t - b
            s = int(new_ptr[r] + (mlen[r] if r < m else 0))
            new_dat[s:s + len(v)] = v
        self._cons_buf = new_dat
        self._cons_ptr_buf = new_ptr
        self._cons_rows = n
        self._cons_used = total
        self._extra_cons = {}
        self._n_extra = 0

    # ------------------------------------------------------------------
    # released-prefix compaction (bounded storage for long-lived graphs)
    # ------------------------------------------------------------------

    def compact_prefix(self, new_base: int) -> None:
        """Drop every per-task row below ``new_base`` (caller guarantees
        those tids are permanently dead) and advance ``tid_base``.  All
        later access translates by the base; the copies are O(live), so
        a steady submit/release workload has bounded footprint."""
        k = new_base - self.tid_base
        if k <= 0:
            return
        if new_base > self.n_tasks:
            raise ValueError(f"compact base {new_base} > {self.n_tasks}")
        self._compact_consumers()       # merge overflow into local rows
        rows = self.n_tasks - new_base
        del self.tasks[:k]
        self._dur_buf = self._dur_buf[k:k + rows].copy()
        self._siz_buf = self._siz_buf[k:k + rows].copy()
        self._deg_buf = self._deg_buf[k:k + rows].copy()
        drop_deps = int(self._iptr_buf[k])
        self._iptr_buf = (self._iptr_buf[k:k + rows + 1]
                          - drop_deps).copy()
        self._iflat_buf = self._iflat_buf[drop_deps:self.n_deps].copy()
        self.n_deps -= drop_deps
        drop_cons = int(self._cons_ptr_buf[k])
        self._cons_ptr_buf = (self._cons_ptr_buf[k:k + rows + 1]
                              - drop_cons).copy()
        self._cons_buf = self._cons_buf[drop_cons:self._cons_used].copy()
        self._cons_used -= drop_cons
        self._cons_rows = rows
        self.tid_base = new_base
        self._refresh_views()

    @property
    def consumers(self) -> np.ndarray:
        """Contiguous consumers CSR data (compacts pending overflow
        edges first — hot paths use :meth:`consumers_of_many` instead)."""
        if self._n_extra or self._cons_rows != self.n_rows:
            self._compact_consumers()
        return self._cons_buf[:self._cons_used]

    @property
    def consumers_indptr(self) -> np.ndarray:
        if self._n_extra or self._cons_rows != self.n_rows:
            self._compact_consumers()
        return self._cons_ptr_buf[:self.n_rows + 1]

    # ------------------------------------------------------------------
    # Properties matching the paper's Table I columns
    # ------------------------------------------------------------------

    @property
    def avg_duration_ms(self) -> float:
        return float(self.durations.mean() * 1e3)

    @property
    def avg_output_kib(self) -> float:
        return float(self.sizes.mean() / 1024.0)

    def longest_path(self) -> int:
        """LP column: number of arcs on the longest oriented path."""
        depth = np.zeros(self.n_tasks, dtype=np.int32)
        for t in self.tasks:
            if t.inputs:
                depth[t.tid] = 1 + max(depth[d] for d in t.inputs)
        return int(depth.max()) if self.n_tasks else 0

    def critical_path_time(self) -> float:
        """Lower bound on makespan with infinite workers, zero overhead."""
        finish = np.zeros(self.n_tasks, dtype=np.float64)
        for t in self.tasks:
            start = max((finish[d] for d in t.inputs), default=0.0)
            finish[t.tid] = start + t.duration
        return float(finish.max()) if self.n_tasks else 0.0

    def total_work(self) -> float:
        return float(self.durations.sum())

    def consumers_of(self, tid: int) -> np.ndarray:
        row = int(tid) - self.tid_base
        base = (self._cons_buf[self._cons_ptr_buf[row]:
                               self._cons_ptr_buf[row + 1]]
                if row < self._cons_rows else _EMPTY_I32)
        extra = self._extra_cons.get(int(tid))
        if not extra:
            return base
        return np.concatenate([base, np.asarray(extra, dtype=np.int32)])

    def consumers_of_many(self, tids: np.ndarray) -> np.ndarray:
        """Concatenated consumers of ``tids`` (order unspecified): the
        reactor's hot-path gather, tolerant of not-yet-compacted epoch
        edges so it never forces an O(total) merge."""
        rows = np.asarray(tids, dtype=np.int64) - self.tid_base
        m = self._cons_rows
        ptr = self._cons_ptr_buf[:m + 1]
        if self._n_extra == 0 and m == self.n_rows:
            return csr_gather(ptr, self._cons_buf, rows)
        parts = []
        inb = rows[rows < m]
        if len(inb):
            parts.append(csr_gather(ptr, self._cons_buf, inb))
        if self._extra_cons:
            b = self.tid_base
            flat: list[int] = []
            for r in rows.tolist():
                v = self._extra_cons.get(int(r) + b)
                if v:
                    flat.extend(v)
            if flat:
                parts.append(np.asarray(flat, dtype=np.int32))
        if not parts:
            return _EMPTY_I32
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def inputs_of(self, tid: int) -> np.ndarray:
        row = int(tid) - self.tid_base
        return self.inputs_flat[self.inputs_indptr[row]:
                                self.inputs_indptr[row + 1]]

    def task(self, tid: int) -> Task:
        """The :class:`Task` record for a (global) tid — the row-aware
        replacement for ``graph.tasks[tid]``.

        Safe against a concurrently-running :meth:`compact_prefix` on
        the server loop (client threads and thread workers read tasks
        without a lock): every Task carries its own ``tid``, so a read
        that interleaved with the row shift is detected and retried;
        a tid at or above ``tid_base`` always converges because its row
        survives every compaction.  Raises IndexError for a compacted
        (released-and-dropped) tid."""
        tid = int(tid)
        while True:
            base = self.tid_base
            if tid < base:
                raise IndexError(
                    f"tid {tid} was compacted away (base {base})")
            try:
                t = self.tasks[tid - base]
            except IndexError:
                if tid >= self.n_tasks:
                    raise
                continue    # rows shifted mid-read: retry
            if t.tid == tid:
                return t
            # base read and list index straddled a compaction: retry

    def dur_of(self, tid: int) -> float:
        return float(self.durations[int(tid) - self.tid_base])

    def size_of(self, tid: int) -> float:
        return float(self.sizes[int(tid) - self.tid_base])

    def summary(self) -> dict:
        return {"name": self.name, "n_tasks": self.n_tasks,
                "n_deps": self.n_deps,
                "avg_duration_ms": round(self.avg_duration_ms, 4),
                "avg_output_kib": round(self.avg_output_kib, 3),
                "longest_path": self.longest_path()}


# ---------------------------------------------------------------------------
# Incremental construction under user keys
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _TaskDef:
    key: Any
    inputs: tuple
    duration: float
    output_size: float
    fn: Callable | None
    args: tuple
    name: str


class GraphBuilder:
    """Incremental graph construction under arbitrary hashable keys.

    Drops the dense-tid/topological-order-at-construction restriction of
    :class:`TaskGraph.__init__` behind an API: tasks may be added in any
    order and may reference keys that have not been added yet (a forward
    reference buffers the task until every dependency is known).
    :meth:`flush` drains every task whose dependency closure is resolved,
    assigns dense tids starting at ``base`` (topologically ordered within
    the flushed batch), and returns ``(tasks, key_to_tid)`` ready for
    :meth:`TaskGraph.extend` or an incremental Client submission.
    """

    def __init__(self, name: str = "graph"):
        self.name = name
        self.key_to_tid: dict[Any, int] = {}
        self._pending: dict[Any, _TaskDef] = {}
        self._order: list[Any] = []     # insertion order of pending keys

    def add(self, key: Any, inputs: Sequence[Any] = (), *,
            duration: float = 0.0, output_size: float = 1024.0,
            fn: Callable | None = None, args: tuple = (),
            name: str = "") -> Any:
        """Declare task ``key`` depending on the tasks at ``inputs`` keys
        (which may be added before or after this call)."""
        if key in self.key_to_tid or key in self._pending:
            raise ValueError(f"duplicate task key {key!r}")
        self._pending[key] = _TaskDef(key, tuple(inputs), float(duration),
                                      float(output_size), fn, tuple(args),
                                      name or str(key))
        self._order.append(key)
        return key

    @property
    def n_pending(self) -> int:
        return len(self._pending)

    def flush(self, base: int = 0) -> tuple[list[Task], dict[Any, int]]:
        """Drain every pending task whose dependencies are all resolvable,
        assigning dense tids ``base, base+1, ...``.  Tasks with unmet
        forward references stay buffered for a later flush.

        Ready-queue topological drain: O(pending + edges) per flush, so
        anti-topological insertion order (sink first) costs the same as
        sorted order."""
        unmet: dict[Any, int] = {}
        dependents: dict[Any, list[Any]] = {}
        ready: collections.deque = collections.deque()
        for key in self._order:
            d = self._pending[key]
            n_unmet = 0
            for k in d.inputs:
                if k not in self.key_to_tid:
                    n_unmet += 1
                    dependents.setdefault(k, []).append(key)
            unmet[key] = n_unmet
            if n_unmet == 0:
                ready.append(key)
        out: list[Task] = []
        flushed: dict[Any, int] = {}
        while ready:
            key = ready.popleft()
            d = self._pending.pop(key)
            tid = base + len(out)
            self.key_to_tid[key] = tid
            flushed[key] = tid
            out.append(Task(tid,
                            tuple(self.key_to_tid[k] for k in d.inputs),
                            d.duration, d.output_size, d.fn, d.args,
                            d.name))
            for waiter in dependents.get(key, ()):
                unmet[waiter] -= 1
                if unmet[waiter] == 0:
                    ready.append(waiter)
        self._order = [k for k in self._order if k in self._pending]
        return out, flushed

    def build(self, name: str | None = None) -> TaskGraph:
        """Build a complete :class:`TaskGraph` from everything added so
        far; raises if any dependency is still unresolved (dangling
        forward reference or dependency cycle)."""
        tasks, _ = self.flush(base=0)
        if self._pending:
            missing = {k: [i for i in d.inputs if i not in self.key_to_tid]
                       for k, d in self._pending.items()}
            raise ValueError(
                f"unresolved dependencies (cycle or missing keys): "
                f"{missing}")
        return TaskGraph(tasks, name=name or self.name)
