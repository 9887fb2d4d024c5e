"""Bounded per-worker object store: byte-accounted LRU + spill-to-disk.

A copy of :mod:`repro.core.store` for the port.

The paper's thesis is that Dask's bottleneck is runtime overhead, not
scheduling — but a runtime whose workers keep every result in an
unbounded dict cheats on a dimension real Dask pays for: data management
under memory pressure.  ProxyStore (Pauloski et al.) and NumS both show
that a first-class object store with mediated resolution is what makes
Dask-style frameworks scale past RAM; this module is that subsystem.

:class:`ObjectStore` owns every task result on a node:

* **byte-accounted LRU** — each ``put`` charges an estimated object size
  (:func:`sizeof`) against ``memory_limit``; when the in-memory tier
  overflows, the least-recently-used values are spilled.
* **spill-to-disk tier** — spilled values are pickled to one file per
  key under ``spill_dir`` (a private temp dir by default) and
  transparently *unspilled* on access, so readers never see the tiers.
* **meters** — ``mem_bytes``/``peak_bytes`` (in-memory tier),
  ``spill_bytes``/``unspill_bytes`` (cumulative bytes written/read
  back), ``spill_count``/``unspill_count`` and ``disk_bytes``.  Workers
  snapshot these as a 6-tuple :meth:`ObjectStore.usage` record (layout:
  :data:`USAGE_FIELDS`) piggybacked on finished/stats wire frames; the
  server folds those into per-worker memory ledgers and surfaces the
  aggregates on ``RunResult.stats`` / ``EpochStats`` (see
  ``docs/meters.md``).
* **event hook** — setting :attr:`ObjectStore.event_cb` to a callable
  ``(kind, tid, nbytes)`` streams every ``"spill"``/``"unspill"``
  transition into the observability feed (``repro_torch.core.events``); the
  default ``None`` costs one attribute check per transition, not per
  operation.

The store is a :class:`collections.abc.MutableMapping`, so it drops into
every place a raw result dict used to live (worker caches, the server's
client-facing result store).  All operations take an internal lock: the
worker's compute loop, its data-plane listener thread and the client
threads reading results may touch one store concurrently.

``memory_limit=None`` (the default) is the unbounded fast path: no LRU
reordering, no eviction scans — one dict write plus a size estimate per
put, so an unlimited store costs what the raw dict did.

An object larger than the whole limit is kept in memory while it is the
most-recently-inserted value (there is nothing older left to evict) —
the "one object's slack" a byte-accounted LRU necessarily allows.
Unpicklable values are pinned in memory rather than failing the put:
spilling is an optimization, not a correctness requirement.
"""
from __future__ import annotations

import collections
import collections.abc
import os
import pickle
import shutil
import sys
import tempfile
import threading
from typing import Any, Iterator

import numpy as np

_MISS = object()

#: usage-report layout piggybacked on finished/stats wire frames:
#: (mem_bytes, peak_bytes, spill_bytes, unspill_bytes, spill_count,
#:  unspill_count) — peak is store-tracked, so transient put-then-evict
#: spikes between flushes are reported, not lost
USAGE_FIELDS = ("mem_bytes", "peak_bytes", "spill_bytes",
                "unspill_bytes", "spill_count", "unspill_count")


def sizeof(value: Any) -> int:
    """Cheap, shallow byte estimate for LRU accounting.

    Exact for the payloads the runtime actually moves (numpy arrays,
    bytes); ``sys.getsizeof`` for everything else — an estimate, like
    Dask's ``sizeof``, not a deep measurement.  One level of container
    recursion covers the common list-of-arrays result shape without
    risking O(n) walks over deep structures."""
    if isinstance(value, np.ndarray):
        return int(value.nbytes) + 112      # header overhead
    if isinstance(value, memoryview):
        return int(value.nbytes) + 112      # len() counts ELEMENTS
    if isinstance(value, (bytes, bytearray)):
        return len(value) + 56
    try:
        n = sys.getsizeof(value)
    except TypeError:
        return 64
    if isinstance(value, (list, tuple, set, frozenset)) and len(value) < 64:
        for item in value:
            if isinstance(item, np.ndarray):
                n += int(item.nbytes)
            elif isinstance(item, (bytes, bytearray)):
                n += len(item)
            else:
                try:
                    n += sys.getsizeof(item)
                except TypeError:
                    n += 64
    return int(n)


class ObjectStore(collections.abc.MutableMapping):
    """Two-tier (memory + disk) object store with LRU spill.

    Parameters
    ----------
    memory_limit:
        Soft cap in bytes for the in-memory tier; ``None`` disables
        eviction entirely (unbounded fast path).
    spill_dir:
        Root for spill files.  ``None`` creates a private temp dir
        lazily on first spill; under a caller-supplied path the store
        creates (and owns) a unique subdirectory, so any number of
        stores/runs may share one root without their ``<tid>.pkl``
        files colliding.  :meth:`close` removes the store's own
        directory, never the caller's root.
    name:
        Label used in spill file names and the temp-dir prefix
        (typically ``"w3"`` for worker 3).
    """

    def __init__(self, memory_limit: int | None = None,
                 spill_dir: str | None = None, name: str = "store"):
        self.memory_limit = memory_limit
        self.name = name
        self._given_dir = spill_dir
        self._dir: str | None = None
        self._own_dir = False
        # in-memory tier: insertion/access order IS the LRU order
        self._mem: collections.OrderedDict[int, tuple[Any, int]] = \
            collections.OrderedDict()
        # disk tier: tid -> (path, nbytes_pickled)
        self._disk: dict[int, tuple[str, int]] = {}
        self._lock = threading.RLock()
        # meters
        self.mem_bytes = 0
        self.peak_bytes = 0
        self.disk_bytes = 0
        self.spill_bytes = 0        # cumulative bytes written to disk
        self.unspill_bytes = 0      # cumulative bytes read back
        self.spill_count = 0
        self.unspill_count = 0
        # keys whose value could not be pickled: pinned in memory
        self._pinned: set[int] = set()
        # optional observability hook: callable (kind, tid, nbytes),
        # invoked under self._lock on every spill/unspill transition
        self.event_cb = None

    # ------------------------------------------------------------------
    # spill machinery (callers hold self._lock)
    # ------------------------------------------------------------------

    def _spill_path(self, tid: int) -> str:
        if self._dir is None:
            if self._given_dir is not None:
                # a unique subdir under the caller's root: two stores
                # (or two runs) sharing one spill_dir must never
                # overwrite or unlink each other's <tid>.pkl files
                os.makedirs(self._given_dir, exist_ok=True)
                self._dir = tempfile.mkdtemp(
                    prefix=f"{self.name}-", dir=self._given_dir)
            else:
                self._dir = tempfile.mkdtemp(
                    prefix=f"repro-spill-{self.name}-")
            self._own_dir = True
        return os.path.join(self._dir, f"{int(tid)}.pkl")

    def _spill_one(self) -> bool:
        """Spill the least-recently-used unpinned value; False when
        nothing is evictable."""
        victim = next((t for t in self._mem if t not in self._pinned),
                      None)
        if victim is None:
            return False
        value, nbytes = self._mem[victim]
        try:
            blob = pickle.dumps(value, protocol=4)
        except Exception:
            # unpicklable: pin it so the eviction scan skips it forever
            self._pinned.add(victim)
            self._mem.move_to_end(victim)
            return True
        path = self._spill_path(victim)
        with open(path, "wb") as f:
            f.write(blob)
        del self._mem[victim]
        self._mem_sub(nbytes)
        self._disk[victim] = (path, len(blob))
        self.disk_bytes += len(blob)
        self.spill_bytes += len(blob)
        self.spill_count += 1
        if self.event_cb is not None:
            self.event_cb("spill", victim, len(blob))
        return True

    def _shrink(self) -> None:
        limit = self.memory_limit
        if limit is None:
            return
        # the newest value is never spilled to make room for itself:
        # an object bigger than the whole limit stays resident (the one
        # object of slack) instead of thrashing the disk tier
        while self.mem_bytes > limit and len(self._mem) > 1:
            if not self._spill_one():
                break

    def _mem_add(self, nbytes: int) -> None:
        self.mem_bytes += nbytes
        if self.mem_bytes > self.peak_bytes:
            self.peak_bytes = self.mem_bytes

    def _mem_sub(self, nbytes: int) -> None:
        self.mem_bytes = max(self.mem_bytes - nbytes, 0)

    def _unspill(self, tid: int) -> Any:
        """Load a spilled value back into the memory tier (may evict
        colder values in turn)."""
        path, nbytes = self._disk.pop(tid)
        with open(path, "rb") as f:
            value = pickle.loads(f.read())
        try:
            os.unlink(path)
        except OSError:
            pass
        self.disk_bytes -= nbytes
        self.unspill_bytes += nbytes
        self.unspill_count += 1
        if self.event_cb is not None:
            self.event_cb("unspill", tid, nbytes)
        est = sizeof(value)
        self._mem[tid] = (value, est)
        self._mem_add(est)
        self._shrink()
        return value

    # ------------------------------------------------------------------
    # mapping surface
    # ------------------------------------------------------------------

    def put(self, tid: int, value: Any) -> None:
        tid = int(tid)
        nbytes = sizeof(value)
        with self._lock:
            old = self._mem.pop(tid, None)
            if old is not None:
                self._mem_sub(old[1])
            elif tid in self._disk:
                self._drop_disk(tid)
            self._pinned.discard(tid)
            self._mem[tid] = (value, nbytes)
            self._mem_add(nbytes)
            self._shrink()

    def get(self, tid: int, default: Any = None) -> Any:
        tid = int(tid)
        with self._lock:
            hit = self._mem.get(tid, _MISS)
            if hit is not _MISS:
                if self.memory_limit is not None:
                    self._mem.move_to_end(tid)      # LRU touch
                return hit[0]
            if tid in self._disk:
                return self._unspill(tid)
        return default

    def __getitem__(self, tid: int) -> Any:
        out = self.get(tid, _MISS)
        if out is _MISS:
            raise KeyError(tid)
        return out

    def __setitem__(self, tid: int, value: Any) -> None:
        self.put(tid, value)

    def __delitem__(self, tid: int) -> None:
        if not self.discard(tid):
            raise KeyError(tid)

    def __contains__(self, tid: object) -> bool:
        tid = int(tid)            # contains must NOT unspill
        with self._lock:
            return tid in self._mem or tid in self._disk

    def __iter__(self) -> Iterator[int]:
        with self._lock:
            return iter(list(self._mem) + list(self._disk))

    def __len__(self) -> int:
        with self._lock:
            return len(self._mem) + len(self._disk)

    def _drop_disk(self, tid: int) -> None:
        path, nbytes = self._disk.pop(tid)
        self.disk_bytes -= nbytes
        try:
            os.unlink(path)
        except OSError:
            pass

    def discard(self, tid: int) -> bool:
        """Drop ``tid`` from both tiers (eviction signal: released /
        reclaimed keys); True when something was removed."""
        tid = int(tid)
        with self._lock:
            hit = self._mem.pop(tid, None)
            if hit is not None:
                self._mem_sub(hit[1])
                self._pinned.discard(tid)
                return True
            if tid in self._disk:
                self._drop_disk(tid)
                return True
        return False

    def pop(self, tid: int, *default: Any) -> Any:
        """Atomic remove-and-return across both tiers (one lock hold —
        a concurrent put cannot be lost between lookup and removal).  A
        spilled value is read straight off its file without re-entering
        the memory tier: deleting it must not trigger cascade spills."""
        tid = int(tid)
        with self._lock:
            hit = self._mem.pop(tid, None)
            if hit is not None:
                self._mem_sub(hit[1])
                self._pinned.discard(tid)
                return hit[0]
            if tid in self._disk:
                path, nbytes = self._disk.pop(tid)
                self.disk_bytes -= nbytes
                try:
                    with open(path, "rb") as f:
                        value = pickle.loads(f.read())
                finally:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                self.unspill_bytes += nbytes
                self.unspill_count += 1
                if self.event_cb is not None:
                    self.event_cb("unspill", tid, nbytes)
                return value
        if default:
            return default[0]
        raise KeyError(tid)

    # ------------------------------------------------------------------
    # meters / lifecycle
    # ------------------------------------------------------------------

    def usage(self) -> tuple[int, int, int, int, int, int]:
        """The compact usage record workers piggyback on finished/stats
        frames (see :data:`USAGE_FIELDS`)."""
        with self._lock:
            return (self.mem_bytes, self.peak_bytes, self.spill_bytes,
                    self.unspill_bytes, self.spill_count,
                    self.unspill_count)

    def stats(self) -> dict:
        with self._lock:
            return {"mem_bytes": self.mem_bytes,
                    "peak_bytes": self.peak_bytes,
                    "disk_bytes": self.disk_bytes,
                    "spill_bytes": self.spill_bytes,
                    "unspill_bytes": self.unspill_bytes,
                    "spill_count": self.spill_count,
                    "unspill_count": self.unspill_count,
                    "n_objects": len(self._mem) + len(self._disk),
                    "n_spilled": len(self._disk),
                    "memory_limit": self.memory_limit}

    def close(self) -> None:
        """Drop both tiers and remove spill files (and the spill dir
        itself when the store created it)."""
        with self._lock:
            self._mem.clear()
            self._pinned.clear()
            self.mem_bytes = 0
            for tid in list(self._disk):
                self._drop_disk(tid)
            if self._dir is not None and self._own_dir:
                shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None

    def __del__(self):
        # GC-time best effort so an abandoned bounded store does not
        # leak its temp spill dir (workers close() explicitly)
        try:
            if self._dir is not None and self._own_dir:
                shutil.rmtree(self._dir, ignore_errors=True)
        except Exception:
            pass

    def __repr__(self) -> str:
        return (f"<ObjectStore {self.name} n={len(self)} "
                f"mem={self.mem_bytes}B disk={self.disk_bytes}B "
                f"limit={self.memory_limit}>")
