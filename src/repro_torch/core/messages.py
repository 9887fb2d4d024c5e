"""Dask-style protocol messages and wire codecs (paper §III-B / §IV-B).

A copy of :mod:`repro.core.messages` for the port: the same ops, codecs
and bytes on the wire.

The Dask-style :class:`repro_torch.core.reactor.ObjectReactor` round-trips every
message through msgpack at the server boundary, mirroring Dask's
serialize-per-message behaviour.  The RSDS-style ArrayReactor keeps static
in-process structures (the paper's protocol modification keeps message
structure static, so deserialization cost collapses); it skips the codec
entirely.

For the multi-process runtime the codec is no longer simulated: frames
really cross an OS pipe or socket.  Two wire codecs implement the paper's
asymmetry:

* :class:`DaskWire` — one msgpack dict per message, packed and unpacked
  per task / per completion (Dask's serialize-per-message cost profile).
* :class:`StaticWire` — RSDS-style static frame layout: a fixed header
  plus fixed-size records, encoded once per *batch* with ``struct``; the
  only dynamic part is an optional pickled payload section for tasks that
  carry real data (which the paper's hot path does not).

The persistent Cluster/Client path extends both codecs to the *submission*
side of the protocol: ``update-graph`` frames ship new task epochs to
running workers (per-key messages on the Dask wire, one static frame per
epoch on the RSDS wire), ``release`` frames drop worker-cached results
when a client releases a key, and ``gather`` frames ask a worker to
re-send retained results — so the codec asymmetry is measured on graph
submission and key lifetime, not only on compute/finished traffic.

The peer-to-peer data plane adds the worker-to-worker half of the
protocol to both codecs: compute frames may carry ``who_has`` placement
hints (dep tid -> holder data-plane address) instead of inlined payloads,
``fetch``/``fetch-reply`` frames move dependency values directly between
workers, ``gather-reply`` frames answer gathers explicitly (absent keys
are marked, never silently dropped), ``fetch-failed`` frames hand a task
back to the server when its holder died, ``data-addr`` frames register a
worker's listener, and ``stats`` frames report p2p transfer bytes.  Both
codecs also meter payload bytes (``take_payload_bytes`` /
``take_gather_bytes``) so the server-relay vs p2p split is measured, per
wire, on the data path itself.

The memory subsystem rides the same frames: workers piggyback a compact
object-store usage record (the ``repro_torch.core.store.USAGE_FIELDS``
6-tuple — mem/peak bytes, cumulative spill/unspill bytes and counts) on
finished-batch and stats frames whenever it changed; the server drains
it via ``take_usage()`` after decode and folds it into its per-worker
memory ledgers.  ``compact`` frames broadcast the released-tid prefix
base so long-lived workers shed task-table and store rows in step with
the server's compaction.

The high-volume control plane adds a ``batch`` envelope to both codecs
(``encode_batch``): already-encoded frames destined for the same worker
within one server-loop iteration are coalesced into a single transport
send (one syscall, one length prefix) — the Dask wire keeps its
per-message msgpack cost on every sub-frame (only the sends are
coalesced, mirroring dask.distributed's BatchedSend), the static wire
concatenates fixed-layout sub-frames.  ``frame_event`` expands a
decoded worker->server batch into its constituent events, so the
server core never sees the envelope.
"""
from __future__ import annotations

import pickle
import struct
from typing import Any, Iterable, Sequence

import msgpack

# message ops (subset of the Dask protocol the paper's RSDS implements)
COMPUTE_TASK = "compute-task"
TASK_FINISHED = "task-finished"
STEAL_REQUEST = "steal-request"
STEAL_RESPONSE = "steal-response"
RELEASE_DATA = "release-data"
WORKER_JOIN = "register-worker"
WORKER_LEAVE = "unregister-worker"
GRAPH_SUBMIT = "update-graph"


def pack(msg: dict) -> bytes:
    return msgpack.packb(msg, use_bin_type=True)


def unpack(raw: bytes) -> dict:
    return msgpack.unpackb(raw, raw=False)


def compute_task(tid: int, wid: int, inputs, who_has) -> dict:
    return {"op": COMPUTE_TASK, "key": int(tid), "worker": int(wid),
            "inputs": [int(i) for i in inputs],
            "who_has": {int(k): [int(w) for w in v]
                        for k, v in who_has.items()}}


def task_finished(tid: int, wid: int, nbytes: float) -> dict:
    return {"op": TASK_FINISHED, "key": int(tid), "worker": int(wid),
            "nbytes": float(nbytes)}


# ---------------------------------------------------------------------------
# Wire codecs (process runtime)
# ---------------------------------------------------------------------------
# Frame-level ops.  A "frame" is one transport send; the transports do the
# length-prefix framing, the codecs define the bytes inside.

OP_COMPUTE = 1       # server -> worker: run these tasks
OP_FINISHED = 2      # worker -> server: these tasks completed
OP_RETRACT = 3       # server -> worker: drop these if not yet started
OP_SHUTDOWN = 4      # server -> worker: drain and exit
OP_UPDATE_GRAPH = 5  # server -> worker: new task definitions (epoch)
OP_RELEASE = 6       # server -> worker: drop cached results for these keys
OP_GATHER = 7        # server -> worker: re-send cached results for keys
OP_GATHER_REPLY = 8  # worker -> server: gathered values + absent markers
OP_FETCH = 9         # worker -> worker: request dependency values
OP_FETCH_REPLY = 10  # worker -> worker: fetched values + absent markers
OP_FETCH_FAILED = 11  # worker -> server: task deps unfetchable (fallback)
OP_DATA_ADDR = 12    # worker -> server: my data-plane listener address
OP_STATS = 13        # worker -> server: p2p transfer-bytes delta
OP_COMPACT = 14      # server -> worker: tid prefix below base compacted
#                      (drop local task-table/store rows for good)
OP_BATCH = 15        # server -> worker: coalesced control sub-frames
#                      (high-volume batching: one transport send carries
#                      many logical frames; workers send them too when
#                      the runtime's batching knob is on, and
#                      frame_event expands them server-side)

_NO_RESULT = object()   # worker-side marker: task produced no value


class _ByteCounters:
    """Mixin: payload-byte accounting shared by both wire codecs.

    ``payload_bytes`` counts task-dependency data that crossed the server
    boundary (inlined compute payloads + finished-frame result blobs) —
    the *server-relay* bytes the p2p data plane eliminates.
    ``gather_bytes`` counts client-facing gather-reply data separately
    (fetching a result to the client is not input relay).

    ``take_usage`` is the same take-style side channel for the memory
    subsystem: finished/stats frames piggyback the sending worker's
    object-store usage record (``repro_torch.core.store.USAGE_FIELDS``), and
    the server driver drains the last decoded one after each decode —
    so the per-worker memory ledger rides existing frames instead of
    adding a protocol round-trip."""

    _payload_bytes = 0
    _gather_bytes = 0
    _last_usage: tuple | None = None
    _timing: list | None = None

    def take_payload_bytes(self) -> int:
        out, self._payload_bytes = self._payload_bytes, 0
        return out

    def take_gather_bytes(self) -> int:
        out, self._gather_bytes = self._gather_bytes, 0
        return out

    def take_usage(self) -> tuple | None:
        """Usage record from the last decoded finished/stats frame, or
        None when that frame carried none (drained on read)."""
        out, self._last_usage = self._last_usage, None
        return out

    def _add_timing(self, records: Iterable) -> None:
        # accumulate (not last-wins like usage): an OP_BATCH decode
        # recurses through many sub-frames and every timing record must
        # survive to the driver's drain
        if self._timing is None:
            self._timing = []
        self._timing.extend(
            tuple(int(x) for x in r) for r in records)

    def take_timing(self) -> list[tuple] | None:
        """Tracing records decoded since the last drain (``(tid,
        recv_ns, start_ns, end_ns, fetch_ns)`` in the sending worker's
        ``perf_counter_ns`` domain), or None when none arrived.  Same
        take-style side channel as ``take_usage`` — timing rides
        finished frames, never its own round-trip."""
        out, self._timing = self._timing, None
        return out


class DaskWire(_ByteCounters):
    """Per-message msgpack codec: every task and every completion is its
    own dict, packed and unpacked individually (Dask's cost profile)."""
    name = "dask"
    batched = False

    def encode_compute_batch(self, items: Sequence[tuple[int, float]],
                             payloads: dict[int, Any] | None = None,
                             inputs_of=None,
                             hints: dict[int, dict] | None = None,
                             deps: dict[int, Sequence[int]] | None = None
                             ) -> list[bytes]:
        """``payloads[tid]`` is a ``{dep_tid: value}`` dict of inlined
        dependency values (server relay); ``hints[tid]`` maps dep tids to
        the data-plane ``(host, port)`` of a holder (p2p); ``deps`` is
        redundant on this wire (per-message ``inputs`` carries the
        ordering already, part of Dask's who_has message cost)."""
        frames = []
        for tid, dur in items:
            m = {"op": OP_COMPUTE, "key": int(tid), "duration": float(dur),
                 "inputs": ([int(i) for i in inputs_of(tid)]
                            if inputs_of is not None else [])}
            if payloads is not None and tid in payloads:
                blob = pickle.dumps(payloads[tid], protocol=4)
                m["data"] = blob
                self._payload_bytes += len(blob)
            if hints is not None and tid in hints:
                # string keys: Dask addresses tasks by string key in its
                # who_has messages (and msgpack maps are strict about it)
                m["who_has"] = {str(int(d)): [str(a[0]), int(a[1])]
                                for d, a in hints[tid].items()}
            frames.append(pack(m))
        return frames

    def encode_finished_batch(self, wid: int,
                              items: Sequence[tuple[int, Any]],
                              usage: tuple | None = None,
                              timing: Sequence[tuple] | None = None
                              ) -> list[bytes]:
        """``usage`` (the worker's object-store usage record) and
        ``timing`` (per-task tracing records, ``(tid, recv_ns, start_ns,
        end_ns, fetch_ns)``) ride the LAST message of the batch — extra
        dict fields, keeping the per-message cost profile honest."""
        frames = []
        for i, (tid, result) in enumerate(items):
            m = {"op": OP_FINISHED, "key": int(tid), "worker": int(wid)}
            if result is not _NO_RESULT:
                blob = pickle.dumps(result, protocol=4)
                m["data"] = blob
                m["nbytes"] = float(len(blob))
            else:
                m["nbytes"] = 0.0
            if i == len(items) - 1:
                if usage is not None:
                    m["usage"] = [int(x) for x in usage]
                if timing:
                    m["timing"] = [[int(x) for x in r] for r in timing]
            frames.append(pack(m))
        return frames

    def encode_retract(self, tids: Iterable[int]) -> list[bytes]:
        return [pack({"op": OP_RETRACT, "keys": [int(t) for t in tids]})]

    def encode_shutdown(self) -> bytes:
        return pack({"op": OP_SHUTDOWN})

    def encode_update_graph(self, defs: Sequence[tuple[int, float]],
                            fns: dict[int, Any] | None = None
                            ) -> list[bytes]:
        """Incremental graph submission: one msgpack dict per new task
        (Dask's update-graph cost is per key), pickled ``(fn, args)``
        riding along for tasks that carry a real callable."""
        frames = []
        for tid, dur in defs:
            m = {"op": OP_UPDATE_GRAPH, "key": int(tid),
                 "duration": float(dur)}
            if fns is not None and tid in fns:
                m["fn"] = pickle.dumps(fns[tid], protocol=4)
            frames.append(pack(m))
        return frames

    def encode_release(self, tids: Iterable[int]) -> list[bytes]:
        """One keys-list frame, like retract/gather.  Dask historically
        freed keys one message each; the high-volume control plane
        coalesces the whole release set into a single frame."""
        return [pack({"op": OP_RELEASE, "keys": [int(t) for t in tids]})]

    def encode_gather(self, tids: Iterable[int]) -> list[bytes]:
        return [pack({"op": OP_GATHER, "keys": [int(t) for t in tids]})]

    def encode_gather_reply(self, present: dict[int, Any],
                            absent: Iterable[int]) -> list[bytes]:
        """Single-frame reply (request/response pairing needs one frame
        per request even on the per-message wire): values for the keys the
        worker holds plus explicit absent markers for the rest."""
        m: dict = {"op": OP_GATHER_REPLY,
                   "absent": [int(t) for t in absent]}
        if present:
            m["data"] = pickle.dumps({int(t): v for t, v in present.items()},
                                     protocol=4)
        return [pack(m)]

    def encode_fetch(self, tids: Iterable[int]) -> list[bytes]:
        return [pack({"op": OP_FETCH, "keys": [int(t) for t in tids]})]

    def encode_fetch_reply(self, present: dict[int, Any],
                           absent: Iterable[int]) -> list[bytes]:
        m: dict = {"op": OP_FETCH_REPLY,
                   "absent": [int(t) for t in absent]}
        if present:
            m["data"] = pickle.dumps({int(t): v for t, v in present.items()},
                                     protocol=4)
        return [pack(m)]

    def encode_fetch_failed(self, tid: int,
                            missing: Iterable[int]) -> list[bytes]:
        return [pack({"op": OP_FETCH_FAILED, "key": int(tid),
                      "missing": [int(d) for d in missing]})]

    def encode_data_addr(self, wid: int, addr) -> list[bytes]:
        return [pack({"op": OP_DATA_ADDR, "worker": int(wid),
                      "host": str(addr[0]), "port": int(addr[1])})]

    def encode_compact(self, base: int) -> list[bytes]:
        return [pack({"op": OP_COMPACT, "base": int(base)})]

    def encode_stats(self, p2p_bytes: int, n_fetches: int,
                     usage: tuple | None = None) -> list[bytes]:
        m = {"op": OP_STATS, "p2p_bytes": int(p2p_bytes),
             "fetches": int(n_fetches)}
        if usage is not None:
            m["usage"] = [int(x) for x in usage]
        return [pack(m)]

    def encode_batch(self, frames: Sequence[bytes]) -> list[bytes]:
        """Coalesce already-encoded frames into ONE transport send.
        Sub-frames stay individually msgpack'd — the per-message
        serialization cost profile is preserved; only the transport
        sends are coalesced (Dask's BatchedSend shape)."""
        return [pack({"op": OP_BATCH, "frames": [bytes(f)
                                                 for f in frames]})]

    def decode(self, raw: bytes):
        """-> (op, records, payloads) with one record per frame.  For
        OP_COMPUTE the third slot is an *extras* dict with optional
        ``data`` ({tid: {dep: value}} inlined relay payloads), ``deps``
        ({tid: ordered input tids}) and ``hints`` ({tid: {dep: (host,
        port)}} p2p placement hints), or None when the frame carries
        none of them."""
        m = unpack(raw)
        op = m["op"]
        if op == OP_COMPUTE:
            tid = m["key"]
            extra: dict | None = None
            if m.get("inputs"):
                extra = {"deps": {tid: list(m["inputs"])}}
            if "data" in m:
                self._payload_bytes += len(m["data"])
                extra = extra or {}
                extra["data"] = {tid: pickle.loads(m["data"])}
            if "who_has" in m:
                extra = extra or {}
                extra["hints"] = {tid: {int(d): (a[0], int(a[1]))
                                        for d, a in m["who_has"].items()}}
            return op, [(tid, m["duration"])], extra
        if op == OP_FINISHED:
            payloads = None
            if "data" in m:
                self._payload_bytes += len(m["data"])
                payloads = {m["key"]: pickle.loads(m["data"])}
            if "usage" in m:
                self._last_usage = tuple(int(x) for x in m["usage"])
            if "timing" in m:
                self._add_timing(m["timing"])
            return op, [(m["key"], m["worker"], m.get("nbytes", 0.0))], \
                payloads
        if op == OP_RETRACT:
            return op, list(m["keys"]), None
        if op == OP_SHUTDOWN:
            return op, [], None
        if op == OP_UPDATE_GRAPH:
            payloads = None
            if "fn" in m:
                payloads = {m["key"]: pickle.loads(m["fn"])}
            return op, [(m["key"], m["duration"])], payloads
        if op == OP_RELEASE:
            return op, list(m["keys"]), None
        if op == OP_GATHER:
            return op, list(m["keys"]), None
        if op in (OP_GATHER_REPLY, OP_FETCH_REPLY):
            payloads = None
            if "data" in m:
                if op == OP_GATHER_REPLY:
                    self._gather_bytes += len(m["data"])
                payloads = pickle.loads(m["data"])
            return op, list(m["absent"]), payloads
        if op == OP_FETCH:
            return op, list(m["keys"]), None
        if op == OP_FETCH_FAILED:
            return op, [(m["key"], tuple(m["missing"]))], None
        if op == OP_DATA_ADDR:
            return op, [m["worker"]], (m["host"], m["port"])
        if op == OP_COMPACT:
            return op, [m["base"]], None
        if op == OP_STATS:
            if "usage" in m:
                self._last_usage = tuple(int(x) for x in m["usage"])
            return op, [(m["p2p_bytes"], m["fetches"])], None
        if op == OP_BATCH:
            # records are the decoded sub-triples, in send order; the
            # usage side channel ends up holding the LAST sub-frame's
            # record (a batch piggybacks usage on its last message)
            return op, [self.decode(f) for f in m["frames"]], None
        return op, [], None


class StaticWire(_ByteCounters):
    """RSDS-style static frame layout, one encode/decode per batch.

    header  = op:u8  flags:u8  count:u32
    flags: bit0 = pickled blob trails the records, bit1 = a fixed-size
    usage record (the worker's object-store meters, 6×i64) follows the
    header on finished/stats frames, bit2 = a tracing section (count:u32
    then per-task 5×i64 timing records) follows the usage record on
    finished frames — static layout, no codec cost
    compute  record = tid:i64  duration:f64
    finished record = tid:i64  wid:i32  nbytes:f64
    retract  record = tid:i64  (also release/gather/fetch/fetch-failed)
    stats    record = p2p_bytes:i64  fetches:i64
    blob (optional) = pickled dynamic section; for compute frames a
    ``{"data": …, "deps": …, "hints": …}`` extras dict, for
    finished/gather-reply/fetch-reply frames a ``{tid: value}`` dict
    (the static hot path — duration-model tasks — carries no blob)
    """
    name = "static"
    batched = True

    _HDR = struct.Struct("<BBI")
    _COMPUTE = struct.Struct("<qd")
    _FINISHED = struct.Struct("<qid")
    _RETRACT = struct.Struct("<q")
    _STATS = struct.Struct("<qq")
    _USAGE = struct.Struct("<qqqqqq")
    _TIMING = struct.Struct("<qqqqq")   # tid recv start end fetch (ns)
    _SUB = struct.Struct("<I")      # batch sub-frame length prefix

    def encode_compute_batch(self, items: Sequence[tuple[int, float]],
                             payloads: dict[int, Any] | None = None,
                             inputs_of=None,
                             hints: dict[int, dict] | None = None,
                             deps: dict[int, Sequence[int]] | None = None
                             ) -> list[bytes]:
        body = b"".join(self._COMPUTE.pack(int(t), float(d))
                        for t, d in items)
        extra = {}
        if payloads:
            # pre-pickle the payload section once: the same bytes are
            # the relay meter AND the wire content (nested as bytes in
            # the extras dict; decode unpickles the inner blob)
            data_blob = pickle.dumps(payloads, protocol=4)
            extra["data"] = data_blob
            self._payload_bytes += len(data_blob)
        if deps:
            extra["deps"] = {int(t): [int(d) for d in ds]
                             for t, ds in deps.items()}
        if hints:
            extra["hints"] = hints
        blob = pickle.dumps(extra, protocol=4) if extra else b""
        return [self._HDR.pack(OP_COMPUTE, 1 if blob else 0, len(items))
                + body + blob]

    def encode_finished_batch(self, wid: int,
                              items: Sequence[tuple[int, Any]],
                              usage: tuple | None = None,
                              timing: Sequence[tuple] | None = None
                              ) -> list[bytes]:
        payloads = {int(t): r for t, r in items if r is not _NO_RESULT}
        blob = pickle.dumps(payloads, protocol=4) if payloads else b""
        nb = float(len(blob)) / max(len(payloads), 1)
        body = b"".join(
            self._FINISHED.pack(int(t), int(wid),
                                nb if r is not _NO_RESULT else 0.0)
            for t, r in items)
        flags = (1 if blob else 0) | (2 if usage is not None else 0) \
            | (4 if timing else 0)
        head = (self._USAGE.pack(*(int(x) for x in usage))
                if usage is not None else b"")
        if timing:
            head += self._SUB.pack(len(timing))
            head += b"".join(self._TIMING.pack(*(int(x) for x in r))
                             for r in timing)
        return [self._HDR.pack(OP_FINISHED, flags, len(items))
                + head + body + blob]

    def encode_retract(self, tids: Iterable[int]) -> list[bytes]:
        tids = list(tids)
        body = b"".join(self._RETRACT.pack(int(t)) for t in tids)
        return [self._HDR.pack(OP_RETRACT, 0, len(tids)) + body]

    def encode_shutdown(self) -> bytes:
        return self._HDR.pack(OP_SHUTDOWN, 0, 0)

    def encode_update_graph(self, defs: Sequence[tuple[int, float]],
                            fns: dict[int, Any] | None = None
                            ) -> list[bytes]:
        """Incremental graph submission, RSDS-style: the whole epoch is
        one static frame (same record layout as compute), with a pickled
        ``{tid: (fn, args)}`` blob only for callable-carrying tasks."""
        body = b"".join(self._COMPUTE.pack(int(t), float(d))
                        for t, d in defs)
        blob = pickle.dumps(fns, protocol=4) if fns else b""
        return [self._HDR.pack(OP_UPDATE_GRAPH, 1 if blob else 0,
                               len(defs)) + body + blob]

    def encode_release(self, tids: Iterable[int]) -> list[bytes]:
        tids = list(tids)
        body = b"".join(self._RETRACT.pack(int(t)) for t in tids)
        return [self._HDR.pack(OP_RELEASE, 0, len(tids)) + body]

    def encode_gather(self, tids: Iterable[int]) -> list[bytes]:
        tids = list(tids)
        body = b"".join(self._RETRACT.pack(int(t)) for t in tids)
        return [self._HDR.pack(OP_GATHER, 0, len(tids)) + body]

    def _encode_reply(self, op: int, present: dict[int, Any],
                      absent: Iterable[int]) -> list[bytes]:
        absent = list(absent)
        body = b"".join(self._RETRACT.pack(int(t)) for t in absent)
        blob = (pickle.dumps({int(t): v for t, v in present.items()},
                             protocol=4) if present else b"")
        return [self._HDR.pack(op, 1 if blob else 0, len(absent))
                + body + blob]

    def encode_gather_reply(self, present: dict[int, Any],
                            absent: Iterable[int]) -> list[bytes]:
        return self._encode_reply(OP_GATHER_REPLY, present, absent)

    def encode_fetch(self, tids: Iterable[int]) -> list[bytes]:
        tids = list(tids)
        body = b"".join(self._RETRACT.pack(int(t)) for t in tids)
        return [self._HDR.pack(OP_FETCH, 0, len(tids)) + body]

    def encode_fetch_reply(self, present: dict[int, Any],
                           absent: Iterable[int]) -> list[bytes]:
        return self._encode_reply(OP_FETCH_REPLY, present, absent)

    def encode_fetch_failed(self, tid: int,
                            missing: Iterable[int]) -> list[bytes]:
        ids = [int(tid)] + [int(d) for d in missing]
        body = b"".join(self._RETRACT.pack(t) for t in ids)
        return [self._HDR.pack(OP_FETCH_FAILED, 0, len(ids)) + body]

    def encode_data_addr(self, wid: int, addr) -> list[bytes]:
        body = self._RETRACT.pack(int(wid))
        blob = pickle.dumps((str(addr[0]), int(addr[1])), protocol=4)
        return [self._HDR.pack(OP_DATA_ADDR, 1, 1) + body + blob]

    def encode_compact(self, base: int) -> list[bytes]:
        return [self._HDR.pack(OP_COMPACT, 0, 1)
                + self._RETRACT.pack(int(base))]

    def encode_stats(self, p2p_bytes: int, n_fetches: int,
                     usage: tuple | None = None) -> list[bytes]:
        body = self._STATS.pack(int(p2p_bytes), int(n_fetches))
        head = (self._USAGE.pack(*(int(x) for x in usage))
                if usage is not None else b"")
        return [self._HDR.pack(OP_STATS, 2 if usage is not None else 0, 1)
                + head + body]

    def encode_batch(self, frames: Sequence[bytes]) -> list[bytes]:
        """Coalesce already-encoded static frames into ONE transport
        send: header (count = sub-frame count) + length-prefixed
        sub-frames — fixed-record layout, no codec cost beyond the
        length prefixes."""
        body = b"".join(self._SUB.pack(len(f)) + f for f in frames)
        return [self._HDR.pack(OP_BATCH, 0, len(frames)) + body]

    def decode(self, raw: bytes):
        op, has_blob, count = self._HDR.unpack_from(raw)
        off = self._HDR.size
        if op == OP_BATCH:
            recs = []
            for _ in range(count):
                (n,) = self._SUB.unpack_from(raw, off)
                off += self._SUB.size
                recs.append(self.decode(raw[off:off + n]))
                off += n
            return op, recs, None
        if has_blob & 2:        # fixed-layout usage record (finished/stats)
            self._last_usage = self._USAGE.unpack_from(raw, off)
            off += self._USAGE.size
        if has_blob & 4:        # tracing section (finished frames)
            (n_tim,) = self._SUB.unpack_from(raw, off)
            off += self._SUB.size
            self._add_timing(
                self._TIMING.unpack_from(raw, off + i * self._TIMING.size)
                for i in range(n_tim))
            off += n_tim * self._TIMING.size
        has_blob &= 1
        if op in (OP_COMPUTE, OP_UPDATE_GRAPH):
            rec, recs = self._COMPUTE, []
            for i in range(count):
                recs.append(rec.unpack_from(raw, off + i * rec.size))
            off += count * rec.size
        elif op == OP_FINISHED:
            rec, recs = self._FINISHED, []
            for i in range(count):
                recs.append(rec.unpack_from(raw, off + i * rec.size))
            off += count * rec.size
        elif op == OP_STATS:
            rec = self._STATS
            recs = [rec.unpack_from(raw, off + i * rec.size)
                    for i in range(count)]
            off += count * rec.size
        elif op in (OP_RETRACT, OP_RELEASE, OP_GATHER, OP_GATHER_REPLY,
                    OP_FETCH, OP_FETCH_REPLY, OP_FETCH_FAILED,
                    OP_DATA_ADDR, OP_COMPACT):
            rec = self._RETRACT
            recs = [rec.unpack_from(raw, off + i * rec.size)[0]
                    for i in range(count)]
            off += count * rec.size
        elif op == OP_SHUTDOWN:
            recs = []           # a bare header: no records, no payload
        else:
            recs = []
        payloads = pickle.loads(raw[off:]) if has_blob else None
        if op == OP_COMPUTE and payloads is not None \
                and isinstance(payloads.get("data"), bytes):
            payloads["data"] = pickle.loads(payloads["data"])
        if op == OP_FINISHED and payloads is not None:
            self._payload_bytes += len(raw) - off
        elif op == OP_GATHER_REPLY and payloads is not None:
            self._gather_bytes += len(raw) - off
        elif op == OP_FETCH_FAILED:
            recs = [(recs[0], tuple(recs[1:]))] if recs else []
        elif op == OP_DATA_ADDR:
            recs = [int(recs[0])] if recs else []
        return op, recs, payloads


def make_wire(server_name: str):
    """Wire codec for a reactor flavour: dask -> per-message msgpack,
    rsds -> static batched frames."""
    return DaskWire() if server_name == "dask" else StaticWire()


def frame_event(op: int, wid: int, recs, payloads):
    """Normalize one decoded worker frame into the
    :class:`repro_torch.core.server.ServerCore` event vocabulary.

    This is the codec hook every server driver shares (selector and
    asyncio alike): the driver decodes with its wire codec — paying that
    codec's cost profile — and hands the core uniform events, so protocol
    handling never forks per driver.  Returns ``None`` for ops the server
    ignores."""
    if op == OP_FINISHED:
        return ("finished", [(int(t), int(w)) for t, w, _ in recs],
                payloads)
    if op == OP_GATHER_REPLY:
        return ("gather-reply", wid, recs, payloads)
    if op == OP_FETCH_FAILED:
        return ("fetch-failed", wid, recs)
    if op == OP_DATA_ADDR:
        return ("data-addr", int(recs[0]), tuple(payloads))
    if op == OP_STATS:
        return ("stats", recs)
    if op == OP_BATCH:
        # a batch's records are decoded sub-triples: normalize each and
        # hand back a ("batch", [events]) envelope the driver expands —
        # ServerCore._process_events only ever sees the flat vocabulary
        evs = [frame_event(sub_op, wid, sub_recs, sub_payloads)
               for sub_op, sub_recs, sub_payloads in recs]
        evs = [e for e in evs if e is not None]
        return ("batch", evs) if evs else None
    return None
