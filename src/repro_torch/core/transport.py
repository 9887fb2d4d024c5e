"""Pluggable transport layer: how task payloads reach workers.

A copy of :mod:`repro.core.transport` for the port.

The paper's thesis is that Dask's overhead is *runtime* cost — per-message
serialization and event-loop work at the server boundary.  The original
:class:`repro_torch.core.runtime.ThreadRuntime` kept workers in-process, so that
boundary was simulated.  This module makes it pluggable:

* :class:`InprocTransport` — queue-based channels for the thread runtime.
  Messages are Python objects; no codec is paid (the Dask-style reactor
  keeps simulating it internally, as before).
* :class:`PipeTransport` — one ``os.pipe()`` pair per worker **process**
  with 4-byte length-prefixed frames.  Fork start method only (raw fds).
* :class:`SocketTransport` — localhost TCP with the same framing; works
  with any start method (workers connect by address).
* :class:`AsyncioTransport` — the same byte channels (pipe or socket)
  wrapped in **asyncio** StreamReader/StreamWriter endpoints for the
  asyncio (and uvloop) server drivers: per-worker reader coroutines
  feed one event queue, sends buffer on StreamWriters and drain in
  batches.  Workers stay on the blocking endpoints — the server
  architecture is the only variable, which is exactly the axis the
  paper measures.

The worker↔worker **data plane** (p2p PR) also lives here:
:class:`DataPlaneListener` serves a worker's stored values to peers
from a background accept loop, and :class:`PeerChannel` is the caller
side — one persistent connection per (fetcher, holder) pair carrying
length-prefixed fetch/fetch-reply frames, so dependency payloads move
directly between workers instead of relaying through the server.

Server sides of the selector transports are *selector-driven and
never block on send*: outbound frames go through a non-blocking buffered
writer (:class:`_NBWriter`), so a flood of compute messages cannot
deadlock against workers flooding completions back.  Worker endpoints are
plain blocking I/O (single-threaded workers, matching the paper's setup).

Wire *content* (what the bytes mean) lives in :mod:`repro_torch.core.messages`;
this module only moves frames.
"""
from __future__ import annotations

import asyncio
import collections
import os
import queue
import selectors
import socket
import struct
import threading
import time

_LEN = struct.Struct("<I")


class TransportClosed(Exception):
    """Peer hung up (EOF on the channel)."""


# ---------------------------------------------------------------------------
# In-process transport (thread runtime)
# ---------------------------------------------------------------------------

class InprocTransport:
    """Per-worker object queues + one multiplexed server inbox.

    This is the existing thread-runtime wiring lifted behind the transport
    interface.  ``inject`` lets any thread hand the server loop a control
    event (e.g. ``("worker-lost", wid, lost)``) so reactor mutation stays
    on the server thread.
    """
    name = "inproc"

    def __init__(self, n_workers: int):
        self.inbox: queue.Queue = queue.Queue()
        self.worker_queues: list[queue.Queue] = [queue.Queue()
                                                 for _ in range(n_workers)]

    # server side -------------------------------------------------------
    def send(self, wid: int, item) -> None:
        self.worker_queues[wid].put(item)

    def recv(self, timeout: float | None = None):
        """One event, or raise queue.Empty after ``timeout``."""
        return self.inbox.get(timeout=timeout)

    def drain(self) -> list:
        out = []
        while True:
            try:
                out.append(self.inbox.get_nowait())
            except queue.Empty:
                return out

    def inject(self, event) -> None:
        self.inbox.put(event)

    def add_worker(self) -> int:
        self.worker_queues.append(queue.Queue())
        return len(self.worker_queues) - 1

    # worker side -------------------------------------------------------
    def worker_recv(self, wid: int):
        return self.worker_queues[wid].get()

    def worker_send(self, wid: int, item) -> None:
        self.inbox.put(item)

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# Non-blocking buffered writer (server side of process transports)
# ---------------------------------------------------------------------------

class _NBWriter:
    """Buffers outbound bytes over a non-blocking fd/socket.

    ``write`` never blocks: what the kernel won't take is buffered and
    retried on the next ``flush``.  This breaks the send/send deadlock
    cycle between a server dispatching a large batch and workers pushing
    completions back."""

    def __init__(self, write_fn):
        self._write = write_fn          # bytes -> n_written (may raise)
        self.buf = bytearray()

    def write(self, data: bytes) -> None:
        self.buf += data
        self.flush()

    def flush(self) -> bool:
        """Push buffered bytes; True when the buffer is empty."""
        while self.buf:
            try:
                n = self._write(self.buf)
            except (BlockingIOError, InterruptedError):
                return False
            if n <= 0:
                return False
            del self.buf[:n]
        return True


# ---------------------------------------------------------------------------
# Pipe transport (fork start method)
# ---------------------------------------------------------------------------

class PipeTransport:
    """One pair of unidirectional pipes per worker, length-prefixed frames.

    Raw ``os.pipe()`` fds (not ``multiprocessing.Pipe``) so the server can
    write non-blocking with manual framing.  Children must close every
    inherited fd except their own pair — :meth:`child_cleanup` lists them —
    otherwise EOF-on-death detection breaks.
    """
    name = "pipe"

    def __init__(self, n_workers: int):
        self.n_workers = n_workers
        self._s2w = []   # (r, w): server writes w, worker reads r
        self._w2s = []   # (r, w): worker writes w, server reads r
        for _ in range(n_workers):
            self._s2w.append(os.pipe())
            self._w2s.append(os.pipe())
        self._writers: dict[int, _NBWriter] = {}
        self._rbufs: dict[int, bytearray] = {}
        self._sel = selectors.DefaultSelector()
        self._open: set[int] = set()
        self._warmed: set[int] = set()   # wids with EVENT_WRITE armed

    # lifecycle ---------------------------------------------------------
    def worker_args(self, wid: int):
        return ("pipe", self._s2w[wid][0], self._w2s[wid][1])

    def child_cleanup(self, wid: int) -> list[int]:
        fds = []
        for i in range(self.n_workers):
            fds += [self._s2w[i][1], self._w2s[i][0]]
            if i != wid:
                fds += [self._s2w[i][0], self._w2s[i][1]]
        return fds

    def after_start(self, procs=None, timeout: float = 30.0) -> None:
        """Close the parent's copies of the child ends; arm the selector."""
        for wid in range(self.n_workers):
            os.close(self._s2w[wid][0])
            os.close(self._w2s[wid][1])
            wfd = self._s2w[wid][1]
            rfd = self._w2s[wid][0]
            os.set_blocking(wfd, False)
            os.set_blocking(rfd, False)
            self._writers[wid] = _NBWriter(lambda b, fd=wfd: os.write(fd, b))
            self._rbufs[wid] = bytearray()
            self._sel.register(rfd, selectors.EVENT_READ, wid)
            self._open.add(wid)

    # server side -------------------------------------------------------
    def send(self, wid: int, data: bytes) -> None:
        if wid not in self._open:
            return
        self._writers[wid].buf += _LEN.pack(len(data)) + data
        self._flush_writer(wid)

    def _flush_writer(self, wid: int) -> None:
        """Flush one writer and keep EVENT_WRITE interest in sync: armed
        while bytes are parked, disarmed once drained.  Without the
        arming, a buffered burst (a batch envelope past the pipe buffer)
        only retries on read events or the poll timeout — and the
        workers the burst is addressed to are idle, producing no read
        events, so the buffer trickles out one timeout at a time."""
        w = self._writers.get(wid)
        if w is None:
            return
        try:
            done = w.flush()
        except OSError:
            done = True  # peer died; the read side reports it
        wfd = self._s2w[wid][1]
        if done and wid in self._warmed:
            self._warmed.discard(wid)
            try:
                self._sel.unregister(wfd)
            except (KeyError, ValueError, OSError):
                pass
        elif not done and wid not in self._warmed:
            self._warmed.add(wid)
            try:
                self._sel.register(wfd, selectors.EVENT_WRITE, wid)
            except (KeyError, ValueError, OSError):
                pass

    def poll(self, timeout: float) -> list[tuple[int, bytes | None]]:
        """Flush pending sends, then gather complete inbound frames.

        Returns ``(wid, frame_bytes)`` entries; ``(wid, None)`` marks EOF
        (worker death)."""
        for wid in list(self._warmed):
            self._flush_writer(wid)
        events: list[tuple[int, bytes | None]] = []
        if not self._open:
            time.sleep(min(timeout, 0.01))
            return events
        for key, mask in self._sel.select(timeout):
            wid = key.data
            if key.events & selectors.EVENT_WRITE:
                self._flush_writer(wid)
                continue
            buf = self._rbufs[wid]
            eof = False
            while True:
                try:
                    chunk = os.read(key.fd, 1 << 16)
                except (BlockingIOError, InterruptedError):
                    break
                except OSError:
                    chunk = b""
                if not chunk:
                    eof = True
                    break
                buf += chunk
            events.extend((wid, f) for f in _split_frames(buf))
            if eof:
                self.drop(wid)
                events.append((wid, None))
        return events

    def drop(self, wid: int) -> None:
        if wid not in self._open:
            return
        self._open.discard(wid)
        self._writers.pop(wid, None)
        self._rbufs.pop(wid, None)
        try:
            self._sel.unregister(self._w2s[wid][0])
        except (KeyError, ValueError):
            pass
        if wid in self._warmed:
            self._warmed.discard(wid)
            try:
                self._sel.unregister(self._s2w[wid][1])
            except (KeyError, ValueError, OSError):
                pass
        for fd in (self._w2s[wid][0], self._s2w[wid][1]):
            try:
                os.close(fd)
            except OSError:
                pass

    def close(self) -> None:
        for wid in list(self._open):
            self.drop(wid)
        self._sel.close()


def _split_frames(buf: bytearray) -> list[bytes]:
    frames = []
    while len(buf) >= _LEN.size:
        (n,) = _LEN.unpack_from(buf)
        if len(buf) < _LEN.size + n:
            break
        frames.append(bytes(buf[_LEN.size:_LEN.size + n]))
        del buf[:_LEN.size + n]
    return frames


# ---------------------------------------------------------------------------
# Socket transport (any start method)
# ---------------------------------------------------------------------------

class SocketTransport:
    """Localhost TCP, 4-byte length-prefixed frames, hello(wid) handshake."""
    name = "socket"

    def __init__(self, n_workers: int):
        self.n_workers = n_workers
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(n_workers)
        self.addr = self._listener.getsockname()
        self._conns: dict[int, socket.socket] = {}
        self._writers: dict[int, _NBWriter] = {}
        self._rbufs: dict[int, bytearray] = {}
        self._sel = selectors.DefaultSelector()
        self._open: set[int] = set()
        self._warmed: set[int] = set()   # wids with EVENT_WRITE armed

    def worker_args(self, wid: int):
        return ("socket", self.addr, wid)

    def child_cleanup(self, wid: int) -> list[int]:
        return []  # children create their own socket after start

    def after_start(self, procs=None, timeout: float = 30.0) -> None:
        """Accept one connection per worker (identified by hello frame)."""
        self._listener.settimeout(timeout)
        for _ in range(self.n_workers):
            conn, _ = self._listener.accept()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            hello = _recv_exact(conn, _LEN.size)
            (wid,) = _LEN.unpack(hello)
            conn.setblocking(False)
            self._conns[wid] = conn
            self._writers[wid] = _NBWriter(conn.send)
            self._rbufs[wid] = bytearray()
            self._sel.register(conn, selectors.EVENT_READ, wid)
            self._open.add(wid)
        self._listener.close()

    def send(self, wid: int, data: bytes) -> None:
        if wid not in self._open:
            return
        self._writers[wid].buf += _LEN.pack(len(data)) + data
        self._flush_writer(wid)

    def _flush_writer(self, wid: int) -> None:
        """Flush one writer; arm EVENT_WRITE interest while bytes are
        parked so ``select`` wakes the moment the socket drains (see
        :meth:`PipeTransport._flush_writer`)."""
        w = self._writers.get(wid)
        if w is None:
            return
        try:
            done = w.flush()
        except OSError:
            done = True  # death is reported via the read side
        want = (selectors.EVENT_READ if done
                else selectors.EVENT_READ | selectors.EVENT_WRITE)
        armed = wid in self._warmed
        if done is armed:  # interest out of sync with buffer state
            (self._warmed.discard if done else self._warmed.add)(wid)
            try:
                self._sel.modify(self._conns[wid], want, wid)
            except (KeyError, ValueError, OSError):
                pass

    def poll(self, timeout: float) -> list[tuple[int, bytes | None]]:
        for wid in list(self._warmed):
            self._flush_writer(wid)
        events: list[tuple[int, bytes | None]] = []
        if not self._open:
            time.sleep(min(timeout, 0.01))
            return events
        for key, mask in self._sel.select(timeout):
            wid = key.data
            if mask & selectors.EVENT_WRITE:
                self._flush_writer(wid)
                if wid not in self._open or not (
                        mask & selectors.EVENT_READ):
                    continue
            buf = self._rbufs[wid]
            eof = False
            while True:
                try:
                    chunk = self._conns[wid].recv(1 << 16)
                except (BlockingIOError, InterruptedError):
                    break
                except OSError:
                    chunk = b""
                if not chunk:
                    eof = True
                    break
                buf += chunk
            events.extend((wid, f) for f in _split_frames(buf))
            if eof:
                self.drop(wid)
                events.append((wid, None))
        return events

    def drop(self, wid: int) -> None:
        if wid not in self._open:
            return
        self._open.discard(wid)
        self._warmed.discard(wid)
        self._writers.pop(wid, None)
        self._rbufs.pop(wid, None)
        conn = self._conns.pop(wid)
        try:
            self._sel.unregister(conn)
        except (KeyError, ValueError):
            pass
        try:
            conn.close()
        except OSError:
            pass

    def close(self) -> None:
        for wid in list(self._open):
            self.drop(wid)
        self._sel.close()


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise TransportClosed("peer closed during handshake")
        buf += chunk
    return buf


# ---------------------------------------------------------------------------
# Asyncio transport (asyncio server driver; workers stay blocking)
# ---------------------------------------------------------------------------

class AsyncioTransport:
    """Asyncio server endpoints over the pipe or socket byte channels.

    Construction is synchronous (the fds/listener must exist before the
    workers spawn); the stream wrapping happens on the running event loop
    via :meth:`a_start`, which returns the ``asyncio.Queue`` that the
    per-worker reader tasks feed with ``(wid, frame)`` tuples —
    ``(wid, None)`` marks EOF (worker death).  ``send`` writes
    synchronously into the StreamWriter's buffer; :meth:`a_flush` spawns
    one drainer task per backlogged worker (the asyncio analogue of
    :class:`_NBWriter`'s flush) — drains are per-worker backpressure, so
    awaiting them inline would let ONE slow reader stall dispatch to
    every other worker."""

    def __init__(self, kind: str, n_workers: int):
        if kind not in ("pipe", "socket"):
            raise ValueError(f"unknown transport {kind!r} "
                             "(want pipe|socket)")
        self.kind = kind
        self.name = kind
        self.n_workers = n_workers
        self._writers: dict[int, asyncio.StreamWriter] = {}
        # pipe reads get their own transport (socket reads share the
        # writer's); closed explicitly so fds never wait on cyclic GC
        self._rtransports: dict[int, asyncio.ReadTransport] = {}
        self._tasks: list = []
        self._drainers: dict[int, asyncio.Task] = {}
        self._dirty: set[int] = set()
        self._open: set[int] = set()
        self._q: asyncio.Queue | None = None
        self._started = False
        if kind == "pipe":
            self._s2w = [os.pipe() for _ in range(n_workers)]
            self._w2s = [os.pipe() for _ in range(n_workers)]
        else:
            self._listener = socket.socket(socket.AF_INET,
                                           socket.SOCK_STREAM)
            self._listener.setsockopt(socket.SOL_SOCKET,
                                      socket.SO_REUSEADDR, 1)
            self._listener.bind(("127.0.0.1", 0))
            self._listener.listen(n_workers)
            self.addr = self._listener.getsockname()

    # lifecycle ---------------------------------------------------------
    def worker_args(self, wid: int):
        if self.kind == "pipe":
            return ("pipe", self._s2w[wid][0], self._w2s[wid][1])
        return ("socket", self.addr, wid)

    def child_cleanup(self, wid: int) -> list[int]:
        if self.kind != "pipe":
            return []   # children create their own socket after start
        fds = []
        for i in range(self.n_workers):
            fds += [self._s2w[i][1], self._w2s[i][0]]
            if i != wid:
                fds += [self._s2w[i][0], self._w2s[i][1]]
        return fds

    async def a_start(self, timeout: float = 30.0) -> asyncio.Queue:
        """Wrap every worker channel in asyncio streams and start the
        reader tasks; returns the shared inbound-frame queue."""
        loop = asyncio.get_running_loop()
        self._q = asyncio.Queue()
        self._started = True
        if self.kind == "pipe":
            for wid in range(self.n_workers):
                # close the parent's copies of the child ends, or
                # EOF-on-death detection breaks
                os.close(self._s2w[wid][0])
                os.close(self._w2s[wid][1])
                rfd = self._w2s[wid][0]
                wfd = self._s2w[wid][1]
                reader = asyncio.StreamReader()
                # one-time loop setup: fdopen only wraps the already-
                # open pipe fds (no I/O), it never runs per-frame
                rtr, _ = await loop.connect_read_pipe(
                    lambda r=reader: asyncio.StreamReaderProtocol(r),
                    os.fdopen(rfd, "rb", 0))   # ra: allow-blocking
                self._rtransports[wid] = rtr
                wt, wp = await loop.connect_write_pipe(
                    asyncio.streams.FlowControlMixin,
                    os.fdopen(wfd, "wb", 0))   # ra: allow-blocking
                writer = asyncio.StreamWriter(wt, wp, None, loop)
                self._register(wid, reader, writer)
        else:
            self._listener.setblocking(False)
            for _ in range(self.n_workers):
                conn, _ = await asyncio.wait_for(
                    loop.sock_accept(self._listener), timeout)
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                reader, writer = await asyncio.open_connection(sock=conn)
                hello = await asyncio.wait_for(
                    reader.readexactly(_LEN.size), timeout)
                (wid,) = _LEN.unpack(hello)
                self._register(wid, reader, writer)
            self._listener.close()
        return self._q

    def _register(self, wid: int, reader: asyncio.StreamReader,
                  writer: asyncio.StreamWriter) -> None:
        self._writers[wid] = writer
        self._open.add(wid)
        self._tasks.append(asyncio.get_running_loop().create_task(
            self._read_loop(wid, reader)))

    async def _read_loop(self, wid: int,
                         reader: asyncio.StreamReader) -> None:
        q = self._q
        try:
            while True:
                hdr = await reader.readexactly(_LEN.size)
                (n,) = _LEN.unpack(hdr)
                q.put_nowait((wid, await reader.readexactly(n)))
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            q.put_nowait((wid, None))

    # server side -------------------------------------------------------
    def send(self, wid: int, data: bytes) -> None:
        w = self._writers.get(wid)
        if w is None:
            return
        try:
            w.write(_LEN.pack(len(data)) + data)
        except Exception:
            pass  # death is reported via the read side
        self._dirty.add(wid)

    async def a_flush(self) -> None:
        """Never awaits a peer inline.  StreamWriter.write already handed
        the bytes to the loop (which pumps them as the fd drains);
        ``drain()`` only applies producer backpressure, and that must be
        per-worker — one drainer task per backlogged writer, so a full
        pipe to a slow worker cannot stall sends to the rest."""
        for wid in list(self._dirty):
            self._dirty.discard(wid)
            if wid in self._drainers or wid not in self._writers:
                continue    # a drainer is already waiting on this fd
            t = asyncio.get_running_loop().create_task(self._drain(wid))
            self._drainers[wid] = t
            t.add_done_callback(
                lambda _t, wid=wid: self._drainers.pop(wid, None))
        # yield once so writers with room complete their drains now and
        # transient backlog does not accumulate drainer tasks
        await asyncio.sleep(0)

    async def _drain(self, wid: int) -> None:
        w = self._writers.get(wid)
        if w is None:
            return
        try:
            await w.drain()
        except (ConnectionError, OSError, RuntimeError):
            pass  # peer died; the read side reports it

    def drop(self, wid: int) -> None:
        self._open.discard(wid)
        self._dirty.discard(wid)
        t = self._drainers.pop(wid, None)
        if t is not None:
            t.cancel()      # a drain on a dead peer never completes
        w = self._writers.pop(wid, None)
        if w is not None:
            try:
                w.close()
            except Exception:
                pass
        rt = self._rtransports.pop(wid, None)
        if rt is not None:
            try:
                rt.close()
            except Exception:
                pass

    def poll(self, timeout: float):
        """Selector-compat no-op (the graceful-shutdown drain calls it);
        the asyncio driver pumps events through :meth:`a_start`'s queue."""
        time.sleep(min(timeout, 0.01))
        return []

    async def a_close(self) -> None:
        for t in list(self._drainers.values()) + self._tasks:
            t.cancel()
        for t in list(self._drainers.values()) + self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks = []
        self._drainers.clear()
        for wid in set(self._writers) | set(self._rtransports):
            self.drop(wid)
        # transport.close() only *schedules* the fd close (call_soon);
        # yield to the loop so the callbacks run before it shuts down,
        # or every run leaks its pipe/socket fds until cyclic GC
        for _ in range(3):
            await asyncio.sleep(0)

    def close(self) -> None:
        """Off-loop leftover cleanup (idempotent)."""
        if self.kind == "socket":
            try:
                self._listener.close()
            except OSError:
                pass
        elif not self._started:
            # streams never wrapped the fds: close both ends ourselves
            for pairs in (self._s2w, self._w2s):
                for r, w in pairs:
                    for fd in (r, w):
                        try:
                            os.close(fd)
                        except OSError:
                            pass
            self._s2w = self._w2s = []


# ---------------------------------------------------------------------------
# Worker endpoints (blocking I/O inside the worker process)
# ---------------------------------------------------------------------------

class WorkerEndpoint:
    """Blocking framed channel as seen from inside a worker process."""

    def recv(self, timeout: float | None = None) -> bytes | None:
        """One frame; None on timeout; raises TransportClosed on EOF."""
        raise NotImplementedError

    def send(self, data: bytes) -> None:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


class _PipeWorkerEndpoint(WorkerEndpoint):
    def __init__(self, rfd: int, wfd: int):
        self.rfd, self.wfd = rfd, wfd
        self.buf = bytearray()
        self.frames: collections.deque[bytes] = collections.deque()
        self._sel = selectors.DefaultSelector()
        self._sel.register(rfd, selectors.EVENT_READ)

    def recv(self, timeout: float | None = None) -> bytes | None:
        while True:
            if self.frames:
                return self.frames.popleft()
            if not self._sel.select(timeout):
                return None
            chunk = os.read(self.rfd, 1 << 16)
            if not chunk:
                raise TransportClosed("server closed pipe")
            self.buf += chunk
            self.frames.extend(_split_frames(self.buf))

    def send(self, data: bytes) -> None:
        payload = _LEN.pack(len(data)) + data
        view = memoryview(payload)
        while view:
            n = os.write(self.wfd, view)
            view = view[n:]

    def close(self) -> None:
        self._sel.close()
        for fd in (self.rfd, self.wfd):
            try:
                os.close(fd)
            except OSError:
                pass


class _SocketWorkerEndpoint(WorkerEndpoint):
    def __init__(self, addr, wid: int):
        self.sock = socket.create_connection(addr, timeout=30.0)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock.sendall(_LEN.pack(wid))     # hello
        self.sock.settimeout(None)
        self.buf = bytearray()
        self.frames: collections.deque[bytes] = collections.deque()

    def recv(self, timeout: float | None = None) -> bytes | None:
        while True:
            if self.frames:
                return self.frames.popleft()
            self.sock.settimeout(timeout)
            try:
                chunk = self.sock.recv(1 << 16)
            except (socket.timeout, BlockingIOError, InterruptedError):
                # timeout=0 puts the socket in non-blocking mode, where
                # "nothing there" is BlockingIOError rather than timeout
                return None
            finally:
                self.sock.settimeout(None)
            if not chunk:
                raise TransportClosed("server closed socket")
            self.buf += chunk
            self.frames.extend(_split_frames(self.buf))

    def send(self, data: bytes) -> None:
        self.sock.sendall(_LEN.pack(len(data)) + data)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Worker-to-worker data plane (p2p dependency fetch)
# ---------------------------------------------------------------------------

class DataPlaneListener:
    """Per-worker data-plane server: peers dial in and each inbound frame
    is answered with ``handler(frame) -> reply_frame``.

    Runs on a daemon thread inside the worker process so fetch requests
    are served while the (single-threaded) compute loop is busy — the
    same shape as Dask's worker, which serves data over its event loop
    concurrently with task execution.  Wire content is the caller's
    business (the handler decodes/encodes via :mod:`repro_torch.core.messages`
    and reads values out of the worker's
    :class:`repro_torch.core.store.ObjectStore`, unspilling on demand — the
    store's internal lock makes that safe against the compute loop);
    this class only moves frames, like the rest of the module.
    """

    def __init__(self, handler, host: str = "127.0.0.1"):
        self._handler = handler
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, 0))
        self._listener.listen(64)
        self._listener.setblocking(False)
        self.addr = self._listener.getsockname()
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._listener, selectors.EVENT_READ, None)
        self._bufs: dict[socket.socket, bytearray] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        while not self._stop.is_set():
            for key, _ in self._sel.select(0.1):
                if key.data is None:            # listener: new peer
                    try:
                        conn, _ = self._listener.accept()
                    except OSError:
                        continue
                    conn.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
                    conn.setblocking(False)
                    self._bufs[conn] = bytearray()
                    self._sel.register(conn, selectors.EVENT_READ, conn)
                    continue
                conn = key.data
                buf = self._bufs[conn]
                closed = False
                while True:
                    try:
                        chunk = conn.recv(1 << 16)
                    except (BlockingIOError, InterruptedError):
                        break
                    except OSError:
                        chunk = b""
                    if not chunk:
                        closed = True
                        break
                    buf += chunk
                for frame in _split_frames(buf):
                    try:
                        reply = self._handler(frame)
                    except Exception:
                        # a broken request must not kill the data plane;
                        # dropping the connection surfaces the failure to
                        # the peer as TransportClosed (it falls back)
                        closed = True
                        break
                    try:
                        conn.setblocking(True)
                        conn.sendall(_LEN.pack(len(reply)) + reply)
                        conn.setblocking(False)
                    except OSError:
                        closed = True
                        break
                if closed:
                    self._drop_conn(conn)

    def _drop_conn(self, conn: socket.socket) -> None:
        self._bufs.pop(conn, None)
        try:
            self._sel.unregister(conn)
        except (KeyError, ValueError):
            pass
        try:
            conn.close()
        except OSError:
            pass

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
        for conn in list(self._bufs):
            self._drop_conn(conn)
        try:
            self._sel.unregister(self._listener)
        except (KeyError, ValueError):
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        self._sel.close()


class PeerChannel:
    """Blocking client side of a worker↔worker data channel: dial once,
    then frame-per-request / frame-per-reply.  Raises
    :class:`TransportClosed` when the peer hangs up (holder death — the
    caller falls back to the server relay path)."""

    def __init__(self, addr, connect_timeout: float = 5.0):
        try:
            self.sock = socket.create_connection(
                tuple(addr), timeout=connect_timeout)
        except OSError as exc:
            raise TransportClosed(f"peer {addr} unreachable: {exc}")
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.buf = bytearray()
        self.frames: collections.deque[bytes] = collections.deque()

    def request(self, frame: bytes, timeout: float = 10.0) -> bytes:
        """One round-trip: send ``frame``, block for exactly one reply."""
        try:
            self.sock.settimeout(timeout)
            self.sock.sendall(_LEN.pack(len(frame)) + frame)
            while not self.frames:
                chunk = self.sock.recv(1 << 16)
                if not chunk:
                    raise TransportClosed("peer closed data channel")
                self.buf += chunk
                self.frames.extend(_split_frames(self.buf))
        except socket.timeout:
            raise TransportClosed("peer fetch timed out")
        except OSError as exc:
            raise TransportClosed(f"peer fetch failed: {exc}")
        return self.frames.popleft()

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def make_worker_endpoint(args) -> WorkerEndpoint:
    kind = args[0]
    if kind == "pipe":
        return _PipeWorkerEndpoint(args[1], args[2])
    if kind == "socket":
        return _SocketWorkerEndpoint(args[1], args[2])
    raise ValueError(f"unknown worker endpoint kind {kind!r}")


def make_server_transport(kind: str, n_workers: int):
    if kind == "pipe":
        return PipeTransport(n_workers)
    if kind == "socket":
        return SocketTransport(n_workers)
    raise ValueError(f"unknown transport {kind!r} (want pipe|socket)")
