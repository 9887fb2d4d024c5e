"""Transport layer: how task payloads reach workers (the in-process part
of :mod:`repro.core.transport`).

* :class:`InprocTransport` — queue-based channels for the thread runtime.
  Messages are Python objects; no codec is paid (the Dask-style reactor
  keeps simulating it internally).

Not copied: the pipe, socket and asyncio transports and the worker data
plane of the process runtime, which the port does not have yet.
"""
from __future__ import annotations

import queue


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
