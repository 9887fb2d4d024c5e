"""The port's wire codecs and transports (``repro_torch.core.messages``,
``repro_torch.core.transport``) against ``repro.core``'s.

For every frame op of both codecs (``DaskWire``, ``StaticWire``) the same
calls give byte-identical frames in both packages, each package decodes
the other's frames to the same records, and the side channels (payload
and gather bytes, the usage record, tracing records) read the same.  The
transports' framing, the worker endpoints and the data plane
(``DataPlaneListener``, ``PeerChannel``) are run in-process, on loopback,
as ``tests/test_transport.py`` runs the reference's."""
import asyncio
import os
import pickle
import threading

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import messages as jmsg  # noqa: E402
from repro_torch.core import messages as tmsg  # noqa: E402
from repro_torch.core import transport as tp  # noqa: E402
from torch_core_tasks import _plus1  # noqa: E402

WIRES = ["dask", "rsds"]
USAGE = (1024, 4096, 2048, 512, 3, 2)
TIMING = [(5, 10, 20, 30, 4), (6, 11, 21, 31, 0)]
HINTS = {5: {2: ("127.0.0.1", 4242)}, 6: {3: ("127.0.0.1", 4343)}}


def _frames(m, wire, op: str) -> list[bytes]:
    """The frames of one op, built by ``m``'s codec ``wire`` from the same
    arguments in both packages."""
    if op == "compute":
        return wire.encode_compute_batch(
            [(5, 0.5), (6, 0.0), (7, 0.25)],
            payloads={5: {2: np.arange(4.0), 9: "x"}},
            inputs_of=lambda t: [2, 9] if t == 5 else [3],
            hints=HINTS, deps={5: [2, 9], 6: [3]})
    if op == "finished":
        return wire.encode_finished_batch(
            3, [(5, {"v": [1, 2]}), (6, m._NO_RESULT), (7, 42)],
            USAGE, timing=TIMING)
    if op == "retract":
        return wire.encode_retract([4, 8])
    if op == "shutdown":
        return [wire.encode_shutdown()]
    if op == "update_graph":
        return wire.encode_update_graph([(5, 0.25), (6, 0.0), (7, 0.5)],
                                        {6: (_plus1, ()), 7: (None, (1,))})
    if op == "release":
        return wire.encode_release([3, 9])
    if op == "gather":
        return wire.encode_gather([4, 8, 15])
    if op == "gather_reply":
        return wire.encode_gather_reply({4: np.ones(3), 8: "v"}, [15])
    if op == "fetch":
        return wire.encode_fetch([2, 9])
    if op == "fetch_reply":
        return wire.encode_fetch_reply({2: "val"}, [9])
    if op == "fetch_failed":
        return wire.encode_fetch_failed(7, [2, 3])
    if op == "data_addr":
        return wire.encode_data_addr(1, ("127.0.0.1", 9999))
    if op == "stats":
        return wire.encode_stats(4096, 3, USAGE)
    if op == "compact":
        return wire.encode_compact(4096)
    if op == "batch":
        subs = (wire.encode_finished_batch(2, [(8, m._NO_RESULT),
                                               (9, m._NO_RESULT)], USAGE)
                + wire.encode_stats(10, 1, USAGE)
                + wire.encode_retract([3]) + wire.encode_compact(7))
        return wire.encode_batch(subs)
    raise KeyError(op)


OPS = ["compute", "finished", "retract", "shutdown", "update_graph",
       "release", "gather", "gather_reply", "fetch", "fetch_reply",
       "fetch_failed", "data_addr", "stats", "compact", "batch"]


def _canon(x):
    """Decoded records in a comparable form: arrays to lists, the
    package's own ``_NO_RESULT`` to a name, tuples kept apart from
    lists."""
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.tolist())
    if isinstance(x, dict):
        return {"dict": sorted((repr(k), _canon(v)) for k, v in x.items())}
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, [_canon(v) for v in x])
    if x is jmsg._NO_RESULT or x is tmsg._NO_RESULT:
        return "_NO_RESULT"
    return x


def _side(wire):
    return (wire.take_payload_bytes(), wire.take_gather_bytes(),
            wire.take_usage(), wire.take_timing())


def test_the_op_codes_are_the_reference_codes():
    names = sorted(n for n in dir(jmsg) if n.startswith("OP_"))
    assert names == sorted(n for n in dir(tmsg) if n.startswith("OP_"))
    assert {n: getattr(tmsg, n) for n in names} == \
        {n: getattr(jmsg, n) for n in names}
    assert len(OPS) == len(names)
    for name in ("COMPUTE_TASK", "TASK_FINISHED", "STEAL_REQUEST",
                 "RELEASE_DATA", "GRAPH_SUBMIT"):
        assert getattr(tmsg, name) == getattr(jmsg, name)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("wire_name", WIRES)
def test_frames_are_byte_identical_and_cross_decode(wire_name, op):
    jw, tw = jmsg.make_wire(wire_name), tmsg.make_wire(wire_name)
    assert type(tw).__name__ == type(jw).__name__
    assert (tw.name, tw.batched) == (jw.name, jw.batched)
    jf, tf = _frames(jmsg, jw, op), _frames(tmsg, tw, op)
    assert tf == jf
    assert _side(tw) == _side(jw)          # encode-side meters
    # each package decodes the other's frames as it decodes its own
    dec = {}
    for name, m in (("ref", jmsg), ("port", tmsg)):
        for src, frames in (("ref", jf), ("port", tf)):
            w = m.make_wire(wire_name)
            dec[name, src] = ([_canon(w.decode(f)) for f in frames],
                              _side(w))
    assert len(set(map(repr, dec.values()))) == 1, dec


@pytest.mark.parametrize("wire_name", WIRES)
def test_frame_event_normalizes_as_the_reference(wire_name):
    for op in ("finished", "gather_reply", "fetch_failed", "data_addr",
               "stats", "batch", "release"):
        for raw in _frames(tmsg, tmsg.make_wire(wire_name), op):
            dt = tmsg.make_wire(wire_name).decode(raw)
            dj = jmsg.make_wire(wire_name).decode(raw)
            got = tmsg.frame_event(dt[0], 3, dt[1], dt[2])
            want = jmsg.frame_event(dj[0], 3, dj[1], dj[2])
            assert _canon(got) == _canon(want), op


@pytest.mark.parametrize("wire_name", WIRES)
def test_reactor_codec_helpers_match(wire_name):
    """``pack``/``unpack``/``compute_task``/``task_finished``: the thread
    runtime's simulated Dask codec, same bytes as the reference."""
    for m in (tmsg.compute_task(5, 1, [2, 3], {2: [0], 3: [1, 2]}),
              tmsg.task_finished(5, 1, 96.0)):
        assert tmsg.pack(m) == jmsg.pack(m)
    m = tmsg.task_finished(5, 1, 96.0)
    assert tmsg.unpack(jmsg.pack(m)) == jmsg.unpack(tmsg.pack(m)) == m
    assert tmsg.compute_task(5, 1, [2], {2: [0]}) == \
        jmsg.compute_task(5, 1, [2], {2: [0]})


def test_codec_asymmetry_bytes():
    """Static batched frames are far smaller than per-message msgpack for
    the same batch (the paper's protocol modification)."""
    items = [(i, 0.001) for i in range(1000)]
    dask = sum(len(f) for f in tmsg.DaskWire().encode_compute_batch(
        items, inputs_of=lambda t: []))
    static = sum(len(f) for f in tmsg.StaticWire().encode_compute_batch(
        items))
    assert static < 0.5 * dask
    assert dask == sum(len(f) for f in jmsg.DaskWire().encode_compute_batch(
        items, inputs_of=lambda t: []))


def test_update_graph_callables_survive_the_wire():
    for name in WIRES:
        w = tmsg.make_wire(name)
        frames = w.encode_update_graph([(6, 0.0)], {6: (_plus1, ())})
        _, recs, payloads = w.decode(frames[-1])
        fn, args = payloads[6]
        assert fn(41) == 42 and args == ()
        assert pickle.dumps(fn) == pickle.dumps(_plus1)


# ---------------------------------------------------------------------------
# transports (in-process; the worker side on a thread)
# ---------------------------------------------------------------------------

def test_split_frames_partial():
    buf = bytearray(tp._LEN.pack(5) + b"hello" + tp._LEN.pack(3) + b"wo")
    assert tp._split_frames(buf) == [b"hello"]
    assert bytes(buf) == tp._LEN.pack(3) + b"wo"
    buf += b"r"
    assert tp._split_frames(buf) == [b"wor"]
    assert not buf


def test_nbwriter_buffers_on_eagain():
    writes = []
    state = {"block": True}

    def write_fn(b):
        if state["block"]:
            raise BlockingIOError
        writes.append(bytes(b[:4]))
        return min(4, len(b))

    w = tp._NBWriter(write_fn)
    w.write(b"12345678")
    assert w.buf == bytearray(b"12345678")
    state["block"] = False
    assert w.flush()
    assert b"".join(writes) == b"12345678"


def _poll_until(server, n_polls=200):
    got = []
    for _ in range(n_polls):
        got += server.poll(0.05)
        if got:
            return got
    return got


def test_socket_transport_roundtrip_and_eof():
    """Loopback socket: frames flow both ways; closing the worker
    endpoint surfaces EOF as ``(wid, None)``."""
    server = tp.SocketTransport(1)
    args = server.worker_args(0)
    assert args[0] == "socket" and args[1][0] == "127.0.0.1"
    box = {}

    def worker():
        ep = tp.make_worker_endpoint(args)
        box["ep"] = ep
        ep.send(b"pong:" + ep.recv(timeout=5.0))

    th = threading.Thread(target=worker)
    th.start()
    server.after_start()
    server.send(0, b"ping")
    got = _poll_until(server)
    th.join(5.0)
    assert got and got[0] == (0, b"pong:ping")
    box["ep"].close()
    assert (0, None) in _poll_until(server)
    server.close()


def test_pipe_transport_roundtrip_in_process():
    server = tp.PipeTransport(1)
    kind, rfd, wfd = server.worker_args(0)
    assert kind == "pipe"
    ep = tp._PipeWorkerEndpoint(os.dup(rfd), os.dup(wfd))

    def worker():
        ep.send(b"echo:" + ep.recv(timeout=5.0))

    th = threading.Thread(target=worker)
    th.start()
    server.after_start()
    server.send(0, b"abc")
    got = _poll_until(server)
    th.join(5.0)
    assert got and got[0] == (0, b"echo:abc")
    ep.close()
    server.close()


def test_asyncio_transport_socket_roundtrip():
    t = tp.AsyncioTransport("socket", 1)

    def worker():
        ep = tp.make_worker_endpoint(t.worker_args(0))
        ep.send(b"echo:" + ep.recv(5.0))
        ep.close()

    th = threading.Thread(target=worker, daemon=True)
    th.start()

    async def main():
        q = await t.a_start()
        t.send(0, b"abc")
        await t.a_flush()
        first = await asyncio.wait_for(q.get(), 5.0)
        eof = await asyncio.wait_for(q.get(), 5.0)
        await t.a_close()
        return first, eof

    first, eof = asyncio.run(main())
    th.join(5.0)
    assert first == (0, b"echo:abc") and eof == (0, None)
    t.close()
    with pytest.raises(ValueError):
        tp.AsyncioTransport("carrier-pigeon", 1)


def test_make_server_transport_kinds():
    for kind, cls in (("pipe", tp.PipeTransport),
                      ("socket", tp.SocketTransport)):
        t = tp.make_server_transport(kind, 1)
        assert isinstance(t, cls) and t.name == kind
        t.close()


def test_data_plane_listener_and_peer_channel():
    """A listener answers framed requests on loopback; a dead listener
    surfaces as ``TransportClosed`` on the dialing side."""
    served = []

    def handler(frame: bytes) -> bytes:
        served.append(frame)
        return b"re:" + frame

    listener = tp.DataPlaneListener(handler)
    assert listener.addr[0] == "127.0.0.1"
    ch = tp.PeerChannel(listener.addr)
    assert ch.request(b"abc", timeout=5.0) == b"re:abc"
    assert ch.request(b"xyz", timeout=5.0) == b"re:xyz"
    assert served == [b"abc", b"xyz"]
    ch.close()
    listener.close()
    with pytest.raises(tp.TransportClosed):
        tp.PeerChannel(listener.addr, connect_timeout=0.5)


@pytest.mark.parametrize("wire_name", WIRES)
def test_fetch_over_the_data_plane_crosses_packages(wire_name):
    """A reference codec asks a port listener for values and decodes the
    port's reply: the data plane speaks one language."""
    store = {2: np.arange(3.0), 3: "three"}
    port = tmsg.make_wire(wire_name)

    def serve(frame: bytes) -> bytes:
        _, recs, _ = port.decode(frame)
        present = {int(t): store[int(t)] for t in recs if int(t) in store}
        absent = [int(t) for t in recs if int(t) not in store]
        (reply,) = port.encode_fetch_reply(present, absent)
        return reply

    listener = tp.DataPlaneListener(serve)
    ref = jmsg.make_wire(wire_name)
    ch = tp.PeerChannel(listener.addr)
    (req,) = ref.encode_fetch([2, 3, 9])
    op, absent, payload = ref.decode(ch.request(req, timeout=5.0))
    ch.close()
    listener.close()
    assert op == jmsg.OP_FETCH_REPLY and absent == [9]
    assert payload[3] == "three"
    np.testing.assert_array_equal(payload[2], store[2])
