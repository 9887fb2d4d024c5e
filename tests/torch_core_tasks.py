"""Task functions and the conformance hook shared by the tests of the
port's process runtime (``tests/test_torch_process_runtime.py``,
``test_torch_process_server.py``, ``test_torch_process_client.py``,
``test_torch_p2p.py``).

Task functions cross the wire by reference: a worker process unpickles
``torch_core_tasks._leaf`` and imports this module.  Under the spawn start
method (the port's default once torch is loaded) a worker that imported a
test module would import torch too, so the functions live here, in a
module that imports nothing but the standard library."""
import sys
import time


def _leaf(v):
    return v


def _agg(*vals):
    return sum(vals)


def _add(a, b):
    return a + b


def _sq(x):
    return x * x


def _plus1(x):
    return x + 1


def _maybe(v):
    return 0 if v is None else v


def _slow_plus(x):
    time.sleep(0.1)
    return x + 1


def _block(s):
    time.sleep(s)
    return s


def torch_state():
    """What a worker process knows of torch: ``"absent"`` when it never
    imported it, else whether CUDA was initialised there."""
    torch = sys.modules.get("torch")
    if torch is None:
        return "absent"
    return f"cuda_initialized={torch.cuda.is_initialized()}"


def fn_graph(pkg, n_leaves: int = 12):
    """``n_leaves`` leaves of ``i * i`` summed by one sink, as ``pkg``'s
    TaskGraph (``pkg``: ``repro.core`` or ``repro_torch.core``)."""
    tasks = [pkg.Task(i, (), fn=_leaf, args=(i * i,))
             for i in range(n_leaves)]
    tasks.append(pkg.Task(n_leaves, tuple(range(n_leaves)), fn=_agg))
    return pkg.TaskGraph(tasks, name="fn-agg")


def fn_graph_want(n_leaves: int = 12) -> dict:
    want = {i: i * i for i in range(n_leaves)}
    want[n_leaves] = sum(want.values())
    return want


def attach_conformance(monkeypatch) -> list:
    """Give every port ServerCore built without its own ``events=`` a bus
    with the reference's and the port's ``ConformanceSink``
    (``repro.analysis.trace``, ``repro_torch.analysis.trace``; the first
    is what ``tests/conftest.py`` does for ``repro.core``); returns the
    sinks, which :func:`assert_conforms` checks at teardown."""
    from repro.analysis.trace import ConformanceSink
    from repro_torch.analysis.trace import ConformanceSink as PortSink
    from repro_torch.core.events import EventBus
    from repro_torch.core.server import ServerCore

    sinks = []
    orig_init = ServerCore.__init__

    def patched(self, *args, **kw):
        if not kw.get("events"):
            bus = EventBus()
            for cls in (ConformanceSink, PortSink):
                sink = cls(path="<repro_torch.core>")
                bus.add_sink(sink)
                sinks.append(sink)
            kw["events"] = bus
        orig_init(self, *args, **kw)

    monkeypatch.setattr(ServerCore, "__init__", patched)
    return sinks


def assert_conforms(sinks) -> None:
    problems = [f for s in sinks for f in s.findings]
    assert not problems, [f"{f.key} @ {f.where}: {f.message}"
                          for f in problems[:20]]
    assert sum(s.n_internal_errors for s in sinks) == 0
