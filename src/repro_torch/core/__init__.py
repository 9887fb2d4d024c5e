"""The task-graph runtime of :mod:`repro.core`, copied into the port:
reactor/scheduler separation, Dask-style vs RSDS-style server
implementations and the real-time engine with thread workers in-process.
The port imports nothing of ``repro``, so it keeps its own copy.

Copied: what ``runtime="thread"`` needs, and the tracing module
(:mod:`repro_torch.core.tracing`: per-task spans, the six-segment
overhead attribution, reconciliation; ``Cluster.trace_analysis()``).  Not
copied: the process runtime (``ProcessRuntime``, the wire transports and
their drivers; here ``Cluster(runtime="process")`` raises
``NotImplementedError``), the virtual-time simulator and the benchmark
graphs."""
from repro_torch.core.array_reactor import ArrayReactor
from repro_torch.core.client import Client, Cluster, Future, GraphFutures
from repro_torch.core.events import (EventBus, JsonlEventLog, load_jsonl,
                                     make_bus, replay)
from repro_torch.core.graph import GraphBuilder, Task, TaskGraph
from repro_torch.core.reactor import ObjectReactor
from repro_torch.core.runtime import RunResult, ThreadRuntime, run_graph
from repro_torch.core.server import Driver, EpochStats, ServerCore
from repro_torch.core.schedulers import (DaskWorkStealing, HeftScheduler,
                                         RandomScheduler, RsdsWorkStealing,
                                         make_scheduler)
from repro_torch.core.store import ObjectStore
from repro_torch.core.transport import InprocTransport
