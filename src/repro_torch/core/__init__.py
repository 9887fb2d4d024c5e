"""The task-graph runtime of :mod:`repro.core`, copied into the port whole:
reactor/scheduler separation, Dask-style vs RSDS-style server
implementations, zero-worker overhead isolation, virtual-time cluster
simulation and real-time engines (thread workers in-process, or
OS-process workers behind a pluggable byte transport, with the Dask and
static wire codecs and the worker-to-worker data plane).  The port
imports nothing of ``repro``, so it keeps its own copy; the modules here
import numpy, msgpack and the standard library only, never torch, so a
spawned worker process starts without it."""
from repro_torch.core.array_reactor import ArrayReactor
from repro_torch.core.client import Client, Cluster, Future, GraphFutures
from repro_torch.core.events import (EventBus, JsonlEventLog, load_jsonl,
                                     make_bus, replay)
from repro_torch.core.graph import GraphBuilder, Task, TaskGraph
from repro_torch.core.reactor import ObjectReactor
from repro_torch.core.runtime import ProcessRuntime, RunResult, \
    ThreadRuntime, run_graph
from repro_torch.core.server import Driver, EpochStats, ServerCore
from repro_torch.core.schedulers import (DaskWorkStealing, HeftScheduler,
                                         RandomScheduler, RsdsWorkStealing,
                                         make_scheduler)
from repro_torch.core.simulator import SimConfig, Simulator, simulate
from repro_torch.core.store import ObjectStore
from repro_torch.core.transport import (InprocTransport, PipeTransport,
                                        SocketTransport)
