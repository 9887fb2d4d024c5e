"""Batched serving engine: continuous batching over the model's
prefill/decode paths (counterpart of :mod:`repro.serve.engine`).

Requests enter a queue; the engine admits them into free cache slots
(prompt prefill, right-padded to bucket sizes for attention archs, at the
exact length for recurrent ones), then runs one batched decode step over
all ``max_batch`` slots per iteration.  Slots free as requests finish and
new requests are admitted immediately.

The compute itself rides the persistent Cluster/Client futures API: the
engine owns one warm single-executor :class:`repro_torch.core.client.
Cluster` and submits every prefill and batched decode step to it, so
back-to-back steps (and back-to-back requests) reuse the warm pool.  The
pool is byte-bounded (``memory_limit``), and with ``events=`` the engine
publishes per-request ``request-enter``/``request-admit``/``request-exit``
events, keyed by a caller-supplied ``tenant``, into the same structured
feed the runtime's control-plane events ride
(:mod:`repro_torch.core.events`); ``tracing=True`` adds the worker-side
stamps that the pool's ``trace_analysis()`` splits into segments.

Above the runtime the engine records its own spans
(:class:`repro_torch.core.tracing.Spans`, recorder ``"serve"``, on
unless ``spans=False``): on the loop thread ``serve.step`` (a step that
found work), ``serve.admit`` (one admitted request), ``serve.call`` (one
runtime call, submit to released result) and ``serve.readback``; the
loop is idle in the gaps between steps.  On the pool's thread
``serve.task`` (the task function, a child of its call), ``serve.h2d``
(host inputs to the device) and ``serve.model`` (the model's enqueue).
With ``events=`` the spans ride the same bus.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core.client import Cluster
from repro_torch.core.tracing import Spans
from repro_torch.device import resolve
from repro_torch.models import model as model_lib
from repro_torch.models.common import tree_map
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 16
    eos_id: int = -1              # -1: run to max_new_tokens
    out_tokens: list = dataclasses.field(default_factory=list)
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    submit_t: float = 0.0
    admit_t: float = 0.0          # admission (its prefill) began
    first_token_t: float = 0.0    # its first token was appended
    finish_t: float = 0.0
    tenant: str = "default"       # event-stream key (multi-tenant views)


def _bucket(n: int, buckets=(16, 32, 64, 128, 256, 512, 1024)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + 1023) // 1024) * 1024


def prefill_length(cfg: ModelConfig, n: int, max_len: int) -> int:
    """Tokens the engine prefills for ``n`` prompt tokens.  Recurrent
    state must not see padding, so recurrent archs take the exact length;
    attention caches mask by length, so bucketed right-padding is safe."""
    recurrent = cfg.mamba is not None or cfg.xlstm is not None
    return n if recurrent else min(_bucket(n), max_len)


#: default byte bound on the serving pool's object store.  Engine
#: results are transient (every future is released after one read), and
#: a tensor counts as its small host object (``core.store.sizeof``), so
#: the bound never spills in practice.
DEFAULT_MEMORY_LIMIT = 256 * 2**20


def _task(fn, spans, kind: str):
    """``fn`` as a task of the engine's pool, called with the id of the
    ``serve.call`` span that submitted it first: it runs under a
    ``serve.task`` span of that parent.  It enters inference mode
    itself: the mode is thread-local, and the task runs on the pool's
    worker thread.  It returns an exception instead of raising it, since
    the runtime's worker loop has no handler (a raise would end the
    worker thread and leave ``_call`` waiting out its timeout);
    ``_call`` raises it on the loop thread."""
    def task(call_sid, *args):
        try:
            with spans.span("serve.task", parent=call_sid, kind=kind), \
                    torch.inference_mode():
                return fn(*args)
        except Exception as e:
            return e
    return task


class ServingEngine:
    """Serves ``cfg`` with ``params`` (a port param tree on ``device``).

    ``device`` defaults to the CUDA card and raises if there is none.
    If the loop thread fails, every waiting request is released and
    :meth:`stop` re-raises the error.  A multi-codebook config (musicgen)
    is refused: requests carry one token stream, as in the JAX engine,
    which cannot serve one either; such a model is served through
    ``prefill`` and ``decode_step`` directly.  So is an image-embedding
    (VLM) config, as the JAX engine refuses it: requests carry no image.
    MoE configs are served as they are: the padding of a prefill routes
    through the experts, and the requests of one decode step compete for
    the experts' capacity, as in the JAX engine.
    """

    def __init__(self, cfg: ModelConfig, params: Any, *, max_batch: int = 8,
                 max_len: int = 256,
                 memory_limit: int | None = DEFAULT_MEMORY_LIMIT,
                 events=None, tracing: bool = False, spans: bool = True,
                 device: torch.device | str | None = None):
        if cfg.num_codebooks:
            raise NotImplementedError(
                f"{cfg.name}: the engine serves one token stream a request, "
                f"not {cfg.num_codebooks} codebooks")
        if cfg.vision_dim:
            raise NotImplementedError(
                f"{cfg.name}: the engine's requests carry no image "
                f"embeddings")
        self.cfg = cfg
        self.params = params
        self.device = resolve(device)
        self.max_batch = max_batch
        self.max_len = max_len
        self.cache = model_lib.init_cache(cfg, max_batch, max_len,
                                          device=self.device)
        self.pos = np.zeros(max_batch, dtype=np.int32)    # next position
        self._next_in = np.zeros(max_batch, dtype=np.int32)
        self.active: list[Request | None] = [None] * max_batch
        self.inbox: queue.Queue = queue.Queue()
        self.n_decode_steps = 0
        self.n_prefills = 0
        self.n_generated = 0
        self.error: BaseException | None = None
        self._stop = threading.Event()
        self._rid = 0

        # The pool's graph keeps a task's args until compaction, so the
        # args are host arrays and long-lived trees: the token and
        # position tensors, and a prefill's one-slot cache, are made on
        # the card inside the task and freed with its released result.
        def prefill_fn(params, tokens):
            with self.spans.span("serve.h2d"):
                tokens = torch.from_numpy(tokens).to(self.device)
            with self.spans.span("serve.model"):
                cache = model_lib.init_cache(cfg, 1, max_len,
                                             device=self.device)
                return model_lib.prefill(params, cfg, tokens, cache)

        def decode_fn(params, tokens, cache, pos):
            with self.spans.span("serve.h2d"):
                tokens = torch.from_numpy(tokens).to(self.device)
                pos = torch.from_numpy(pos).to(self.device)
            with self.spans.span("serve.model"):
                logits, cache = model_lib.decode_step(params, cfg, tokens,
                                                      cache, pos)
                # greedy on the logits' own dtype; first index on ties
                return torch.argmax(logits[:, 0], dim=-1), cache

        # warm single-executor pool: every prefill/decode is a client
        # submission, reused across steps and requests
        self._cluster = Cluster(server="rsds", scheduler="ws",
                                n_workers=1, runtime="thread",
                                name="serving", memory_limit=memory_limit,
                                events=events, tracing=tracing)
        self.spans = Spans("serve", enabled=spans, bus=self._cluster.events)
        self._prefill = _task(prefill_fn, self.spans, "prefill")
        self._decode = _task(decode_fn, self.spans, "decode")
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-loop")

    @property
    def events(self):
        """The engine's event bus (None unless built with ``events=``)."""
        return self._cluster.events

    @property
    def runtime(self):
        """The pool's server (:class:`repro_torch.core.server.ServerCore`):
        its epochs, meters and ``run_stats()``."""
        return self._cluster.runtime

    def observe(self) -> dict:
        """Live snapshot of the pool serving this engine (see
        :meth:`repro_torch.core.server.ServerCore.observe`), with the
        engine's span totals (:meth:`Spans.totals`) under ``"spans"``."""
        snap = self._cluster.observe()
        snap["spans"] = self.spans.totals()
        return snap

    def trace_analysis(self):
        """The pool's runtime trace (:meth:`Cluster.trace_analysis`;
        needs ``events=``, and ``tracing=True`` for worker segments)."""
        return self._cluster.trace_analysis()

    def _call(self, fn, *args, kind: str, rid: int | None = None):
        """Run one compute on the warm pool and free its key, under a
        ``serve.call`` span; raise here an exception the task
        returned."""
        with self.spans.span("serve.call", kind=kind, rid=rid) as sp:
            fut = self._cluster.client.submit(fn, sp.sid, *args)
            out = fut.result(timeout=300.0)
            fut.release()
        if isinstance(out, Exception):
            raise out
        return out

    # ------------------------------------------------------------------
    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self.spans.close()
        self._thread.join(timeout=10)
        self._cluster.close()
        if self.error is not None:
            raise RuntimeError("serving loop failed") from self.error

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               eos_id: int = -1, tenant: str = "default") -> Request:
        self._rid += 1
        req = Request(self._rid, np.asarray(prompt, np.int32),
                      max_new_tokens, eos_id,
                      submit_t=time.perf_counter(), tenant=tenant)
        ev = self._cluster.events
        if ev is not None:
            ev.publish("request-enter", rid=req.rid, tenant=tenant)
        self.inbox.put(req)
        return req

    # ------------------------------------------------------------------
    def _admit(self) -> None:
        for slot in range(self.max_batch):
            if self.active[slot] is not None:
                continue
            try:
                req = self.inbox.get_nowait()
            except queue.Empty:
                return
            req.admit_t = time.perf_counter()
            with self.spans.span("serve.admit", rid=req.rid,
                                 wait_s=req.admit_t - req.submit_t):
                self._admit_one(req, slot)

    def _admit_one(self, req: Request, slot: int) -> None:
        # prefill prompt[:-1]; the last prompt token goes through the
        # normal decode path, yielding the first generated token with a
        # correctly positioned cache write.
        s = len(req.prompt)
        if s > 1:
            n = prefill_length(self.cfg, s - 1, self.max_len)
            toks = np.zeros((1, n), np.int32)
            toks[0, :s - 1] = req.prompt[:-1]  # right-pad
            _, one_cache = self._call(self._prefill, self.params, toks,
                                      kind="prefill", rid=req.rid)
            self.n_prefills += 1
            # in place, where the JAX engine does .at[:, slot].set
            tree_map(lambda g, p: g[:, slot].copy_(p[:, 0]),
                     self.cache, one_cache)
        self.pos[slot] = s - 1
        self._next_in[slot] = int(req.prompt[-1])
        self.active[slot] = req
        ev = self._cluster.events
        if ev is not None:
            ev.publish("request-admit", rid=req.rid, tenant=req.tenant,
                       slot=slot)

    def _step(self, sp) -> bool:
        """Admit, then one batched decode step under the open
        ``serve.step`` span ``sp``; False when idle.  Runs under the loop
        thread's inference mode."""
        self._admit()
        live = [i for i, r in enumerate(self.active) if r is not None]
        if not live:
            return False
        sp.set(live=len(live))
        tokens = np.zeros((self.max_batch, 1), np.int32)
        for i in live:
            tokens[i, 0] = self._next_in[i]
        nxt, self.cache = self._call(self._decode, self.params, tokens,
                                     self.cache, self.pos.copy(),
                                     kind="decode")
        with self.spans.span("serve.readback"):
            nxt = nxt.cpu().numpy()
        self.n_decode_steps += 1
        for i in live:
            req = self.active[i]
            self.pos[i] += 1
            req.out_tokens.append(int(nxt[i]))
            if len(req.out_tokens) == 1:
                req.first_token_t = time.perf_counter()
            self._next_in[i] = int(nxt[i])
            self.n_generated += 1
            done = (len(req.out_tokens) >= req.max_new_tokens
                    or int(nxt[i]) == req.eos_id
                    or self.pos[i] >= self.max_len - 1)
            if done:
                req.finish_t = time.perf_counter()
                ev = self._cluster.events
                if ev is not None:
                    ev.publish("request-exit", rid=req.rid,
                               tenant=req.tenant,
                               n_tokens=len(req.out_tokens),
                               latency_s=req.finish_t - req.submit_t)
                req.done.set()
                self.active[i] = None
        return True

    def _loop(self) -> None:
        try:
            # the loop's own tensor work (inputs, slot copies, the tokens'
            # read-back); each task enters the mode on the pool's thread
            with torch.inference_mode():
                while not self._stop.is_set():
                    # work is found iff a slot is live or a request waits
                    # (only this thread empties the inbox or a slot)
                    if not any(self.active) and self.inbox.empty():
                        time.sleep(0.002)
                        continue
                    with self.spans.span("serve.step") as sp:
                        self._step(sp)
        except Exception as e:  # the loop's boundary: keep it for stop()
            self.error = e
            for r in self.active:
                if r is not None:
                    r.done.set()
            while not self.inbox.empty():
                self.inbox.get_nowait().done.set()
