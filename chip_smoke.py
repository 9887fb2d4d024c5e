#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --rmsnorm-times [--root DIR]
    python3 chip_smoke.py --ssd-times [--root DIR]
    python3 chip_smoke.py --flash-bwd-times [--root DIR]
    python3 chip_smoke.py --serving-runtime [--root DIR]
    python3 chip_smoke.py --parity-sweep
    python3 chip_smoke.py --logits-gap
    python3 chip_smoke.py --xlstm-depth
    python3 chip_smoke.py --process-runtime
    python3 chip_smoke.py --sharded

The second form only times the rmsnorm kernels of the checkout at DIR
(default: this one) at the slices' widths over a sweep of row counts
(``rmsnorm_times``); the third only times DIR's SSD forward and backward
at zamba2's training and serving shapes, the backward split by kernel
(``ssd_times``); the fourth only times DIR's bf16 flash backward at
the training cells' shapes (``flash_bwd_times``); the fifth only serves
llama3.2-1b's 16 requests through DIR's engine and prints the runtime's
cost a call (``serving_runtime``).  Run on two checkouts in turns
(parent, change, change, parent) in one call, any of the four compares
them on one card.  The sixth only measures how far zamba2's bf16
gradients move when one op runs its plain version, and how far each
route lies from fp32 (``parity_sweep``).  The seventh only measures
gemma2-27b's kernel-vs-plain logits gap at full width by depth (4 to 46
layers), with its softcaps on and off, and at full depth with one op at
a time on its plain version (``logits_gap``).  The eighth only trains xlstm-350m as the training
slice does at its published widths with one and with all three of its
(7 mLSTM + 1 sLSTM) repeats, and prints how far each depth's loss falls
(``xlstm_depth``).  The ninth only builds the kernels, timed by library,
and runs phase 1b (``run_process_runtime``), its pools' event streams
checked live as in phase 1c (c).  The tenth only builds the kernels and
runs phase 5 (``run_sharded``).  The first form:

1. Environment: TF32 off, the card's name and power limit, the kernels
   built with nvcc from ``src/repro_torch/kernels/csrc`` into
   ``build/kernels/`` (timed), the registers and spills of the main
   instantiations (the flash forward and backward at head dim 256 in bf16
   and fp32, decode at (256, G), (128, 7) and (128, 6)), and the count of
   HGMMA
   (tensor-core)
   instructions in each bf16 flash and SSD kernel's SASS (the SSD
   backward's too).  Decode builds as 11 units at once
   (``kernels/build.py::UNITS``); each library's seconds are printed.
1b. The paper's runtime on the card's host (``run_process_runtime``):
   ``repro_torch.core``'s process runtime, whose workers are spawned by
   this process while it holds a CUDA context.  (a) It resolves to spawn
   and runs a ``pipe`` request on ``socket``; no worker initialises CUDA
   (``rt_torch_state``; a worker imports this script as ``__mp_main__``,
   whose top level then imports no torch and does no work but imports
   and constants).  (b) ``benchgraphs.suite(scale=0.05)`` and the value
   graphs ``value_reduction`` and ``array_reduction``, each an epoch of a
   warm Cluster of ``RT_PARITY_WORKERS``, on the thread runtime and on
   process workers under both servers with the selector and asyncio
   drivers, p2p on, and the relay (p2p off) once a server: equal result
   sets and task counts, equal values for the value graphs; no relay byte
   with p2p on.  (c) ``kill_worker_after`` SIGKILLs a worker mid-graph:
   the same values.  (d) The zero-worker measurement at its published
   size (``merge(10000)`` and ``merge(25000)``, the suite's first two
   graphs at scale 1.0) on min(8, cores) workers, both servers, batching
   on and off: makespan, the server's time a task, wire bytes and frames
   a task, frames sent and coalesced; with batching off the Dask wire
   must move 2 or more frames a task and the static wire fewer.  The
   Dask wire's per-frame merge(25000) is waited for 3 s and reported as
   far as it got (``RT_PER_FRAME_WAIT_S``: the host's loopback TCP takes
   ~170 s over it).  (e) The simulator: ws against random over
   ``suite(scale=0.1)``, rsds against dask at ``merge(8000)`` on 168
   workers; the ratios are printed, not checked.  Each pool's start (to
   its first task's end), each part's seconds and the phase's are printed
   beside its budget (``RT_BUDGET_S``); pools close on threads of their
   own while the next runs, and the phase ends when all have closed.
1c. The invariant checker (``repro_torch.analysis``), held to the repo's
   ``docs/`` as the JAX package's copy is.  (a) The static rules RA1-RA8
   over this checkout (``Conformance.static_and_explore``): 0 findings, and the
   suppressed count equal to the allowlist's matches.  (b) The explorer:
   ``explore_sim`` on the port's simulator under both servers at
   tests/test_protocol.py's parameters (``merge(12)``, 3 workers, 20
   distinct interleavings) and once with a worker failure
   (``EXPLORE_SIM``), then ``explore_inproc`` on the thread runtime, 3
   schedules a server; no run may violate the protocol.  (c) Live sinks
   (``Conformance.attach``: a ``ConformanceSink`` on an event bus, the
   stream whole from ``stream-open``, fed in order by a thread of its own
   off the publishing thread, ``_TimedSink``): every pool of phase 1b's (b)
   and (c) (both servers, the selector and asyncio drivers, p2p on and
   off, the SIGKILLed worker), llama3.2-1b's engine in phase 3, and each
   coordinator's step with executor 2 failed (its pool with events on; one
   ``worker-lost``); none on (d)'s zero-worker pools, whose server time
   it would change.  Each stream prints its events checked and findings
   where its run ends; a finding fails the run.  (d) The llama engine's
   stream, written as JSONL, through ``python -m repro_torch.analysis
   --trace`` in a subprocess: exit 0 (``Conformance.offline``).  The llama
   engine's runtime cost a call is measured again without and with the
   sink, in turns (``sink_cost``), beside the runs' spread.  Phase 4
   ends with the summary: every stream again, and the phase's seconds,
   (a) + (b) + (d) + every sink's time, beside its budget
   (``CONFORMANCE_BUDGET_S``).
2. Each CUDA kernel against its plain PyTorch version on the card, on the
   JAX suite's sweep shapes and the slices' shapes: flash and decode
   attention at head dims 32, 64, 80, 128 and 256 and at G = 7 and 6
   (grok-1's 48/8 heads, with and without its softcap 30), flash also
   non-causal at S = 1 and S = 512 queries against T = 2048 keys
   (cross-attention) (fp32 2e-5, bf16 2e-2; the dense family's and
   grok-1's prefills and decode steps as its layers
   call them, gemma2's window of 4096 at a 4608-token prefill and over
   8192 cached positions with lengths below, at and past it), the
   Mamba-2 SSD scan with ragged S and a split at h0 (fp32 2e-4, bf16 2e-2,
   and in bf16 y and h_final within rel. L2 ``SSD_REL_L2_BF16``), RMSNorm
   forward (fp32 2e-5, bf16 2e-2; the same y bits without rstd) and
   backward (fp32 1e-4, bf16 2e-2; bit-equal twice) at the sweep shapes
   and at every call's shape (decode steps, prefills, the training step),
   the flash forward's log-sum-exp (fp32 2e-5, bf16 2e-2) and the flash
   backward (fp32 1e-4, bf16 5e-2; also at head dim 256, G 6 with cap 30,
   G 7, a 4096 window at S = 8192 and non-causal S = T = 2048, in both
   dtypes, and at the wide training cells' shapes in bf16).  Decode, SSD
   and the flash backward run twice and must be bit-equal; decode must be
   free of NaN, also with lengths at and around a split boundary and a
   window that empties whole splits.  Both flash wrappers must refuse a
   query row with no live key; decode must refuse head dim 256 with G =
   16 (not built).  The SSD backward
   against its plain version (the exact reverse recurrence) on the
   sweep, at zamba2's widths with and without h0, a ragged S and the
   training shape (4, 2048, 80, 64, 64): twice bit-equal, every output
   within rel. L2 ``SSD_BWD_REL_L2_BF16`` (bf16) or 1e-5 (fp32).  The
   zamba2 training step's shapes too: the SSD forward at the training
   shape, the flash backward at (4, 2048, 32, 32, 80) and rmsnorm at
   (8192, 2560) and (8192, 5120); and the zamba2 coordinator's
   microbatch: the SSD forward and backward at (1, 2048, 80, 64, 64) and
   flash forward and backward at (1, 2048, 32, 32, 80).  musicgen-medium's
   attention (24/24 heads at head dim 64, G = 1): flash at its batched
   8 x 512-frame prefill and forward and backward at its training shape
   (4, 2048), decode over (8, 1024); rmsnorm at xlstm-350m's widths (1024,
   and 2048 in the mLSTM) and musicgen's (1536) at a decode step's,
   a prefill's and the training step's rows; llama-3.2-vision's batched
   8 x 512 self-attention prefill, decode over (8, 1024) at G = 8, and
   its cross-attention flash (8, 512 or 1, 64, 8, 128) against 2048
   image tokens; rmsnorm at grok-1's 6144, deepseek-v3's 7168, 1536 and
   512, and the VLM's 8192 and 128 (cross-attention's q_norm and k_norm
   at their rows).
3. The serving slices, each at its published width in bf16 with random
   weights from a seeded generator, served through ``ServingEngine`` on
   its warm ``repro_torch.core`` Cluster with events on (16 requests in two
   tenants, prompt lengths uniform in 32-512, 8 slots, 1024 positions, 32
   new tokens each):
   * llama3.2-1b (flash and decode attention, head dim 64);
   * zamba2-2.7b (45 mamba2 layers through the SSD kernel, 9 repeats of a
     weight-shared attention slot through flash and decode attention at
     head dim 80);
   * gemma2-27b at its published width and depth (46 layers, post-norms,
     a 4096 window on every other layer, softcaps 50 and 30, scale 1/12),
     then its long-context check: 4 layers at full width, a 4608-token
     prompt into an 8192-position cache and one decode step, kernel path
     against plain path;
   * gemma-7b (28 layers, head dim 256);
   * deepseek-coder-33b at its published width, 16 of its 62 layers
     (56/8 heads, G = 7);
   * xlstm-350m (21 mLSTM and 3 sLSTM layers in plain torch, 476,597,248
     params: its norms on the rmsnorm kernel at 1024 and 2048; the
     memory check's flood is ``FLOOD[arch]`` requests).
   Then musicgen-medium (48 layers, 4 codebooks, 1,384,269,312 params),
   which the engine refuses as the JAX engine does, through ``prefill`` and
   ``decode_step`` themselves: 8 prompts of 512 frames x 4 codebooks
   prefilled as one batch into 1024 positions, 32 greedy decode steps
   (argmax per codebook); exact flash, decode and rmsnorm launches;
   kernel-path logits against the plain path; the first and last
   sequence generated alone (row 0 of the batch, the other rows zero)
   equal to the batched run; the same profile.
   Then the MoE, MLA and vision families, each at its published width
   and ``param_count()`` asserted against the JAX package's:
   * grok-1-314b at 4 of 64 layers (21.29e9 params; softmax top-2 over 8
     experts, flash and decode at G = 6 with softcap 30) and
     deepseek-v3-671b at 1 of 3 dense + 2 of 58 MoE layers (25.45e9
     params; MLA in plain torch, naive as the engine runs it; sigmoid
     top-8 over 256 experts + 1 shared, the router bias set nonzero from
     the seed), served as above with each engine call's ``moe_dropped``
     reported.  Kernel-vs-plain logits are checked in bf16, with the
     share of router choices that differ and the gap with the kernel
     path's choices pinned to the plain path's; deepseek-v3's
     absorbed-vs-naive MLA is checked in fp32 on a model of
     ``ABSORBED_CUT`` layers made first (``absorbed_parity``: in bf16
     the choices that flip carry the gap past the limit), its bf16
     figures reported.  A decode step's requests share the experts'
     capacity, so the token check is a one-slot engine against
     a one-row reference (equal), and how many of the 8-slot run's 16
     requests equal their one-slot generation is reported, not checked;
   * llama-3.2-vision-90b at 2 of 20 repeats (4 self + 1 cross) = 10 of
     100 layers (10.66e9 params), which the engine refuses as the JAX
     engine does, through ``prefill``/``decode_step`` (``run_vision_slice``):
     8 prompts of 512 tokens with image embeddings (8, 2048, 7680) from
     the seed, the gates set nonzero, 32 greedy steps; exact flash (self-
     and cross-attention), decode and rmsnorm launches; the first and last
     sequences alone equal to the batched run; kernel-path logits against
     the plain path; other image embeddings must move the prefill logits
     by at least ``IMAGE_MOVE_OF`` times LOGITS_REL_TOL.
   Every RMSNorm of every run goes through the rmsnorm kernel.  For each: the
   widths are asserted; every request finishes; every prefill and decode
   step went through its kernels (launch counters set to 0 just before the
   engine run and read just after); one runtime epoch a prefill or decode
   step, no spill, and 16 each of the request-enter/-admit/-exit events;
   the runtime's cost a call (the wall time of the engine's ``_call``
   minus its task function's, median and p95, by prefill and decode step)
   and ``EpochStats.server_busy``; two requests' tokens equal a
   one-request greedy generation through ``prefill``/``decode_step``;
   kernel-path logits agree with the plain path; a profile of one decode
   step and one 512-token prefill.
   Then the training slice: llama3.2-1b at its published width through
   ``Trainer`` (AdamW, remat "full", 8 steps of 4 x 2048 tokens on a fixed
   batch): the loss falls; every step launched the flash forward and
   backward and the rmsnorm forward and backward kernels the asserted
   number of times; forward_loss gradients through the kernels agree with
   the plain path at full width; 3 steps + checkpoint + restore + 3 steps
   equal 6 straight steps (2 layers of the full width, deterministic
   algorithms); step time, tokens/s, MFU and a profile of one step.
   Then zamba2-2.7b trained the same way at its published width (1.98e9
   params; the SSD forward and backward kernels, flash at hd 80, rmsnorm
   at 2560 and 5120): the loss falls 0.5 nat; gradient parity, in fp32,
   with the SSD also on its plain version; exact launch counts (a step: 90 SSD
   forward, 45 backward, 18 + 9 flash, 217 + 109 rmsnorm); peak memory;
   a profile of one step.  Then the optimized llama config (fused QKV and
   gate/up): prefill and decode logits against the unfused model on the
   concatenated weights within ``FUSED_REL_L2``, and 8 training steps.
   Then remat "dots" against "full" and "none" at 4 x 2048 (step-1
   gradients of "dots" against "full"; launches, peak memory and step
   time of each), and Adafactor and Lion (8 steps each: the loss falls,
   Adafactor's state is factored; state bytes and step time beside
   AdamW's).
   Then the coordinator slices: llama3.2-1b, and after zamba2's training
   zamba2-2.7b, at the published width through ``MicrobatchCoordinator``
   (the same AdamW settings; global batch 4 x 2048 in 4 microbatches of
   1 x 2048, 4 executors, rsds_ws, 2 steps, deterministic algorithms):
   the loss is finite and falls; every kernel's launches (flash and
   rmsnorm; zamba2's SSD forward and backward too) are the microbatch's
   count times 4 a step; the params after step 1 are bit-equal across 4
   executors, 1 executor and 4 executors with executor 2 failed mid-step
   (5 microbatch functions started), and within 5e-3 (abs and rel) of one
   full-batch ``make_train_step`` step; live tensor bytes equal after
   each step; each step's wall time, makespan and ``server_busy`` beside
   its microbatch functions' walls.  Then xlstm-350m (at 8 of its 24
   layers, ``TRAIN_CUT``) and musicgen-medium
   trained as llama (8 ``Trainer`` steps of 4 x 2048, AdamW, each
   config's own remat "dots"; gradient parity in ``PARITY_DTYPE``, for
   xlstm in fp32 with bf16's reported; the loss must fall, by
   ``LOSS_MARGIN_OF``, and stay above an unseen batch's, by
   ``HELD_OUT_SHARE_OF``; exact launches; peak memory, step time,
   tokens/s, MFU from ``param_count()``; a profile of one step; for
   xLSTM the sLSTM scan's share of the step, timed alone).  Then the
   families that serve at full width train the same way at a depth cut
   (``WIDE_TRAIN``: whole repeats of each pattern, every width as
   published, params on the card equal to ``param_count()``; remat
   "full"): gemma-7b at 8 layers (head dim 256 through the flash
   backward), gemma2-27b at 2 (a local and a global layer) on 1 x 8192
   tokens, where the 4096 window masks, deepseek-coder-33b at 4 (G 7),
   grok-1-314b at 1 (Adafactor, updated in slices of its stacked leaves;
   G 6 with cap 30; the MoE backward under deterministic algorithms) and
   llama-3.2-vision-90b at 5 (4 self + 1 cross; Adafactor; 2048 image
   tokens of 7680 a sequence, so its cross layer runs the non-causal flash
   backward): gradient parity in bf16 (grok's with the kernel path's
   router choices pinned to the plain path's, the unpinned figures
   printed; the VLM's with its gates opened), the loss falls 0.5 nat and
   an unseen batch's stays 0.5 above, exact launches (the flash backward
   by mask: local and global, self and cross), step time, MFU (N =
   ``active_param_count()`` for grok), peak memory and a profile.
   The runtime's trace (``repro_torch.core.tracing``): the llama engine's
   Cluster and both coordinators' run with ``tracing`` on; each prints
   the six segments of every call's span (median and p95 in us, by kind
   of call: prefill and decode step; microbatch and reduce) and
   ``format_attribution``, and every ``reconcile()`` check must pass.
4. Numbers: per kernel and slice, its time beside the plain version's, the
   PyTorch library call's (where one computes the same function: SDPA,
   or for a softcapped row, which SDPA cannot take, a compiled
   ``flex_attention`` with the tanh cap as its score_mod, its error
   against the plain version given beside it; for the flash backward
   their autograd backward) and the card's bound; the decode rows also
   give the host's n_split, and the
   rmsnorm rows the call that launches them (a decode step, a prefill, a
   training step or a coordinator's microbatch, or the VLM's
   cross-attention norms), its norms per call at
   that width, its launches at that
   call and width as the wrapper counted them by (rows, d) in phase 3
   (asserted equal to the norms per call times the calls) and the launch
   shape (``kernels/rmsnorm.py::launch_shape``).  Then the wall seconds of
   each phase, and of each slice of phase 3.
5. Sharding (``run_sharded``; it runs before phase 4's numbers, so that
   their launch counts stay phase 3's), two spawned children at once
   against its ``SHARDED_BUDGET_S``: (a) a 1-rank NCCL group and a (1, 1)
   ``("data", "model")`` mesh on the card, and llama3.2-1b's training
   step (4 x 2048, 16 layers, AdamW, deterministic algorithms), its
   prefill of 4 x 512 tokens and 8 greedy decode steps, and zamba2-2.7b's
   prefill at 12 layers, each with DTensor params (``parallel.sharding``)
   inside ``logical_rules`` and unsharded on the same params and inputs:
   the loss and every leaf within ``SHARDED_REL_L2``, the same greedy
   tokens, and the same launches of every kernel wrapper in both runs,
   so the DTensor route (``kernels/sharded.py``) reached the hand-written
   kernels; (b) the dry-run's cells of ``SHARDED_DRYRUN`` on meta tensors
   over the fake 256- or 512-rank mesh (device type cuda) on the card's
   host: each record's status, per-device argument and saved bytes,
   FLOPs, wire bytes by collective, roofline terms and bottleneck.

Any failed check raises, so the script exits non-zero.  It prints no
result, and fails, without a CUDA card or outside a checkout of the repo.
The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path
from unittest import mock

import numpy as np

if __name__ != "__mp_main__":
    # a worker of the process runtime (run_process_runtime) imports this
    # script under that name; it needs no torch, whose import takes ~9 s
    # a process on the card's host
    import torch

ROOT = Path(__file__).resolve().parent

TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # rtol = atol, tests/test_kernels.py
SSD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}  # SSD sweeps, same file
LOGITS_REL_TOL = 5e-2  # rel. L2, kernel vs plain path, bf16 models
PEAK_FLOPS = 989e12    # H100 SXM dense bf16, tensor cores
PEAK_BYTES = 3.35e12   # H100 SXM HBM3
SSD_CHUNK = 64         # the SSD kernel's chunk length (csrc/mamba_chunk_scan.cu)
# backward kernels against their plain versions: sums in another order
# (fp32); in bf16 the plain flash backward rounds q.k to bf16 before the
# softmax, as the plain forward does, and the kernel rounds P and dS to
# bf16 as tensor-core operands
RMS_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
FLASH_BWD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
RMS_SWEEP = [(4, 37, 256), (2, 128), (1, 8, 8, 512)]  # tests/test_kernels.py

FLASH_SWEEP = [  # (b, s, h, kv, hd, causal, window, cap): tests/test_kernels.py
    (2, 256, 4, 2, 64, True, None, None),
    (1, 256, 8, 8, 128, True, None, 50.0),
    (2, 512, 4, 1, 64, True, 128, None),
    (1, 128, 4, 4, 32, False, None, None),
    (1, 384, 6, 2, 64, True, 256, 30.0),
    (2, 200, 4, 2, 80, True, 64, 30.0),     # head dim 80 (zamba2)
]
# head dim 256 (gemma-7b) without and with a window and softcap, and G = 7
# (deepseek-coder-33b's 56/8 heads); the rest of the sweep at hd 256 is
# tests/test_torch_cuda.py's
FLASH_SWEEP_DENSE = [(*FLASH_SWEEP[0][:4], 256, *FLASH_SWEEP[0][5:]),
                     (*FLASH_SWEEP[4][:4], 256, *FLASH_SWEEP[4][5:]),
                     (1, 300, 14, 2, 128, True, None, None),
                     (2, 200, 7, 1, 256, True, 64, 50.0)]
# G = 6 at head dim 128 with grok-1's softcap 30 (48/8 heads), causal;
# and cross-attention's non-causal queries against T = CROSS_T image
# tokens, S = 1 (a decode step) and S = 512 (a prefill), both in
# _check_flash's (b, s, h, kv, hd, causal, window, cap) form with its t
FLASH_SWEEP_G6 = [(1, 300, 48, 8, 128, True, None, 30.0),
                  (2, 200, 12, 2, 128, True, 64, 30.0)]
CROSS_T = 2048           # llama-3.2-vision's image tokens
# other image embeddings must move the VLM's prefill logits by at least
# this many times LOGITS_REL_TOL (rel. L2), so that a cross-attention
# output lost or read from the wrong image fails the kernel-vs-plain check
IMAGE_MOVE_OF = 4
FLASH_SWEEP_CROSS = [(2, 1, 16, 2, 128, False, None, None),
                     (1, 512, 16, 2, 128, False, None, None)]
PREFILL_LENS = (32, 64, 128, 256, 512, 200)
DECODE_SWEEP = [  # (b, t, h, kv, hd, window, cap): tests/test_kernels.py
    (2, 256, 8, 2, 64, None, None),
    (1, 512, 4, 4, 128, 128, None),
    (3, 256, 16, 8, 64, None, 30.0),
    (2, 384, 8, 1, 32, 64, None),
    (3, 300, 8, 2, 80, 100, 30.0),          # head dim 80 (zamba2)
]
# head dim 256 at G 2 and 8 (the most accumulators a lane, 64), and G 7;
# every other (256, G) and (hd, 7) pair is
# tests/test_torch_cuda.py::test_decode_kernel_every_dense_pair's
DECODE_SWEEP_DENSE = [
    (3, 300, 8, 4, 256, 100, 30.0),
    (2, 520, 16, 2, 256, 64, None),
    (3, 300, 7, 1, 128, None, 50.0),
    (2, 384, 56, 8, 128, 64, None),
    # G = 6 (grok-1's 48/8 heads) at head dim 128, with and without its
    # softcap 30; (256, 6) is tests/test_torch_cuda.py's
    (3, 300, 12, 2, 128, None, 30.0),
    (2, 520, 48, 8, 128, 64, None),
]
SSD_SWEEP = [  # (b, s, nh, hd, ns): tests/test_kernels.py, plus ragged S
    (2, 128, 3, 32, 16),
    (1, 256, 2, 64, 32),
    (1, 64, 4, 16, 8),
    (2, 200, 3, 64, 64),
]
N_REQUESTS, MAX_BATCH, MAX_LEN, NEW_TOKENS = 16, 8, 1024, 32
FLOOD_REQUESTS = 200     # serving_memory's requests after its first wave
XLSTM_ARCH, MUSIC_ARCH = "xlstm-350m", "musicgen-medium"
# serving_memory's flood where it is not FLOOD_REQUESTS: an xLSTM prefill
# runs its sLSTM layers' loop over every prompt token
FLOOD = {XLSTM_ARCH: 24}
MUSIC_PROMPT = 512       # frames a musicgen prompt, each of 4 codebooks
GROK, DSV3, VISION = "grok-1-314b", "deepseek-v3-671b", "llama-3.2-vision-90b"
MOE_ARCHS = (GROK, DSV3)
VISION_PROMPT = 512      # tokens a vision prompt, with its 2048 image tokens
# the JAX package's counts (repro.models.config.ModelConfig.param_count)
PUBLISHED_PARAMS = {XLSTM_ARCH: 476_597_248, MUSIC_ARCH: 1_384_269_312,
                    GROK: 316_489_340_928, DSV3: 671_026_419_200,
                    VISION: 87_645_828_116}
# gemma2-27b's long-context check: one prompt of LONG_PROMPT tokens (past
# the local layers' 4096 window) into a cache of LONG_CACHE positions,
# then one decode step, at full width and LONG_LAYERS layers (2 of the 23
# local/global repeats)
LONG_ARCH, LONG_KEY = "gemma2-27b", "gemma2-27b-long"
LONG_PROMPT, LONG_CACHE, LONG_LAYERS = 4608, 8192, 4
TRAIN_ARCH, TRAIN_KEY = "llama3.2-1b", "llama3.2-1b-train"
ZTRAIN_ARCH, ZTRAIN_KEY = "zamba2-2.7b", "zamba2-2.7b-train"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 8
# the families that serve at full width and train at a depth cut (whole
# repeats of each config's pattern, every width as published; full depth
# does not fit one card): arch -> (layers at the cut, optimizer).  The VLM
# takes Adafactor, as grok's config does: at 6.38e9 params AdamW's fp32
# moments alone are 51 GB
WIDE_TRAIN = {"gemma-7b": (8, "adamw"), "gemma2-27b": (2, "adamw"),
              "deepseek-coder-33b": (4, "adamw"), GROK: (1, "adafactor"),
              VISION: (5, "adafactor")}
# their peak learning rate (TRAIN_OPT's otherwise): at TRAIN_OPT's 1e-3
# deepseek-coder's, grok's and the VLM's loss rose again from the third
# step and ended 0.4 to 2.1 nat above its first (d 6144 to 8192, on an
# H100; PERF.md section 6)
WIDE_LR = 2e-4
# runs of a wide training cell's plain attention timed in phase 4 (25 for
# every other row)
WIDE_PLAIN_ITERS = 5
# (batch, seq) of a training step where it is not TRAIN_BATCH x TRAIN_SEQ:
# gemma2-27b trains at its context, where its local layers' 4096 window
# masks (it never does at S = 2048)
TRAIN_SHAPE = {"gemma2-27b": (1, 8192)}
# a training slice's depth where it is cut (whole repeats, every width as
# published): xlstm-350m trains at one of its three (7 mLSTM + 1 sLSTM)
# repeats.  Its step is host-bound (579503 launches at 24 layers: the
# sLSTM's Python loop, 19-25 s a step on the card's host), so at full
# depth its training took 259-292 s of a script that ran 1100-1159 s, and
# one run past the script's 1200 s time limit; at 8 layers ~100 s
# (``--xlstm-depth`` still trains all three repeats)
TRAIN_CUT = {XLSTM_ARCH: 8}
# the depth of a training slice's gradient parity where it is cut below
# the trained model's: zamba2's fp32 plain path runs the SSD's sequential
# recurrence, 84-100 s at its 54 layers; 2 of 9 repeats keep the shared
# attention block's gradient summed over two uses
PARITY_CUT = {ZTRAIN_ARCH: 12}
TRAIN_OPT = dict(lr=1e-3, warmup=2, weight_decay=0.0)
LOSS_MARGIN = 0.5        # nats the loss must fall over the 8 steps
# where an arch's margin is another: xlstm-350m's bf16 gradients are as
# far apart as 0.5 (rel. L2 a leaf) between two routes that differ only in
# rmsnorm's rounding (its parity in bf16; the JAX package's bf16 model is
# as sensitive, tests/test_torch_xlstm.py::
# test_bf16_sensitivity_matches_jax_at_full_width), and at TRAIN_OPT's lr
# its loss falls by hundredths of a nat in 8 steps at its full depth
# (0.6-1 nat at one of its three repeats, ``TRAIN_CUT``, --xlstm-depth); it
# must fall
LOSS_MARGIN_OF = {XLSTM_ARCH: 0.0}
# the held-out check: after the 8 steps the loss on an unseen batch must
# stay above the fixed batch's by LOSS_MARGIN, or, for an arch here, by
# this share of what the fixed batch's loss fell (a model that learnt
# only what carries over, or saw the next token, closes the gap)
HELD_OUT_SHARE_OF = {XLSTM_ARCH: 0.5}
PARITY_BATCH, PARITY_SEQ = 2, 512
PARITY_LOSS_REL, PARITY_GRAD_REL_L2 = 1e-2, 5e-2
# the dtype of each training slice's gradient parity.  zamba2 runs it in
# fp32: in bf16, rounding over its 54 layers moves every gradient leaf by
# ~8% (rel. L2 against the fp32 model), and swapping any one op's kernel
# for its plain version moves them by 4-8%, past the 5e-2 limit whichever
# op it is (``--parity-sweep`` measures this; PERF.md section 6); xlstm
# too: one more rounding in its norms moves its bf16 gradients by ~0.6-0.8
# (the median leaf), in the JAX package's model as in the port's
# (tests/test_torch_xlstm.py::test_bf16_sensitivity_matches_jax_at_full_width)
PARITY_DTYPE = {"llama3.2-1b": "bfloat16", "zamba2-2.7b": "float32",
                XLSTM_ARCH: "float32", MUSIC_ARCH: "bfloat16",
                **{arch: "bfloat16" for arch in WIDE_TRAIN}}
# the dtype of a serving slice's kernel-vs-plain logits where it is not
# the model's: xLSTM's exponential gates amplify one bf16 ulp in a norm
# past LOGITS_REL_TOL (its bf16 gap is printed beside), in the JAX
# package's model as in the port's (the same test)
LOGITS_DTYPE = {XLSTM_ARCH: "float32"}
# deepseek-v3's absorbed-vs-naive MLA logits are checked in fp32, on a
# model of its own at these layers (``absorbed_parity``; ~56 GB): in bf16
# the two forms round apart and the router choices that flip with the
# rounding take the gap past LOGITS_REL_TOL (on an H100: rel. L2 0.04221
# / 0.06963 at the prefill / decode step, 2.0% / 3.9% of the choices
# differing); the bf16 figures are printed beside the gap with the
# choices pinned (PERF.md section 6)
ABSORBED_CUT = {DSV3: (1, 1)}
RESTART_TOL = 1e-6       # tests/test_train_serve_ft.py:83-103
XTRAIN_KEY, MTRAIN_KEY = f"{XLSTM_ARCH}-train", f"{MUSIC_ARCH}-train"
WIDE_KEYS = {arch: f"{arch}-train" for arch in WIDE_TRAIN}
COORD_KEY = "llama3.2-1b-coordinator"
ZCOORD_KEY = "zamba2-2.7b-coordinator"
COORD_EXECUTORS, COORD_MICRO, COORD_STEPS = 4, 4, 2
COORD_TOL = 5e-3         # abs and rel, tests/test_train_serve_ft.py:143-146
FUSED_KEY = "llama3.2-1b-optimized"
# rel. L2 of the optimized (fused QKV and gate/up) model's logits against
# the unfused model on the concatenated weights: the same function, but
# cuBLAS rounds the wider bf16 products in another order, so each layer's
# bf16 activations differ by an ulp here and there; the limit of the
# kernel-vs-plain comparison of one bf16 model (LOGITS_REL_TOL)
FUSED_REL_L2 = LOGITS_REL_TOL
# "dots" against "full" step-1 gradients, a leaf, where not bit-equal
DOTS_REL_L2 = 1e-3
SSD_BWD_FP32_REL_L2 = 1e-5  # fp32 backward kernel: exact FMAs, another order
# the rmsnorm calls of each path, checked and timed at their rows: (path,
# call, rows, widths); a decode step's 8 slots and a 512-token prefill at
# llama's d and at zamba2's d and 2 d (the gated norm), and the training
# step (forward and backward)
RMS_CALLS = [("llama3.2-1b", "decode step", MAX_BATCH, (2048,)),
             ("llama3.2-1b", "prefill", 512, (2048,)),
             ("zamba2-2.7b", "decode step", MAX_BATCH, (2560, 5120)),
             ("zamba2-2.7b", "prefill", 512, (2560, 5120)),
             (TRAIN_KEY, "training step", TRAIN_BATCH * TRAIN_SEQ, (2048,)),
             (ZTRAIN_KEY, "training step", TRAIN_BATCH * TRAIN_SEQ,
              (2560, 5120)),
             (COORD_KEY, "microbatch", TRAIN_SEQ, (2048,)),
             ("gemma2-27b", "decode step", MAX_BATCH, (4608,)),
             ("gemma2-27b", "prefill", 512, (4608,)),
             ("gemma-7b", "decode step", MAX_BATCH, (3072,)),
             ("gemma-7b", "prefill", 512, (3072,)),
             ("deepseek-coder-33b", "decode step", MAX_BATCH, (7168,)),
             ("deepseek-coder-33b", "prefill", 512, (7168,)),
             (LONG_KEY, "prefill", LONG_PROMPT, (4608,)),
             (XLSTM_ARCH, "decode step", MAX_BATCH, (1024, 2048)),
             (XLSTM_ARCH, "prefill", 512, (1024, 2048)),
             (XTRAIN_KEY, "training step", TRAIN_BATCH * TRAIN_SEQ,
              (1024, 2048)),
             (MUSIC_ARCH, "decode step", MAX_BATCH, (1536,)),
             (MUSIC_ARCH, "prefill", MAX_BATCH * MUSIC_PROMPT, (1536,)),
             (MTRAIN_KEY, "training step", TRAIN_BATCH * TRAIN_SEQ,
              (1536,)),
             (ZCOORD_KEY, "microbatch", TRAIN_SEQ, (2560, 5120)),
             (GROK, "decode step", MAX_BATCH, (6144,)),
             (GROK, "prefill", 512, (6144,)),
             # d, and MLA's q_norm and kv_norm at the latent ranks
             (DSV3, "decode step", MAX_BATCH, (7168, 1536, 512)),
             (DSV3, "prefill", 512, (7168, 1536, 512)),
             # the VLM's batched prefill of 8 x 512 tokens and its decode
             # steps at d; its cross-attention layers' q_norm over head_dim
             # (a row a query head) and, at the prefill only, k_norm (a
             # row an image token's kv head)
             (VISION, "decode step", MAX_BATCH, (8192,)),
             (VISION, "prefill", MAX_BATCH * VISION_PROMPT, (8192,)),
             (VISION, "decode step q_norm", MAX_BATCH * 64, (128,)),
             (VISION, "prefill q_norm", MAX_BATCH * VISION_PROMPT * 64,
              (128,)),
             (VISION, "prefill k_norm", MAX_BATCH * CROSS_T * 8, (128,)),
             # the wide training cells' steps; the VLM's cross-attention
             # norms over head_dim at a row a query head (q_norm) and a
             # row an image token's kv head (k_norm)
             (WIDE_KEYS["gemma-7b"], "training step",
              TRAIN_BATCH * TRAIN_SEQ, (3072,)),
             (WIDE_KEYS["gemma2-27b"], "training step", 8192, (4608,)),
             (WIDE_KEYS["deepseek-coder-33b"], "training step",
              TRAIN_BATCH * TRAIN_SEQ, (7168,)),
             (WIDE_KEYS[GROK], "training step", TRAIN_BATCH * TRAIN_SEQ,
              (6144,)),
             (WIDE_KEYS[VISION], "training step", TRAIN_BATCH * TRAIN_SEQ,
              (8192,)),
             (WIDE_KEYS[VISION], "training step q_norm",
              TRAIN_BATCH * TRAIN_SEQ * 64, (128,)),
             (WIDE_KEYS[VISION], "training step k_norm",
              TRAIN_BATCH * CROSS_T * 8, (128,))]
# rows of the serving forward's sweep in --rmsnorm-times: a decode step,
# prompts of 32-512 tokens, and on to the training step's, across the
# forward's change of plan (kernels/rmsnorm.py FEW_ELEMS: past 409, 819
# and 1024 rows at d 5120, 2560 and 2048)
RMS_TIMED_ROWS = (MAX_BATCH, 32, 64, 128, 192, 256, 384, 512, 768, 1024,
                  2048, 4096, TRAIN_BATCH * TRAIN_SEQ)

# (arch, published widths: layers, d, heads, kv heads, head dim, d_ff,
#  vocab, dtype, mamba (d_state, d_conv, expand, head_dim, chunk) or None;
#  layers run, where the depth is cut, else None).  zamba2, gemma2-27b,
# gemma-7b and xlstm served at full depth until the script outgrew its
# 1200 s time limit (1217 s on an H100 machine whose host ran the
# host-bound phases 20-50% slower than another run of the same tree took
# them): their depth is cut to whole repeats of each pattern, every width
# as published
SLICES = [
    ("llama3.2-1b", (16, 2048, 32, 8, 64, 8192, 128256, "bfloat16", None),
     None),
    # 3 of 9 repeats of (5 mamba2 + 1 shared attention)
    ("zamba2-2.7b", (54, 2560, 32, 32, 80, 10240, 32000, "bfloat16",
                     (64, 4, 2, 64, 128)), 18),
    # 8 of 23 (local, global) pairs
    ("gemma2-27b", (46, 4608, 32, 16, 128, 36864, 256000, "bfloat16", None),
     16),
    ("gemma-7b", (28, 3072, 16, 16, 256, 24576, 256000, "bfloat16", None),
     8),
    # 16 of 62 layers, for chip time (full depth: 33.3e9 params, 66.7 GB)
    ("deepseek-coder-33b", (62, 7168, 56, 8, 128, 19200, 32256, "bfloat16",
                            None), 16),
    # head_dim is the config's; the mLSTM's heads are 2048 / 4 = 512 wide
    # and the sLSTM's 1024 / 4 = 256; 1 of 3 (7 mLSTM + 1 sLSTM) repeats
    (XLSTM_ARCH, (24, 1024, 4, 4, 256, 0, 50304, "bfloat16", None), 8),
    # served through prefill/decode_step (run_codebook_slice)
    (MUSIC_ARCH, (48, 1536, 24, 24, 64, 6144, 2048, "bfloat16", None),
     None),
    # 4 of 64 layers (21.29e9 params, 42.6 GB; full depth 316e9)
    (GROK, (64, 6144, 48, 8, 128, 32768, 131072, "bfloat16", None), 4),
    # 1 of its 3 dense layers and 2 of its 58 MoE layers (25.45e9 params,
    # 50.9 GB; full depth 671e9)
    (DSV3, (61, 7168, 128, 128, 128, 18432, 129280, "bfloat16", None),
     (1, 2)),
    # 2 of 20 repeats of (4 self-attention + 1 cross-attention) = 10 of 100
    # layers (10.66e9 params, 21.3 GB); through prefill/decode_step
    # (run_vision_slice)
    (VISION, (100, 8192, 64, 8, 128, 28672, 128256, "bfloat16", None), 10),
]
# the flash backward at the wide training cells' shapes, cut in batch and
# heads (both dtypes; the plain fp32 backward holds (B, H, S, T) fp32
# matrices): head dim 256 (gemma-7b), G 6 with grok's cap 30, G 7
# (deepseek-coder), gemma2's window 4096 at S = 8192 with its cap 50 and
# scale 1/12, and the VLM's non-causal cross-attention at S = T = 2048
FLASH_BWD_SWEEP_WIDE = [(2, 300, 4, 2, 256, True, None, None),
                        (1, 512, 16, 16, 256, True, None, None),
                        (1, 512, 48, 8, 128, True, None, 30.0),
                        (1, 512, 56, 8, 128, True, None, None),
                        (1, 8192, 4, 2, 128, True, 4096, 50.0, 1 / 12),
                        (1, 2048, 64, 8, 128, False, None, None)]
# each dense arch's attention as its layers call the kernels: (heads, kv
# heads, head dim, window, softcap, scale); gemma2's local layers' window
# never masks a prompt of at most 512 tokens or a 1024-position cache
DENSE_ATTN = {
    "gemma2-27b": (32, 16, 128, 4096, 50.0, 1 / 12),
    "gemma-7b": (16, 16, 256, None, None, 1 / 16),
    "deepseek-coder-33b": (56, 8, 128, None, None, 128 ** -0.5),
    GROK: (48, 8, 128, None, 30.0, 128 ** -0.5),     # G = 6
}


def _randn(rng, shape, dtype):
    a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return a.to(dtype).cuda()


def _check_close(what, got, want, tol):
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bad = err > tol + tol * w.abs()
    max_err = float(err.max())
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} elements off, "
                             f"max abs err {max_err}")
    return max_err


def _rel_l2(got, want):
    """||got - want|| / ||want||, both taken in fp32."""
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm())


def _ssd_inputs(rng, b, s, nh, hd, ns, dtype):
    """x, dt, a, b, c, d as tests/test_kernels.py draws them (dt > 0,
    a < 0); x, b, c in ``dtype``, the rest fp32."""
    dt = torch.from_numpy((np.abs(rng.standard_normal((b, s, nh))) * 0.1
                           + 0.01).astype(np.float32)).cuda()
    a = torch.from_numpy(-(np.abs(rng.standard_normal(nh)) + 0.1).astype(
        np.float32)).cuda()
    return (_randn(rng, (b, s, nh, hd), dtype), dt, a,
            _randn(rng, (b, s, ns), dtype), _randn(rng, (b, s, ns), dtype),
            _randn(rng, (nh,), torch.float32))


def _check_flash(rng, dtype, cases, out, key, keep=max(PREFILL_LENS),
                 t=None):
    """Each case (b, s, h, kv, hd, causal, window, cap[, scale]; the scale
    1 / sqrt(hd) unless given) within ``tol`` of the plain version, its
    keys and values as long as its queries unless ``t`` is given; with a
    ``key``, the case of S = ``keep`` is kept for the timing phase."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    tol = TOL[str(dtype).removeprefix("torch.")]
    for b, s, h, kv, hd, causal, window, cap, *scale in cases:
        q = _randn(rng, (b, s, h, hd), dtype)
        k = _randn(rng, (b, t or s, kv, hd), dtype)
        v = _randn(rng, (b, t or s, kv, hd), dtype)
        kw = dict(causal=causal, window=window, softcap=cap,
                  scale=scale[0] if scale else 1.0 / np.sqrt(hd))
        got = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        err = _check_close(f"flash_attention {dtype} {(b, s, h, kv, hd)}",
                           got, ref.flash_attention(q, k, v, **kw), tol)
        print(f"flash_attention {str(dtype)[6:]:8s} b={b} s={s} "
              f"t={t or s} h={h} kv={kv} hd={hd} causal={causal} "
              f"window={window} "
              f"cap={cap} scale={kw['scale']:.5g}: max abs err {err:.3e} "
              f"(tol {tol})")
        if key and s == keep:
            out[key] = (q, k, v, kw, err)


def _check_decode(rng, dtype, cases, out, key, lengths=None):
    """Each case (b, t, h, kv, hd, window, cap[, scale]) twice: bit-equal,
    free of NaN, and within ``tol`` of the plain version.  ``lengths`` (for
    every case) replaces the lengths drawn from 1 .. t-1."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    tol = TOL[str(dtype).removeprefix("torch.")]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, t, h, kv, hd, window, cap, *scale in cases:
        q = _randn(rng, (b, 1, h, hd), dtype)
        k = _randn(rng, (b, t, kv, hd), dtype)
        v = _randn(rng, (b, t, kv, hd), dtype)
        lens = (rng.integers(1, t, size=(b,)) if lengths is None
                else np.asarray(lengths))
        kw = dict(lengths=torch.from_numpy(lens.astype(np.int32)).cuda(),
                  window=window, softcap=cap,
                  scale=scale[0] if scale else 1.0 / np.sqrt(hd))
        got = da.decode_attention(q, k, v, **kw)
        again = da.decode_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        what = f"decode_attention {dtype} {(b, t, h, kv, hd)}"
        if bool(torch.isnan(got).any()):
            raise AssertionError(f"{what}: NaN in the output")
        if not torch.equal(got, again):
            raise AssertionError(f"{what}: two calls differ")
        want = ref.decode_attention(q, k, v, **kw)
        err = _check_close(what, got, want, tol)
        n_split = da.n_splits(b, kv, t, sms)
        print(f"decode_attention {str(dtype)[6:]:8s} b={b} t={t} h={h} "
              f"kv={kv} hd={hd} window={window} cap={cap}"
              f"{'' if lengths is None else f' lengths={list(lengths)}'}"
              f" n_split={n_split}: max abs err {err:.3e} (tol {tol}), "
              f"rel L2 {_rel_l2(got, want):.3e}, bit-equal twice, no NaN")
        if key:
            out[key] = (q, k, v, kw, err, n_split)


def _check_ssd_rel(what, got, want, limit):
    """Rel. L2 of ``got`` against ``want``; raises past ``limit`` (None:
    no limit)."""
    rel = _rel_l2(got, want)
    if limit is not None and not rel <= limit:
        raise AssertionError(f"{what}: rel L2 {rel} > {limit}")
    return rel


def _check_ssd(rng, dtype, cases, out, key, keep=None, with_h0=True,
               split=True):
    """Each case twice (bit-equal), within ``tol`` of the plain version,
    and in bf16 y and h_final within the rel. L2 limit
    ``SSD_REL_L2_BF16``; then (``split``) a sequence split at h0.  With a
    ``key``, the case ``keep`` is kept for the timing phase, with an h0
    where ``with_h0`` (a prefill passes one, training none)."""
    from repro_torch.kernels import mamba_chunk_scan as mcs
    from repro_torch.kernels import ref
    tol = SSD_TOL[str(dtype).removeprefix("torch.")]
    limit = mcs.SSD_REL_L2_BF16 if dtype == torch.bfloat16 else None
    for b, s, nh, hd, ns in cases:
        args = _ssd_inputs(rng, b, s, nh, hd, ns, dtype)
        h0 = torch.from_numpy(rng.standard_normal((b, nh, hd, ns)).astype(
            np.float32)).cuda() if key and with_h0 else None
        y, h = mcs.mamba_chunk_scan(*args, h0=h0)
        y2, h2 = mcs.mamba_chunk_scan(*args, h0=h0)
        torch.cuda.synchronize()
        what = f"mamba_chunk_scan {dtype} {(b, s, nh, hd, ns)}"
        if not (torch.equal(y, y2) and torch.equal(h, h2)):
            raise AssertionError(f"{what}: two calls differ")
        want_y, want_h = ref.mamba_chunk_scan(*args, h0=h0)
        err = max(_check_close(what + " y", y, want_y, tol),
                  _check_close(what + " h_final", h, want_h, tol))
        rel_y = _check_ssd_rel(what + " y", y, want_y, limit)
        rel_h = _check_ssd_rel(what + " h_final", h, want_h, limit)
        print(f"mamba_chunk_scan {str(dtype)[6:]:8s} b={b} s={s} nh={nh} "
              f"hd={hd} ns={ns}: max abs err {err:.3e} (tol {tol}), rel L2 "
              f"y {rel_y:.3e} h_final {rel_h:.3e} (limit {limit}), "
              f"bit-equal twice")
        if key and (b, s, nh, hd, ns) == keep:
            out[key] = (args, h0, err)
    if not split:
        return
    # split at h0: the first part's h_final feeds the rest
    x, dt, a, bm, cm, d = _ssd_inputs(rng, 2, 160, 4, 64, 64, dtype)
    cut = 96
    parts = [[t[:, sl].contiguous() for t in (x, dt, bm, cm)]
             for sl in (slice(0, cut), slice(cut, None))]
    _, h1 = mcs.mamba_chunk_scan(*parts[0][:2], a, *parts[0][2:], d)
    y2, h2 = mcs.mamba_chunk_scan(*parts[1][:2], a, *parts[1][2:], d, h0=h1)
    torch.cuda.synchronize()
    want_y, want_h = ref.mamba_chunk_scan(x, dt, a, bm, cm, d)
    err = max(_check_close("mamba_chunk_scan h0 split y", y2,
                           want_y[:, cut:], tol),
              _check_close("mamba_chunk_scan h0 split h", h2, want_h, tol))
    rel_y = _check_ssd_rel("mamba_chunk_scan h0 split y", y2,
                           want_y[:, cut:], limit)
    rel_h = _check_ssd_rel("mamba_chunk_scan h0 split h_final", h2, want_h,
                           limit)
    print(f"mamba_chunk_scan {str(dtype)[6:]:8s} split at h0 (160 = 96 + "
          f"64): max abs err {err:.3e} (tol {tol}), rel L2 y {rel_y:.3e} "
          f"h_final {rel_h:.3e} (limit {limit})")


def _check_ssd_bwd(rng, dtype, cases, out, key):
    """The SSD backward kernel against ``ref.mamba_chunk_scan_bwd``: each
    case twice (bit-equal), every output within the rel. L2 limit
    (``SSD_BWD_REL_L2_BF16`` in bf16, ``SSD_BWD_FP32_REL_L2`` in fp32).
    Cases are (b, s, nh, hd, ns, with h0, with dh_final); with a ``key``
    the last case is kept for the timing phase."""
    from repro_torch.kernels import mamba_chunk_scan as mcs
    from repro_torch.kernels import ref
    name = str(dtype).removeprefix("torch.")
    limit = (mcs.SSD_BWD_REL_L2_BF16 if dtype == torch.bfloat16
             else SSD_BWD_FP32_REL_L2)
    for b, s, nh, hd, ns, with_h0, with_dhf in cases:
        args = _ssd_inputs(rng, b, s, nh, hd, ns, dtype)
        h0 = _randn(rng, (b, nh, hd, ns), torch.float32) if with_h0 \
            else None
        dy = _randn(rng, (b, s, nh, hd), dtype)
        dhf = _randn(rng, (b, nh, hd, ns), torch.float32)
        dhf = dhf if with_dhf else None  # drawn either way: same stream
        got = mcs.mamba_chunk_scan_bwd(*args, dy, dhf, h0=h0)
        again = mcs.mamba_chunk_scan_bwd(*args, dy, dhf, h0=h0)
        torch.cuda.synchronize()
        what = f"mamba_chunk_scan_bwd {dtype} {(b, s, nh, hd, ns)}"
        if not all(g is None or torch.equal(g, h)
                   for g, h in zip(got, again)):
            raise AssertionError(f"{what}: two calls differ")
        del again
        want = ref.mamba_chunk_scan_bwd(*args, dy, dhf, h0=h0)
        rels, err = {}, 0.0
        for n, g, w in zip(("dx", "ddt", "da", "db", "dc", "dd", "dh0"),
                           got, want):
            if w is None:
                continue
            rels[n] = _check_ssd_rel(f"{what} {n}", g, w, limit)
            err = max(err, float((g.float() - w.float()).abs().max()))
        del got, want
        print(f"mamba_chunk_scan_bwd {name:8s} b={b} s={s} nh={nh} hd={hd} "
              f"ns={ns} h0={with_h0} dh_final={with_dhf}: rel L2 "
              f"{', '.join(f'{n} {r:.3e}' for n, r in rels.items())} "
              f"(limit {limit}), max abs err {err:.3e}, bit-equal twice")
        if key:
            out[key] = ((*args, dy, dhf), h0, err)


def _check_flash_refuses_empty_rows():
    """A window with q_offset + S >= T + window leaves the last query row
    with no live key: the flash forward and backward wrappers must raise,
    and launch nothing."""
    from repro_torch.kernels import flash_attention as fa
    s, t, window = 64, 128, 32
    q = torch.zeros((1, s, 4, 64), dtype=torch.bfloat16, device="cuda")
    k = torch.zeros((1, t, 2, 64), dtype=torch.bfloat16, device="cuda")
    lse = torch.zeros((1, 4, s), device="cuda")
    kw = dict(window=window, q_offset=t + window - s)
    calls = (("forward", fa.flash_attention,
              lambda: fa.flash_attention_fwd(q, k, k, **kw)),
             ("backward", fa.flash_attention_bwd,
              lambda: fa.flash_attention_bwd(q, k, k, q, lse, q, **kw)))
    for name, wrapper, call in calls:
        n = wrapper.launches
        try:
            call()
        except ValueError as e:
            refused = "no live key" in str(e)
        else:
            refused = False
        if not refused or wrapper.launches != n:
            raise AssertionError(f"flash {name} did not refuse a query row "
                                 f"with no live key")
        print(f"flash_attention {name}: refuses S={s}, T={t}, window="
              f"{window}, q_offset={kw['q_offset']} (a row with no live "
              f"key)")


def _check_dense_refusals():
    """What the dense family's kernels are not built for: decode at
    head_dim 256 with G = 16.  The wrapper must raise a ValueError that
    names it, and launch nothing."""
    from repro_torch.kernels import decode_attention as da
    k = torch.zeros((1, 64, 2, 256), dtype=torch.bfloat16, device="cuda")
    q1 = torch.zeros((1, 1, 32, 256), dtype=torch.bfloat16, device="cuda")
    lengths = torch.ones(1, dtype=torch.int32, device="cuda")
    calls = (("decode_attention at head_dim 256, G = 16", da.decode_attention,
              "group size 16", lambda: da.decode_attention(
                  q1, k, k, lengths=lengths)),)
    for what, wrapper, says, call in calls:
        n = wrapper.launches
        try:
            call()
        except ValueError as e:
            refused = says in str(e)
            msg = str(e)
        else:
            refused, msg = False, ""
        if not refused or wrapper.launches != n:
            raise AssertionError(f"{what} was not refused")
        print(f"{what}: refused ({msg})")


def _check_rmsnorm(rng, dtype, shapes, out, key,
                   rows=("rms_fwd", "rms_bwd")):
    """Forward and backward against the plain versions; the forward
    without rstd gives the same y bits, and the backward the same bits
    twice.  ``key`` ("<path>:<call>") keeps each shape's zero-centred
    inputs for the timed ``rows``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    name = str(dtype).removeprefix("torch.")
    tol, btol = TOL[name], RMS_BWD_TOL[name]
    for shape in shapes:
        for zc in (True, False):
            x = _randn(rng, shape, dtype)
            scale = _randn(rng, shape[-1:], dtype) * 0.1
            g = _randn(rng, shape, dtype)
            y, rstd = rn.rmsnorm_fwd(x, scale, zero_centered=zc)
            y2, none = rn.rmsnorm_fwd(x, scale, zero_centered=zc,
                                      with_rstd=False)
            dx, dscale = rn.rmsnorm_bwd(x, scale, rstd, g, zero_centered=zc)
            dx2, dscale2 = rn.rmsnorm_bwd(x, scale, rstd, g,
                                          zero_centered=zc)
            torch.cuda.synchronize()
            what = f"rmsnorm {dtype} {shape} zero_centered={zc}"
            if none is not None or not torch.equal(y, y2):
                raise AssertionError(f"{what}: the forward without rstd "
                                     f"differs")
            if not (torch.equal(dx, dx2) and torch.equal(dscale, dscale2)):
                raise AssertionError(f"{what}: two backward calls differ")
            want_r = torch.rsqrt(x.float().square().mean(-1) + 1e-6)
            err_f = max(
                _check_close(what + " y", y,
                             ref.rmsnorm(x, scale, zero_centered=zc), tol),
                _check_close(what + " rstd", rstd, want_r, TOL["float32"]))
            want_dx, want_ds = ref.rmsnorm_bwd(x, scale, g, zero_centered=zc)
            err_b = max(_check_close(what + " dx", dx, want_dx, btol),
                        _check_close(what + " dscale", dscale, want_ds,
                                     btol))
            print(f"rmsnorm {name:8s} {shape} zero_centered={zc}: max abs "
                  f"err fwd {err_f:.3e} (tol {tol}), bwd {err_b:.3e} "
                  f"(tol {btol}); y bit-equal without rstd, backward "
                  f"bit-equal twice")
            if key and zc:  # timed rows, one a shape
                got = {"rms_fwd": ((x, scale), err_f),
                       "rms_bwd": ((x, scale, rstd, g), err_b)}
                for kind in rows:
                    out[f"{kind}:{key}:{'x'.join(map(str, shape))}"] = \
                        got[kind]


TRAINING_CALLS = ("training step", "microbatch")


def _rms_kinds(call):
    """The rmsnorm kernels a call launches: a training step (the VLM's
    cross-attention norms in one too) or a coordinator's microbatch
    both."""
    return (("rms_fwd", "rms_bwd") if call.startswith(TRAINING_CALLS)
            else ("rms_fwd",))


def _check_flash_bwd(rng, dtype, cases, out, key):
    """The forward's LSE and the backward kernel against the plain
    versions, both given the kernel forward's output and LSE, and the
    backward bit-equal twice.  A case is (b, s, h, kv, hd, causal,
    window, cap[, scale]) with T = S; the scale defaults to hd^-0.5."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    name = str(dtype).removeprefix("torch.")
    tol, btol = TOL[name], FLASH_BWD_TOL[name]
    for b, s, h, kv, hd, causal, window, cap, *scale in cases:
        t0 = time.perf_counter()
        q = _randn(rng, (b, s, h, hd), dtype)
        k = _randn(rng, (b, s, kv, hd), dtype)
        v = _randn(rng, (b, s, kv, hd), dtype)
        do = _randn(rng, (b, s, h, hd), dtype)
        kw = dict(causal=causal, window=window, softcap=cap,
                  scale=scale[0] if scale else 1.0 / np.sqrt(hd))
        o, lse = fa.flash_attention_fwd(q, k, v, **kw)
        grads = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError(f"flash_attention_bwd {dtype} "
                                 f"{(b, s, h, kv, hd)}: two calls differ")
        del again
        what = f"flash_attention {dtype} {(b, s, h, kv, hd)}"
        want_o, want_lse = ref.flash_attention_fwd(q, k, v, **kw)
        err_o = _check_close(what + " out", o, want_o, tol)
        err_l = _check_close(what + " lse", lse, want_lse, tol)
        del want_o, want_lse
        want = ref.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        err = max(_check_close(f"{what} d{n}", a, w, btol)
                  for n, a, w in zip("qkv", grads, want))
        del want
        print(f"flash_attention_bwd {name:8s} b={b} s={s} h={h} kv={kv} "
              f"hd={hd} causal={causal} window={window} cap={cap}: max abs "
              f"err lse {err_l:.3e} (tol {tol}), dq/dk/dv {err:.3e} (tol "
              f"{btol}); bit-equal twice; {time.perf_counter() - t0:.1f} s")
        if key:
            out["flash:" + key] = (q, k, v, kw, err_o)
            out["flash_bwd:" + key] = ((q, k, v, o, lse, do), kw, err)


def _to(tree, device):
    """``tree`` (tuples, lists and dicts of tensors and plain values) with
    every tensor moved to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


def wide_flash_bwd_cases():
    """The wide training cells' flash calls, keyed as ``kernel_numbers``
    reads them (cell key, then the call where a step makes two kinds):
    (b, s, h, kv, hd, causal, window, cap, scale) at each cell's (batch,
    seq), with T = S (the VLM's cross-attention: S = 2048 queries against
    its 2048 image tokens)."""
    cases = {}
    for arch, key in WIDE_KEYS.items():
        b, s = _train_shape(arch)
        if arch == VISION:
            h, kv, hd = 64, 8, 128
            assert s == CROSS_T
            cases[f"{key}:self"] = [(b, s, h, kv, hd, True, None, None,
                                     hd ** -0.5)]
            cases[f"{key}:cross"] = [(b, s, h, kv, hd, False, None, None,
                                      hd ** -0.5)]
            continue
        h, kv, hd, window, cap, scale = DENSE_ATTN[arch]
        if window:  # gemma2: a local layer and a global one
            cases[f"{key}:local"] = [(b, s, h, kv, hd, True, window, cap,
                                      scale)]
            cases[f"{key}:global"] = [(b, s, h, kv, hd, True, None, cap,
                                       scale)]
        else:
            cases[key] = [(b, s, h, kv, hd, True, None, cap, scale)]
    return cases


def check_kernels():
    """Every kernel against its plain version; returns the slice-shape
    inputs and errors for the timing phase."""
    rng = np.random.default_rng(0)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        t0 = time.perf_counter()
        bf16 = dtype == torch.bfloat16
        _check_flash(rng, dtype, FLASH_SWEEP, out, None)
        _check_flash(rng, dtype, FLASH_SWEEP_DENSE, out, None)
        _check_flash(rng, dtype, FLASH_SWEEP_G6, out, None)
        _check_flash(rng, dtype, FLASH_SWEEP_CROSS, out, None, t=CROSS_T)
        _check_decode(rng, dtype, DECODE_SWEEP, out, None)
        _check_decode(rng, dtype, DECODE_SWEEP_DENSE, out, None)
        _check_ssd(rng, dtype, SSD_SWEEP, out, None)
        _check_ssd_bwd(rng, dtype, [(*c, i % 2 == 0, i % 3 != 1)
                                    for i, c in enumerate(SSD_SWEEP)]
                       + [(1, 37, 4, 128, 128, True, True)], out, None)
        _check_rmsnorm(rng, dtype, RMS_SWEEP, out, None)
        _check_flash_bwd(rng, dtype, FLASH_SWEEP[:5] + FLASH_BWD_SWEEP_WIDE,
                         out, None)
        print(f"phase 2 sweeps in {dtype}: {time.perf_counter() - t0:.1f} s",
              flush=True)
        if not bf16:
            continue
        t0 = time.perf_counter()
        # the slices' shapes: llama (hd 64, GQA 32/8), zamba2 (hd 80, 32/32)
        for key, (h, kv, hd) in (("flash:llama3.2-1b", (32, 8, 64)),
                                 ("flash:zamba2-2.7b", (32, 32, 80))):
            _check_flash(rng, dtype, [(1, s, h, kv, hd, True, None, None)
                                      for s in PREFILL_LENS], out, key)
        _check_decode(rng, dtype, [(8, MAX_LEN, 32, 8, 64, None, None)], out,
                      "decode:llama3.2-1b")
        _check_decode(rng, dtype, [(8, MAX_LEN, 32, 32, 80, None, None)],
                      out, "decode:zamba2-2.7b")
        # every split combination: lengths 1, a split boundary (256) and
        # either side, T; the window empties whole splits
        _check_decode(rng, dtype, [(8, MAX_LEN, 32, 8, 64, w, None)
                                   for w in (None, 100)]
                      + [(8, MAX_LEN, 32, 32, 80, 300, None)], out, None,
                      lengths=[1, 255, 256, 257, 512, 700, 1000, MAX_LEN])
        _check_flash_refuses_empty_rows()
        # the dense family's serving shapes, as its layers call the kernels
        for arch, (h, kv, hd, window, cap, scale) in DENSE_ATTN.items():
            _check_flash(rng, dtype, [(1, s, h, kv, hd, True, window, cap,
                                       scale) for s in PREFILL_LENS],
                         out, "flash:" + arch)
            _check_decode(rng, dtype, [(MAX_BATCH, MAX_LEN, h, kv, hd, window,
                                        cap, scale)], out, "decode:" + arch)
        # gemma2's local window at work: the long-context check's prefill
        # (the only shape where the window masks), decode over LONG_CACHE
        # positions with lengths below, at and past the window, and the
        # long-context check's decode step
        h, kv, hd, window, cap, scale = DENSE_ATTN[LONG_ARCH]
        _check_flash(rng, dtype, [(1, LONG_PROMPT, h, kv, hd, True, window,
                                   cap, scale)], out, "flash:" + LONG_KEY,
                     keep=LONG_PROMPT)
        _check_decode(rng, dtype, [(MAX_BATCH, LONG_CACHE, h, kv, hd, window,
                                    cap, scale)], out, None,
                      lengths=[1, 2000, window - 1, window, window + 1,
                               LONG_PROMPT + 1, 6000, LONG_CACHE])
        _check_decode(rng, dtype, [(1, LONG_CACHE, h, kv, hd, window, cap,
                                    scale)], out, "decode:" + LONG_KEY,
                      lengths=[LONG_PROMPT + 1])
        _check_dense_refusals()
        _check_ssd(rng, dtype, [(1, s, 80, 64, 64) for s in PREFILL_LENS],
                   out, "ssd:zamba2-2.7b", keep=(1, max(PREFILL_LENS), 80,
                                                 64, 64))
        # the zamba2 training step's SSD, forward (no h0) and backward:
        # zamba2's widths with and without h0, a ragged S, the training
        # shape as the training step calls it (no h0, no dh_final: its
        # h_final is unused), and with a dh_final last (kept for the
        # timing phase)
        zshape = (TRAIN_BATCH, TRAIN_SEQ, 80, 64, 64)
        _check_ssd(rng, dtype, [zshape], out, "ssd:" + ZTRAIN_KEY,
                   keep=zshape, with_h0=False, split=False)
        _check_ssd_bwd(rng, dtype, [(1, 512, 80, 64, 64, True, True),
                                    (1, 512, 80, 64, 64, False, True),
                                    (2, 300, 80, 64, 64, True, True),
                                    (*zshape, False, False),
                                    (*zshape, False, True)], out,
                       "ssd_bwd:" + ZTRAIN_KEY)
        for path, call, n, ds in RMS_CALLS:
            _check_rmsnorm(rng, dtype, [(n, d) for d in ds], out,
                           f"{path}:{call}", rows=_rms_kinds(call))
        # the training slice's attention at (B, S, H, KV, hd)
        _check_flash_bwd(rng, dtype, [(TRAIN_BATCH, TRAIN_SEQ, 32, 8, 64,
                                       True, None, None)], out, TRAIN_KEY)
        # the coordinator's microbatch, (1, S, H, KV, hd)
        _check_flash_bwd(rng, dtype, [(1, TRAIN_SEQ, 32, 8, 64, True, None,
                                       None)], out, COORD_KEY)
        # zamba2's shared attention in training: hd 80, G = 1
        _check_flash_bwd(rng, dtype, [(TRAIN_BATCH, TRAIN_SEQ, 32, 32, 80,
                                       True, None, None)], out, ZTRAIN_KEY)
        # the zamba2 coordinator's microbatch, (1, S): the SSD forward and
        # backward (no h0, no dh_final), flash forward and backward
        cshape = (1, TRAIN_SEQ, 80, 64, 64)
        _check_ssd(rng, dtype, [cshape], out, "ssd:" + ZCOORD_KEY,
                   keep=cshape, with_h0=False, split=False)
        _check_ssd_bwd(rng, dtype, [(*cshape, False, False)], out,
                       "ssd_bwd:" + ZCOORD_KEY)
        _check_flash_bwd(rng, dtype, [(1, TRAIN_SEQ, 32, 32, 80, True, None,
                                       None)], out, ZCOORD_KEY)
        # musicgen-medium: 24/24 heads at hd 64 (G = 1); its batched
        # prefill of 8 x 512 frames, a decode step over 1024 positions,
        # and its training step's forward and backward
        _check_flash(rng, dtype, [(MAX_BATCH, MUSIC_PROMPT, 24, 24, 64, True,
                                   None, None)], out, "flash:" + MUSIC_ARCH,
                     keep=MUSIC_PROMPT)
        _check_decode(rng, dtype, [(MAX_BATCH, MAX_LEN, 24, 24, 64, None,
                                    None)], out, "decode:" + MUSIC_ARCH)
        _check_flash_bwd(rng, dtype, [(TRAIN_BATCH, TRAIN_SEQ, 24, 24, 64,
                                       True, None, None)], out, MTRAIN_KEY)
        # the wide training cells' attention forward and backward, as
        # their layers call them (gemma2's local and global layers, the
        # VLM's self- and cross-attention)
        for key, cases in wide_flash_bwd_cases().items():
            _check_flash_bwd(rng, dtype, cases, out, key)
        # llama-3.2-vision (64/8 heads, G = 8, hd 128): the self-attention
        # layers' batched 8 x 512 prefill and decode over 1024 positions;
        # the cross-attention layers' non-causal flash against the 2048
        # image tokens, at the prefill's 512 queries and a decode step's 1
        # (grok-1's G = 6 shapes are DENSE_ATTN's)
        _check_flash(rng, dtype, [(MAX_BATCH, VISION_PROMPT, 64, 8, 128,
                                   True, None, None)], out,
                     f"flash:{VISION}:self prefill", keep=VISION_PROMPT)
        _check_decode(rng, dtype, [(MAX_BATCH, MAX_LEN, 64, 8, 128, None,
                                    None)], out, "decode:" + VISION)
        for call, s in (("cross prefill", VISION_PROMPT),
                        ("cross decode step", 1)):
            _check_flash(rng, dtype, [(MAX_BATCH, s, 64, 8, 128, False, None,
                                       None)], out, f"flash:{VISION}:{call}",
                         keep=s, t=CROSS_T)
        print(f"phase 2 the slices' shapes: {time.perf_counter() - t0:.1f} s",
              flush=True)
    return out


def _n_layers(cfg, kind):
    return sum(sum(s.kind == kind for s in g.pattern) * g.repeat
               for g in cfg.groups)


def greedy_reference(cfg, params, prompt, batch=MAX_BATCH):
    """One request's greedy tokens through ``prefill``/``decode_step``.

    The prompt is padded as the engine pads it and decoded in a batch of
    ``batch`` rows (the request in row 0, the others idle), so every
    bf16 matmul sees the engine's shapes and rounds alike; without MoE the
    request's row is computed independently of the others, so any slot
    mix-up in the engine shows as different tokens.  Under an MoE's
    capacity the rows are not independent (idle rows take experts' slots),
    so the MoE slices hold a one-slot engine to ``batch=1``.
    """
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import tree_map
    from repro_torch.serve.engine import prefill_length
    s = len(prompt)
    toks = np.zeros((1, prefill_length(cfg, s - 1, MAX_LEN)), np.int32)
    toks[0, :s - 1] = prompt[:-1]
    one = model_lib.init_cache(cfg, 1, MAX_LEN, device="cuda")
    _, one = model_lib.prefill(params, cfg, torch.from_numpy(toks).cuda(),
                               one)
    cache = model_lib.init_cache(cfg, batch, MAX_LEN, device="cuda")
    tree_map(lambda g, p: g[:, 0].copy_(p[:, 0]), cache, one)
    cur, pos, out = int(prompt[-1]), s - 1, []
    for _ in range(NEW_TOKENS):
        tokens = torch.zeros((batch, 1), dtype=torch.int32, device="cuda")
        tokens[0, 0] = cur
        p = torch.zeros((batch,), dtype=torch.int32, device="cuda")
        p[0] = pos
        logits, cache = model_lib.decode_step(params, cfg, tokens, cache, p)
        cur = int(torch.argmax(logits[0, 0]))
        out.append(cur)
        pos += 1
    return out


def solo_generations(cfg, params, prompts):
    """Each prompt's tokens from a one-slot engine (``max_batch=1``), so
    no request shares a decode step (or an MoE's capacity) with another;
    every request is submitted before the engine starts."""
    from repro_torch.serve.engine import ServingEngine
    eng = ServingEngine(cfg, params, max_batch=1, max_len=MAX_LEN,
                        device="cuda")
    reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    eng.start()
    try:
        for r in reqs:
            if not r.done.wait(600):
                raise AssertionError(f"solo request {r.rid} did not finish")
    finally:
        eng.stop()
    return [r.out_tokens for r in reqs]


PLAIN_OPS = ("flash_attention", "decode_attention", "mamba_chunk_scan",
             "rmsnorm")


def _token_array(rng, cfg, *shape):
    """Random tokens of ``shape``, with a last axis of the config's
    codebooks where it has them."""
    k = cfg.num_codebooks
    return rng.integers(0, cfg.vocab_size,
                        (*shape, k) if k else shape).astype(np.int32)


@contextlib.contextmanager
def _routes(record, replay=None):
    """Append each MoE router call's choices (``ref.topk_gating``'s idx)
    to ``record``; with ``replay`` (another run's record), make the
    choices of that run instead, in call order, each weighted from this
    run's own logits as ``topk_gating`` weights them."""
    from repro_torch.kernels import ref
    real = ref.topk_gating
    pinned = None if replay is None else iter(replay)

    def topk_gating(logits, k, *, router="softmax", bias=None):
        if pinned is None:
            w, idx = real(logits, k, router=router, bias=bias)
        else:
            idx = next(pinned)
            g = torch.gather(logits, -1, idx).float()
            if router == "sigmoid":
                w = torch.sigmoid(g)
                w = w / (w.sum(-1, keepdim=True) + 1e-20)
            else:
                w = torch.softmax(g, dim=-1)
        record.append(idx)
        return w, idx

    with mock.patch.object(ref, "topk_gating", topk_gating):
        yield record


def _choices_differ(a, b):
    """The share of one run's (token, k) router choices that the other run
    did not make, over the router calls ``a`` and ``b`` (in call order);
    None without MoE."""
    if not a:
        return None
    diff = n = 0
    for x, y in zip(a, b, strict=True):
        hit = (x[..., :, None] == y[..., None, :]).any(-1)
        diff += int((~hit).sum())
        n += hit.numel()
    return diff / n


def _prefill_decode(cfg, params, image_embeds=None, mla_absorbed=False,
                    pin=None):
    """Logits (fp32) of one prefill of 8 x 128 tokens and one decode step,
    and each one's router choices; with ``pin`` (another such result),
    its router choices are made again (``_routes``)."""
    from repro_torch.models import model as model_lib
    rng = np.random.default_rng(1)
    b, s = 8, 128
    toks = torch.from_numpy(_token_array(rng, cfg, b, s + 1)).cuda()
    pos = torch.full((b,), s, dtype=torch.int32, device="cuda")
    cache = model_lib.init_cache(cfg, b, 256, device="cuda")
    with _routes([], pin and pin[0][1]) as r_pre:
        pre, cache = model_lib.prefill(params, cfg, toks[:, :s], cache,
                                       image_embeds, mla_absorbed)
    with _routes([], pin and pin[1][1]) as r_dec:
        dec, _ = model_lib.decode_step(params, cfg, toks[:, s:], cache, pos,
                                       mla_absorbed)
    return (pre.float(), r_pre), (dec.float(), r_dec)


def _logits_gap(a, b, check, what, pinned=None):
    """Rel. L2, max abs error and argmax agreement of ``a`` against ``b``
    (each ``_prefill_decode``'s result), with the share of router choices
    that differ where the model has MoE, and ``pinned``'s rel. L2 against
    ``b`` (``a``'s run again with ``b``'s router choices: the gap that
    rounding leaves without the choices that flip); with ``check``, each
    rel. L2 must be within LOGITS_REL_TOL."""
    res = {}
    for i, (name, (x, rx), (w, rw)) in enumerate(zip(("prefill", "decode"),
                                                      a, b)):
        rel = _rel_l2(x, w)
        res[name] = {"max_abs_err": float((x - w).abs().max()),
                     "rel_l2_err": rel, "token_agreement": float(
                         (x.argmax(-1) == w.argmax(-1)).float().mean())}
        differ = _choices_differ(rx, rw)
        if differ is not None:
            res[name]["router_choices_differ"] = differ
        if pinned is not None:
            res[name]["rel_l2_err_routes_pinned"] = _rel_l2(pinned[i][0], w)
        if check and not rel <= LOGITS_REL_TOL:
            raise AssertionError(f"{name} logits, {what}: rel L2 err {rel} "
                                 f"> {LOGITS_REL_TOL} ({res[name]})")
    return res


def compare_plain_path(cfg, params, plain_ops=PLAIN_OPS, check=True,
                       image_embeds=None):
    """Logits of one prefill + one decode step, kernels vs plain path (the
    ops of ``plain_ops`` swapped for their plain versions); with
    ``check``, each rel. L2 error must be within LOGITS_REL_TOL.  An MoE
    model's results carry the share of router choices that differ and the
    gap with the kernel path's choices pinned to the plain path's."""
    from repro_torch.kernels import ops, ref
    kernel = _prefill_decode(cfg, params, image_embeds)
    with contextlib.ExitStack() as stack:
        for op in plain_ops:
            stack.enter_context(mock.patch.object(ops, op, getattr(ref, op)))
        plain = _prefill_decode(cfg, params, image_embeds)
    pinned = (_prefill_decode(cfg, params, image_embeds, pin=plain)
              if cfg.moe else None)
    return _logits_gap(kernel, plain, check, "kernel vs plain path", pinned)


def compare_absorbed(cfg, params, check=True):
    """MLA's weight-absorbed form against its naive form (the JAX engine
    passes no ``mla_absorbed``): logits of one prefill + one decode step,
    each rel. L2 within LOGITS_REL_TOL with ``check``; with MoE, beside
    the gap with the absorbed run's router choices pinned to the naive
    run's."""
    naive = _prefill_decode(cfg, params)
    pinned = (_prefill_decode(cfg, params, mla_absorbed=True, pin=naive)
              if cfg.moe else None)
    return _logits_gap(_prefill_decode(cfg, params, mla_absorbed=True),
                       naive, check, "absorbed vs naive MLA", pinned)


def logits_parity(cfg, params, image_embeds=None):
    """``compare_plain_path`` in ``LOGITS_DTYPE`` (default: the model's
    dtype) on the params cast to it, checked; where that is not the
    model's dtype, the model's dtype's too, reported and not checked."""
    from repro_torch.models.common import tree_map
    from repro_torch.models.config import dtype_named, dtype_of
    name = LOGITS_DTYPE.get(cfg.name, cfg.dtype)
    if name == cfg.dtype:
        parity = compare_plain_path(cfg, params, image_embeds=image_embeds)
    else:
        dt, to = dtype_of(cfg), dtype_named(name)
        unchecked = compare_plain_path(cfg, params, check=False,
                                       image_embeds=image_embeds)
        parity = compare_plain_path(
            dataclasses.replace(cfg, dtype=name),
            tree_map(lambda p: p.to(to) if p.dtype == dt else p, params),
            image_embeds=None if image_embeds is None
            else image_embeds.to(to))
        parity[f"in_{cfg.dtype}_not_checked"] = unchecked
    print(f"{cfg.name} kernel vs plain path logits ({name}):",
          json.dumps(parity))
    return parity


def make_prompts(cfg):
    rng = np.random.default_rng(2)
    lens = rng.integers(32, 513, size=N_REQUESTS)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in lens]


def _counters():
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_chunk_scan as mcs
    from repro_torch.kernels import rmsnorm as rn
    return {"flash_attention": fa.flash_attention,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "decode_attention": da.decode_attention,
            "mamba_chunk_scan": mcs.mamba_chunk_scan,
            "mamba_chunk_scan_bwd": mcs.mamba_chunk_scan_bwd,
            "rmsnorm_fwd": rn.rmsnorm_fwd,
            "rmsnorm_bwd": rn.rmsnorm_bwd}


def _reset_counters():
    """Every wrapper's launch count to 0, and its counts by shape where it
    keeps them (rmsnorm's, the flash forward's)."""
    for fn in _counters().values():
        fn.launches = 0
        if hasattr(fn, "shapes"):
            fn.shapes.clear()


def _norm_widths(cfg):
    """RMSNorms per token pass by width: at d one before each mixer and
    each MLP, one after each where the layer has post-norms (gemma2), one
    inside each sLSTM block, and the final norm; at the mamba2 inner width
    (expand x d) the gated norm inside each mamba2 mixer, at the mLSTM's
    (proj_factor x d) the norm inside each mLSTM block, and at MLA's
    latent ranks its q_norm and kv_norm.  (Cross-attention's norms over
    head_dim, at other rows, are counted by ``run_vision_slice``.)"""
    count = {cfg.d_model: 1 + _n_layers(cfg, "slstm") + sum(
        ((s.kind != "none") + (s.mlp != "none")) * (1 + s.post_norms)
        * g.repeat for g in cfg.groups for s in g.pattern)}
    gated = _n_layers(cfg, "mamba2")
    if gated:
        count[cfg.mamba.expand * cfg.d_model] = gated
    inner = _n_layers(cfg, "mlstm")
    if inner:
        count[int(cfg.xlstm.proj_factor * cfg.d_model)] = inner
    mla = _n_layers(cfg, "mla")
    if mla:  # q_norm and kv_norm, at the latent ranks
        count[cfg.mla.q_lora_rank] = mla
        count[cfg.mla.kv_lora_rank] = mla
    return count


def _n_norms(cfg):
    return sum(_norm_widths(cfg).values())


def _time_calls(eng):
    """Wrap the engine's ``_call``: record, for each prefill and decode
    step, the wall time of the call on the loop thread and of its task
    function on the pool's thread (the difference is the runtime's cost
    of the call: submission, dispatch, completion, result and release)."""
    kinds = {eng._prefill: "prefill", eng._decode: "decode step"}
    calls = []
    real = eng._call

    def timed_call(fn, *args):
        inner = []

        def timed_fn(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            inner.append(time.perf_counter() - t0)
            return out

        t0 = time.perf_counter()
        out = real(timed_fn, *args)
        calls.append((kinds[fn], time.perf_counter() - t0, inner[0]))
        return out

    eng._call = timed_call
    return calls


def runtime_costs(eng, calls):
    """The runtime's cost of each call (its wall time minus its task
    function's), and each call's epoch (``EpochStats``: makespan,
    ``server_busy``), by kind of call; the epochs are the calls, in
    order.  Checks that there is one epoch a call and that nothing
    spilled."""
    rt = eng._cluster.runtime
    epochs = rt.epoch_dicts()
    if len(epochs) != len(calls) or \
            len(calls) != eng.n_prefills + eng.n_decode_steps:
        raise AssertionError(f"{len(epochs)} epochs for {len(calls)} calls, "
                             f"{eng.n_prefills} prefills and "
                             f"{eng.n_decode_steps} decode steps")
    mem = rt.memory_stats()
    if mem["spill_count"] != 0:
        raise AssertionError(f"the engine's pool spilled: {mem}")
    out = {"epochs": len(epochs), "server_busy_s": rt.server_busy,
           "spill_count": mem["spill_count"],
           "peak_store_bytes": mem["peak_worker_bytes"],
           "memory_limit": mem["memory_limit"]}
    for kind in ("prefill", "decode step"):
        idx = [i for i, c in enumerate(calls) if c[0] == kind]
        cost = np.array([calls[i][1] - calls[i][2] for i in idx]) * 1e3
        out[kind] = {
            "calls": len(idx),
            "runtime_ms_median": float(np.median(cost)),
            "runtime_ms_p95": float(np.percentile(cost, 95)),
            "call_ms_median": 1e3 * float(np.median(
                [calls[i][1] for i in idx])),
            "task_fn_ms_median": 1e3 * float(np.median(
                [calls[i][2] for i in idx])),
            "epoch_makespan_ms_median": 1e3 * float(np.median(
                [epochs[i]["makespan"] for i in idx])),
            "server_busy_ms_median": 1e3 * float(np.median(
                [epochs[i]["server_busy"] for i in idx])),
            "server_busy_ms_total": 1e3 * float(sum(
                epochs[i]["server_busy"] for i in idx))}
    return out


def trace_split(cluster, kind_of, makespan, what, card):
    """The runtime's trace of ``cluster`` (built with ``events`` and
    ``tracing`` on), through
    ``repro_torch.core.tracing``: every span complete (all six segments)
    and every ``reconcile()`` check against the runtime's own meters and
    ``makespan`` (the wall time the trace covers) ok; prints
    ``format_attribution``, the checks, and each segment's median and
    p95 in us by kind of task (``kind_of(tid)``)."""
    from repro_torch.core.tracing import (SEGMENTS, format_attribution,
                                          format_reconciliation)
    ta = cluster.trace_analysis()
    checks = ta.reconcile(cluster.runtime.run_stats(), makespan=makespan)
    print(f"{what} trace ({card}):")
    print(format_attribution(ta))
    print(format_reconciliation(checks))
    partial = [s.tid for s in ta.spans
               if s.status != "ok" or set(s.segments()) != set(SEGMENTS)]
    if any(c["ok"] is False for c in checks) or partial or not ta.spans:
        raise AssertionError(f"{what} trace: {len(ta.spans)} spans, "
                             f"partial or lost {partial[:10]}, checks "
                             f"{checks}")
    us = {}
    for sp in ta.spans:
        for seg, v in sp.segments().items():
            us.setdefault(kind_of(sp.tid), {}).setdefault(seg, []).append(
                v * 1e6)
    split = {kind: {seg: {"n": len(v), "median_us": float(np.median(v)),
                          "p95_us": float(np.percentile(v, 95))}
                    for seg, v in segs.items()}
             for kind, segs in us.items()}
    for kind, segs in split.items():
        print(f"{what} {kind}: " + "; ".join(
            f"{seg} {v['median_us']:.1f} / {v['p95_us']:.1f} us"
            for seg, v in segs.items()) + " (median / p95)")
    out = {"what": what, "spans": len(ta.spans),
           "segments_us": split, "attribution": ta.attribution(),
           "critical_path": {k: v for k, v in ta.critical_path().items()
                             if k != "path"},
           "checks": [{k: c[k] for k in ("check", "value", "reference",
                                          "ok")} for c in checks],
           "card": card}
    print(json.dumps({"trace": out}))


def serve(cfg, params, prompts, trace=False, card=None, conformance=None):
    """The engine run of one slice, through the engine's warm Cluster with
    events on, with every launch counter set to 0 just before it and read
    just after; checks each kernel's count, one epoch a prefill or decode
    step, no spill, and each request's enter, admit and exit events.  With
    ``trace``, the runtime's trace of the run (``trace_split``).  With
    ``conformance`` (a ``Conformance``), the engine's event stream is
    checked live and then offline (phase 1c (c), (d)).  An MoE
    model's calls each report their ``moe_dropped`` (``_moe_dropped``)."""
    from repro_torch.serve.engine import ServingEngine
    eng = ServingEngine(cfg, params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                        events=True, tracing=trace, device="cuda")
    label = f"{cfg.name} engine"
    if conformance:
        conformance.attach(eng.events, label)
    calls = _time_calls(eng)
    dropped = []
    _reset_counters()
    t0 = time.perf_counter()
    with _moe_dropped(dropped) if cfg.moe else contextlib.nullcontext():
        eng.start()
        reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS,
                           tenant=f"tenant-{i % 2}")
                for i, p in enumerate(prompts)]
        for r in reqs:
            if not r.done.wait(600):
                raise AssertionError(f"request {r.rid} did not finish")
        wall = time.perf_counter() - t0
        eng.stop()
    launches = {n: fn.launches for n, fn in _counters().items()}
    if conformance:
        conformance.check(label)
        conformance.offline(eng.events, label)
    runtime = runtime_costs(eng, calls)
    kinds = [c[0] for c in calls]
    counts = {k: eng.events.counts[k] for k in (
        "request-enter", "request-admit", "request-exit")}
    if counts != dict.fromkeys(counts, N_REQUESTS):
        raise AssertionError(f"{cfg.name}: request events {counts}, "
                             f"expected {N_REQUESTS} each")
    print(f"{cfg.name} through repro_torch.core.Cluster: {runtime['epochs']} "
          f"epochs = {eng.n_prefills} prefills + {eng.n_decode_steps} decode "
          f"steps, spill_count 0, request events {json.dumps(counts)}")
    rms_shapes = dict(_counters()["rmsnorm_fwd"].shapes)
    for r in reqs:
        if len(r.out_tokens) != NEW_TOKENS:
            raise AssertionError(f"request {r.rid}: {len(r.out_tokens)} "
                                 f"tokens, expected {NEW_TOKENS}")
    n_attn, n_ssd = _n_layers(cfg, "attn"), _n_layers(cfg, "mamba2")
    n_norm = _n_norms(cfg)
    want = {"flash_attention": n_attn * eng.n_prefills,
            "flash_attention_bwd": 0,
            "decode_attention": n_attn * eng.n_decode_steps,
            "mamba_chunk_scan": n_ssd * eng.n_prefills,
            "mamba_chunk_scan_bwd": 0,
            "rmsnorm_fwd": n_norm * (eng.n_prefills + eng.n_decode_steps),
            "rmsnorm_bwd": 0}
    if eng.n_prefills != N_REQUESTS or launches != want:
        raise AssertionError(
            f"{cfg.name}: launches {launches}, expected {want} for "
            f"{eng.n_prefills} prefills and {eng.n_decode_steps} decode "
            f"steps over {n_attn} attention, {n_ssd} mamba2 layers and "
            f"{n_norm} norms")
    print(f"{cfg.name} launches per prefill: flash_attention {n_attn}, "
          f"mamba_chunk_scan {n_ssd}, rmsnorm_fwd {n_norm}; per decode "
          f"step: decode_attention {n_attn}, rmsnorm_fwd {n_norm}")
    # the rmsnorm launches by the call that made them (a decode step runs
    # MAX_BATCH rows, a prefill a prompt's), and by width, as the wrapper
    # counted them
    got = {}
    for (rows, d), n in rms_shapes.items():
        call = "decode step" if rows <= MAX_BATCH else "prefill"
        key = f"rmsnorm_fwd:{call}:{d}"
        got[key] = got.get(key, 0) + n
    calls = {"prefill": eng.n_prefills, "decode step": eng.n_decode_steps}
    per_call = {f"rmsnorm_fwd:{call}:{d}": per for call in calls
                for d, per in _norm_widths(cfg).items()}
    want = {k: per * calls[k.split(":")[1]] for k, per in per_call.items()}
    if got != want:
        raise AssertionError(f"{cfg.name}: rmsnorm launches by call and "
                             f"width {got}, expected {want}")
    rms_calls = {k: (per, got[k]) for k, per in per_call.items()}
    if trace:  # one task a call, in the order of the calls
        trace_split(eng._cluster, lambda tid: kinds[tid], wall,
                    f"{cfg.name} engine", card)
    lat = np.array([r.finish_t - r.submit_t for r in reqs])
    stats = {"arch": cfg.name, "requests": N_REQUESTS,
             "prompt_lens": [len(p) for p in prompts],
             "new_tokens": NEW_TOKENS, "generated": eng.n_generated,
             "prefills": eng.n_prefills, "decode_steps": eng.n_decode_steps,
             "wall_s": wall, "tokens_per_s": eng.n_generated / wall,
             "latency_p50_s": float(np.percentile(lat, 50)),
             "latency_p95_s": float(np.percentile(lat, 95)),
             "runtime": runtime}
    if cfg.moe:
        stats["moe_dropped"] = dropped_by_call(cfg, dropped, kinds)
    return reqs, launches, rms_calls, stats


def _moe_dropped(record):
    """Patch the MoE router so that each call appends its layer's share of
    (token, k) choices that capacity dropped (a device scalar, read after
    the run) to ``record``: serving computes no ``moe_dropped`` of its
    own (``apply_moe(stats=False)``)."""
    from repro_torch.models import moe
    real = moe.route

    def route(params, cfg, xt):
        out = real(params, cfg, xt)
        record.append(1.0 - out[3].float().mean())  # out[3]: keep
        return out

    return mock.patch.object(moe, "route", route)


def dropped_by_call(cfg, record, kinds):
    """The engine calls' dropped shares (``_moe_dropped``'s record, the
    MoE layers of each call in turn; ``kinds``: each call's kind), each a
    mean over the call's MoE layers, by kind of call: mean, max and the
    share of calls that dropped any choice."""
    n_moe = sum(sum(s.mlp == "moe" for s in g.pattern) * g.repeat
                for g in cfg.groups)
    if len(record) != n_moe * len(kinds):
        raise AssertionError(f"{cfg.name}: {len(record)} MoE calls for "
                             f"{len(kinds)} engine calls of {n_moe} MoE "
                             f"layers")
    per_call = torch.stack(record).reshape(len(kinds), n_moe).mean(1).cpu()
    out = {}
    for kind in ("prefill", "decode step"):
        d = per_call[[i for i, k in enumerate(kinds) if k == kind]]
        out[kind] = {"calls": len(d), "mean": float(d.mean()),
                     "max": float(d.max()),
                     "calls_dropping": float((d > 0).float().mean())}
    return out


def _live_bytes():
    """Bytes of live tensors on the card as they were requested, once its
    queued work and Python's garbage are done.  ``memory_allocated()``
    also counts the slack of a block the allocator did not split (up to
    1 MiB a block), which moves with where a tensor lands."""
    torch.cuda.synchronize()
    gc.collect()
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def serving_memory(cfg, params, prompts, flood=FLOOD_REQUESTS):
    """Device memory stays flat across many requests: the pool's graph
    keeps every call's args until compaction (8192 tasks), so none of
    them may be a tensor made for one call.  A first wave of MAX_BATCH
    requests warms an engine; ``flood`` more (the slice's prompts in
    turn, 2 new tokens each, so most calls are prefills) must leave
    the card's live tensor bytes (``_live_bytes``) where the first wave
    left them."""
    from repro_torch.serve.engine import ServingEngine
    eng = ServingEngine(cfg, params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                        device="cuda")
    rt = eng._cluster.runtime

    def wave(n):
        reqs = [eng.submit(prompts[i % len(prompts)], max_new_tokens=2)
                for i in range(n)]
        for r in reqs:
            if not r.done.wait(600):
                raise AssertionError(f"request {r.rid} did not finish")
        # the pool's server drops a released result on its own thread
        for _ in range(1000):
            if len(rt.results) == 0 and not any(eng.active):
                break
            time.sleep(0.01)
        return _live_bytes()

    eng.start()
    try:
        first = wave(MAX_BATCH)
        after = wave(flood)
    finally:
        eng.stop()
    out = {"requests": MAX_BATCH + flood, "prefills": eng.n_prefills,
           "decode_steps": eng.n_decode_steps, "tasks": rt.g.n_rows,
           "live_bytes_after_first_wave": first, "live_bytes_after": after}
    if after != first or rt.g.tid_base != 0:
        raise AssertionError(f"{cfg.name}: device memory not flat across "
                             f"requests (or the graph compacted): {out}")
    return out


SINK_COST_RUNS = (False, True, True, False)  # sink off / on, in turns


def engine_run(cfg, params, prompts, conformance=None, label=None):
    """``serve``'s requests on a fresh engine (events on, no trace, no
    counters): its ``runtime_costs`` and tokens/s.  With ``conformance``,
    its event stream is checked live under ``label``."""
    from repro_torch.serve.engine import ServingEngine
    eng = ServingEngine(cfg, params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                        events=True, device="cuda")
    if conformance:
        conformance.attach(eng.events, label)
    calls = _time_calls(eng)
    t0 = time.perf_counter()
    eng.start()
    reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS,
                       tenant=f"tenant-{i % 2}")
            for i, p in enumerate(prompts)]
    for r in reqs:
        if not r.done.wait(600):
            raise AssertionError(f"request {r.rid} did not finish")
    wall = time.perf_counter() - t0
    eng.stop()
    if conformance:
        conformance.check(label)
    return runtime_costs(eng, calls), eng.n_generated / wall


def sink_cost(cfg, params, prompts, card, conformance):
    """The runtime's cost a call (``runtime_costs``) of ``serve``'s engine
    run without and with a conformance sink on its bus, in turns
    (``SINK_COST_RUNS``, ``engine_run``): each run's median by kind of
    call, the spread between the runs of one setting and the change of
    the sink's mean over the mean without it.  Printed, not checked: a
    host-clock comparison."""
    runs = []
    for i, on in enumerate(SINK_COST_RUNS):
        rc, _ = engine_run(cfg, params, prompts, on and conformance,
                           f"{cfg.name} engine, sink-cost run {i + 1}")
        runs.append({"sink": on, **{k: rc[k]["runtime_ms_median"]
                                    for k in ("decode step", "prefill")}})
    out = {"runs": runs, "card": card}
    for kind in ("decode step", "prefill"):
        by = {on: [r[kind] for r in runs if r["sink"] == on]
              for on in (False, True)}
        spread = max(max(v) - min(v) for v in by.values())
        change = float(np.mean(by[True]) - np.mean(by[False]))
        out[kind] = {"without_ms": by[False], "with_ms": by[True],
                     "change_ms": change, "spread_ms": spread,
                     "within_spread": abs(change) <= spread}
        print(f"{cfg.name} runtime cost a call, {kind} median without / "
              f"with the conformance sink ({card}): "
              f"{', '.join(f'{v:.4f}' for v in by[False])} / "
              f"{', '.join(f'{v:.4f}' for v in by[True])} ms; change "
              f"{change:+.4f} ms, run-to-run spread {spread:.4f} ms",
              flush=True)
    print(json.dumps({"sink_cost": out}))
    return out


def time_ms(fn, flush, iters=25, warmup=3):
    """Median device time of ``fn`` in ms over ``iters`` runs, each with a
    cold L2 (``flush`` overwrites 128 MB) and the launch queued behind a
    device-side sleep, so the events bracket device work only."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _flex_attention(qt, kt, vt, kw, lengths=None, compiled=True):
    """The library call of a row with a tanh softcap (gemma2's layers),
    which SDPA cannot take: one ``flex_attention`` call (compiled, as its
    documentation runs it) on the (B, H, S, hd) layout, with the softcap as
    its score_mod and the causal + window mask (a prefill) or the length +
    window mask (decode, ``lengths`` given) as its block mask.  The block
    mask is built here, outside the timed call.  A baseline only: the
    port never calls it."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    cap, window = kw["softcap"], kw["window"] or 0
    b, _, s, _ = qt.shape
    t = kt.shape[2]

    def score_mod(score, b_, h_, q_idx, kv_idx):
        return cap * torch.tanh(score / cap)

    if lengths is None:
        def mask_mod(b_, h_, q_idx, kv_idx):
            m = kv_idx <= q_idx
            return m & (q_idx - kv_idx < window) if window else m
        mask = create_block_mask(mask_mod, None, None, s, t,
                                 device=qt.device)
    else:
        def mask_mod(b_, h_, q_idx, kv_idx):
            n = lengths[b_]
            m = kv_idx < n
            return m & (kv_idx >= n - window) if window else m
        mask = create_block_mask(mask_mod, b, None, s, t, device=qt.device)
    # each softcapped row compiles a graph of its own; past dynamo's
    # default limit of 8 recompilations a call would run eagerly, and time
    # a materialised (S, T) score matrix
    import torch._dynamo
    torch._dynamo.config.recompile_limit = 64
    fn = (torch.compile(flex_attention, dynamic=False) if compiled
          else flex_attention)
    return lambda: fn(qt, kt, vt, score_mod=score_mod, block_mask=mask,
                      scale=kw["scale"], enable_gqa=True)


def _flash_row(q, k, v, kw, err):
    """Operations: 4 hd FLOPs a live (query, key) pair: causal with
    q_offset 0 and S == T, each row's window (where set) counted; or
    every (query, key) pair, non-causal without a window (cross-attention,
    S queries against T keys)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if kw["causal"]:
        w = min(kw["window"] or s, s)
        pairs = w * (w + 1) // 2 + (s - w) * w
    else:
        assert not kw["window"]
        pairs = s * t
    return dict(
        name="flash_attention",
        shape=[b, s, h, kv, hd] + ([] if t == s else [t]), err=err,
        flops=4 * hd * pairs * b * h,
        nbytes=q.element_size() * (2 * q.numel() + k.numel() + v.numel()),
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:114",
        kernel=lambda: fa.flash_attention(q, k, v, **kw),
        plain=lambda: ref.flash_attention(q, k, v, **kw),
        library=_flex_attention(qt, kt, vt, kw) if kw["softcap"] else (
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=kw["causal"], scale=kw["scale"],
                enable_gqa=True)),
        library_call="flex_attention" if kw["softcap"] else "sdpa")


def _decode_row(q, k, v, kw, err, n_split):
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    b, _, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    lengths = kw["lengths"]
    # cache rows the step must read: the last ``window`` of each sequence
    live = int(lengths.clamp(max=kw["window"] or t).sum())
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = (torch.arange(t, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    return dict(
        name="decode_attention", shape=[b, t, h, kv, hd], err=err,
        n_split=n_split,
        flops=4 * hd * h * live,
        nbytes=q.element_size() * (2 * q.numel() + 2 * live * kv * hd)
        + lengths.numel() * 4,
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:108",
        kernel=lambda: da.decode_attention(q, k, v, **kw),
        plain=lambda: ref.decode_attention(q, k, v, **kw),
        library=_flex_attention(qt, kt, vt, kw, lengths)
        if kw["softcap"] else (
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=kw["scale"],
                enable_gqa=True)),
        library_call="flex_attention" if kw["softcap"] else "sdpa")


def _ssd_row(args, h0, err):
    """Bytes: x, dt, a, b, c, d and h0 read once, y and h_final written
    once.  Operations: the multiply-adds of the chunked SSD at the
    kernel's chunk length, each 2 FLOPs: C B^T once per (batch, chunk) over
    the causal pairs, and per (batch, head, chunk) W x over the causal
    pairs, C H^T and the state update; at the bf16 tensor-core rate, the
    type of x, b and c."""
    from repro_torch.kernels import mamba_chunk_scan as mcs
    from repro_torch.kernels import ref
    x, dt, a, bm, cm, d = args
    b, s, nh, hd = x.shape
    ns = bm.shape[-1]
    macs = 0
    for t0 in range(0, s, SSD_CHUNK):
        n = min(SSD_CHUNK, s - t0)
        pairs = n * (n + 1) // 2
        macs += b * (pairs * ns + nh * (pairs * hd + 2 * n * hd * ns))
    h = 2 * h0.numel() * 4 if h0 is not None else b * nh * hd * ns * 4
    nbytes = (sum(t.numel() * t.element_size() for t in args)
              + x.numel() * x.element_size() + h)
    return dict(
        name="mamba_chunk_scan", shape=[b, s, nh, hd, ns], err=err,
        flops=2 * macs, nbytes=nbytes,
        source="src/repro_torch/kernels/csrc/mamba_chunk_scan.cu",
        replaces="src/repro/kernels/mamba_chunk_scan.py:83",
        plain_iters=3,  # sequential: S steps, 0.2-1.3 s a call
        kernel=lambda: mcs.mamba_chunk_scan(*args, h0=h0),
        plain=lambda: ref.mamba_chunk_scan(*args, h0=h0),
        library=None)  # no single PyTorch call computes the SSD


def _ssd_bwd_row(args, h0, err):
    """Bytes: x, dt, a, b, c, d, dy, dh_final and h0 read once; dx, ddt,
    da, db, dc, dd and dh0 written once.  Operations: the multiply-adds of
    the chunked backward at 64-row chunks, each 2 FLOPs: C B^T once per
    (batch, chunk) over the causal pairs; per (batch, head, chunk) dy x^T,
    W^T dy, Pd^T C and Pd B over the causal pairs and B dH^T, x dH,
    dy H_in and the update of dH over all rows (the kernel also recomputes
    the chunk states, which the count leaves out); at the bf16
    tensor-core rate, the type of x, b, c and dy."""
    from repro_torch.kernels import mamba_chunk_scan as mcs
    from repro_torch.kernels import ref
    x, dt, a, bm, cm, d, dy, dhf = args
    b, s, nh, hd = x.shape
    ns = bm.shape[-1]
    macs = 0
    for t0 in range(0, s, SSD_CHUNK):
        n = min(SSD_CHUNK, s - t0)
        pairs = n * (n + 1) // 2
        macs += b * (pairs * ns + nh * (2 * pairs * (hd + ns)
                                        + 4 * n * hd * ns))
    h = 0 if h0 is None else 2 * h0.numel() * 4
    nbytes = 2 * sum(t.numel() * t.element_size() for t in args[:6]) \
        + dy.numel() * dy.element_size() + h \
        + (0 if dhf is None else dhf.numel() * 4)
    return dict(
        name="mamba_chunk_scan_bwd", shape=[b, s, nh, hd, ns], err=err,
        flops=2 * macs, nbytes=nbytes,
        source="src/repro_torch/kernels/csrc/mamba_chunk_scan_bwd.cu",
        replaces="src/repro/kernels/mamba_chunk_scan.py:83",
        note="the Pallas kernel is forward-only; JAX differentiates its "
             "jnp chunked scan (repro/models/mamba2.py::_ssd_chunked); "
             "this is the gradient of _ssd_kernel",
        plain_iters=3,  # the plain backward: ~2 s a call at the training shape
        kernel=lambda: mcs.mamba_chunk_scan_bwd(*args, h0=h0),
        plain=lambda: ref.mamba_chunk_scan_bwd(*args, h0=h0),
        library=None)  # no PyTorch call computes the SSD's gradient


def _rms_fwd_row(args, err, with_rstd):
    """Bytes: x and scale read, y written, and the fp32 rstd where the
    timed call writes it (the training form; serving writes none).
    Operations: ~4 a element (square-add, two scalings, the 1 + scale)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    x, scale = args
    d = x.shape[-1]
    w = 1 + scale
    return dict(
        name="rmsnorm_fwd", shape=list(x.shape), err=err,
        flops=4 * x.numel(),
        nbytes=2 * x.numel() * x.element_size() + scale.numel()
        * scale.element_size() + 4 * (x.numel() // d) * with_rstd,
        source="src/repro_torch/kernels/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:37", with_rstd=with_rstd,
        plan=list(rn.launch_shape(x.numel() // d, d, x.dtype)),
        kernel=lambda: rn.rmsnorm_fwd(x, scale, with_rstd=with_rstd),
        plain=lambda: ref.rmsnorm(x, scale),
        library=lambda: torch.nn.functional.rms_norm(x, (d,), w, 1e-6))


def _rms_bwd_row(args, err):
    """Bytes: x, g, scale and rstd read, dx and dscale written.
    Operations: ~8 a element.  The library call is the autograd backward
    of ``F.rms_norm``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    x, scale, rstd, g = args
    d = x.shape[-1]
    xr = x.detach().requires_grad_(True)
    wr = (1 + scale).detach().requires_grad_(True)
    y = torch.nn.functional.rms_norm(xr, (d,), wr, 1e-6)
    return dict(
        name="rmsnorm_bwd", shape=list(x.shape), err=err,
        flops=8 * x.numel(),
        nbytes=3 * x.numel() * x.element_size() + 2 * scale.numel()
        * scale.element_size() + 4 * rstd.numel(),
        source="src/repro_torch/kernels/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:37",
        note="the Pallas kernel is forward-only; JAX differentiates its "
             "jnp oracle",
        plan=list(rn.launch_shape(x.numel() // d, d, x.dtype,
                                  backward=True)),
        kernel=lambda: rn.rmsnorm_bwd(x, scale, rstd, g),
        plain=lambda: ref.rmsnorm_bwd(x, scale, g),
        library=lambda: torch.autograd.grad(y, (xr, wr), g,
                                            retain_graph=True))


def _flash_bwd_row(args, kw, err):
    """Bytes: q, k, v, o, dO and the fp32 LSE read once, dq, dk, dv
    written once.  Operations: 5 products of 2 hd FLOPs a live pair
    (q_offset 0, S == T: causal with each row's window counted, or every
    pair).  The library call is the autograd backward of SDPA, or of a
    compiled ``flex_attention`` where softcapped (``_flex_attention``)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    q, k, v, o, lse, do = args
    b, s, h, hd = q.shape
    kv = k.shape[2]
    if kw["causal"]:
        w = min(kw["window"] or s, s)
        pairs = w * (w + 1) // 2 + (s - w) * w
    else:
        assert not kw["window"]
        pairs = s * s
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    if kw["softcap"]:
        out = _flex_attention(qt, kt, vt, kw)()
    else:
        out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=kw["causal"], scale=kw["scale"],
            enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    products = 8 if hd > 128 else 7
    return dict(
        name="flash_attention_bwd", shape=[b, s, h, kv, hd], err=err,
        flops=10 * hd * pairs * b * h,
        nbytes=q.element_size() * (4 * q.numel() + 4 * k.numel())
        + 4 * lse.numel(),
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention.py:114",
        note="no Pallas counterpart: the JAX package differentiates its "
             "jnp oracle; this is the gradient of _fa_kernel; its passes "
             f"compute S and dP more than once, {products} products a pair "
             "against the bound's 5",
        kernel=lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, **kw),
        plain=lambda: ref.flash_attention_bwd(q, k, v, o, lse, do, **kw),
        library=lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                            retain_graph=True),
        library_call="flex_attention backward" if kw["softcap"]
        else "sdpa backward")


def kernel_numbers(inputs, launches, rms_calls, card):
    """Times of each kernel at each slice's shapes, beside its plain
    version, the PyTorch library call and the card's bound.  An rmsnorm
    row's launches are its call's (``rms_calls``); its serving forward is
    timed as serving calls it, without rstd."""
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")
    make = {"flash": _flash_row, "decode": _decode_row, "ssd": _ssd_row,
            "ssd_bwd": _ssd_bwd_row, "rms_fwd": _rms_fwd_row,
            "rms_bwd": _rms_bwd_row, "flash_bwd": _flash_bwd_row}
    out = []
    for key, inp in inputs.items():
        t_row = time.perf_counter()
        kind, arch, *call = key.split(":")
        inp = _to(inp, "cuda")
        extra = {}
        if kind == "rms_fwd":
            inp = (*inp, call[0].startswith(TRAINING_CALLS))
        r = make[kind](*inp)
        if arch in WIDE_KEYS.values() and kind in ("flash", "flash_bwd"):
            # the plain attention at a wide training cell's shape: 7 to
            # 145 ms a call, its (B, H, S, T) scores materialised
            r.setdefault("plain_iters", WIDE_PLAIN_ITERS)
        # a call's own count where the slice counts by call (the VLM's
        # self- and cross-attention flash), else the slice's
        n = launches[arch].get(":".join([r["name"], *call]),
                               launches[arch][r["name"]])
        if call and not kind.startswith("rms"):
            extra = {"call": call[0]}
        if kind.startswith("rms"):
            per, n = rms_calls[arch][f"{r['name']}:{call[0]}:"
                                     f"{r['shape'][-1]}"]
            extra = {"call": call[0], "per_call": per}
        ms = time_ms(r["kernel"], flush)
        # a plain version timed over a few runs (a sequential loop of
        # 0.2-2 s a call) is warmed up once
        plain_ms = time_ms(r["plain"], flush,
                           iters=r.get("plain_iters", 25),
                           warmup=1 if r.get("plain_iters", 25) <= 3 else 3)
        library_ms = (None if r["library"] is None
                      else time_ms(r["library"], flush))
        if "library_call" in r:  # the library's attention, (B, H, S, hd)
            lib, plain = r["library"](), r["plain"]()
            if isinstance(plain, torch.Tensor):  # a forward: one output
                lib, plain = (lib,), (plain,)
            extra["library_max_abs_err"] = max(
                float((a.transpose(1, 2).float() - b.float()).abs().max())
                for a, b in zip(lib, plain))
            del lib, plain
        t_ops, t_bytes = r["flops"] / PEAK_FLOPS, r["nbytes"] / PEAK_BYTES
        out.append({
            "name": r["name"], "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": n,
            "max_abs_err": r["err"], "ms": ms, "kernel_ms": ms,
            "plain_ms": plain_ms, "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, "path": arch, "shape": r["shape"],
            "dtype": "bfloat16", "flops": r["flops"], "bytes": r["nbytes"],
            "card": card, **extra,
            **{k: r[k] for k in ("n_split", "note", "plan", "with_rstd",
                                 "plain_iters", "library_call") if k in r}})
        print(f"phase 4 row {key}: {time.perf_counter() - t_row:.1f} s",
              flush=True)
    return out


def rmsnorm_times(root):
    """The rmsnorm kernels of the checkout at ``root`` (already on
    ``sys.path``), timed as its paths call them, beside ``F.rms_norm`` (the
    forward, or its autograd backward) on the same bf16 inputs: the
    serving forward through ``ops.rmsnorm`` without grad at every width of
    ``RMS_CALLS`` and every count of ``RMS_TIMED_ROWS``, the training
    forward (with rstd) and backward at the training shape, each with a
    cold L2 (``ms``) and with its inputs left in L2 by the runs before
    (``warm_ms``, as a norm reads the tensor the kernel before it wrote).
    Prints one JSON line a timing, each with the card, and last two
    yardsticks
    timed the same way: a ``zero_()`` of 8 floats (the least this timer
    reads) and a ``copy_`` of the training forward's x into y (its bytes
    moved by a library kernel)."""
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import rmsnorm as rn
    if not Path(rn.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {rn.__file__}, not {root}'s")
    build.load(rn.NAME)
    card = _card()
    print(card)
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")
    warm = torch.empty(1, device="cuda")  # a flush that leaves L2 warm
    rng = np.random.default_rng(0)

    def randn(*shape):
        a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return a.to(torch.bfloat16).cuda()

    def row(kernel, call, x, fn, library):
        print(json.dumps({
            "kernel": kernel, "call": call, "shape": list(x.shape),
            "dtype": "bfloat16", "ms": time_ms(fn, flush),
            "warm_ms": time_ms(fn, warm),
            "library_ms": time_ms(library, flush), "root": str(root),
            "card": card}), flush=True)

    widths = sorted({d for _, _, _, ds in RMS_CALLS for d in ds})
    with torch.no_grad():
        for d in widths:
            for n in RMS_TIMED_ROWS:
                x, scale = randn(n, d), randn(d) * 0.1
                w = 1 + scale
                row("rmsnorm_fwd", "serving", x,
                    lambda: ops.rmsnorm(x, scale),
                    lambda: torch.nn.functional.rms_norm(x, (d,), w, 1e-6))
    (_, call, n, (d,)), = [c for c in RMS_CALLS if c[0] == TRAIN_KEY]
    x, scale, g = randn(n, d), randn(d) * 0.1, randn(n, d)
    w = 1 + scale
    row("rmsnorm_fwd", call, x, lambda: rn.rmsnorm_fwd(x, scale),
        lambda: torch.nn.functional.rms_norm(x, (d,), w, 1e-6))
    _, rstd = rn.rmsnorm_fwd(x, scale)
    xr = x.detach().requires_grad_(True)
    wr = w.detach().requires_grad_(True)
    y = torch.nn.functional.rms_norm(xr, (d,), wr, 1e-6)
    row("rmsnorm_bwd", call, x, lambda: rn.rmsnorm_bwd(x, scale, rstd, g),
        lambda: torch.autograd.grad(y, (xr, wr), g, retain_graph=True))
    z, out = torch.zeros(8, device="cuda"), torch.empty_like(x)
    print(json.dumps({"yardsticks": {
        "zero_8_floats_ms": time_ms(z.zero_, flush),
        f"copy_{n}x{d}_bf16_ms": time_ms(lambda: out.copy_(x), flush)},
        "root": str(root), "card": card}), flush=True)


SSD_TIMED = [  # (call, (b, s, nh, hd, ns), with h0): zamba2's SSD calls
    ("training step", (TRAIN_BATCH, TRAIN_SEQ, 80, 64, 64), False),
    ("prefill", (1, max(PREFILL_LENS), 80, 64, 64), True)]


def ssd_times(root):
    """The SSD forward and backward kernels of the checkout at ``root``
    (already on ``sys.path``), timed (cold L2, ``time_ms``) at zamba2's
    training and serving shapes in bf16; the backward also split by kernel
    (``torch.profiler``, device time a call).  Prints one JSON line a
    timing, each with the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build
    from repro_torch.kernels import mamba_chunk_scan as mcs
    if not Path(mcs.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {mcs.__file__}, not {root}'s")
    build.load(mcs.NAME)
    build.load(mcs.BWD_NAME)
    card = _card()
    print(card)
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(0)

    def by_kernel(fn, n=5):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return {e.key[:60]: e.self_device_time_total / 1e3 / n
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA}

    def row(kernel, call, shape, fn, **extra):
        print(json.dumps({
            "kernel": kernel, "call": call, "shape": list(shape),
            "dtype": "bfloat16", "ms": time_ms(fn, flush), **extra,
            "root": str(root), "card": card}), flush=True)

    with torch.no_grad():
        for call, shape, with_h0 in SSD_TIMED:
            b, s, nh, hd, ns = shape
            args = _ssd_inputs(rng, *shape, torch.bfloat16)
            h0 = _randn(rng, (b, nh, hd, ns), torch.float32) if with_h0 \
                else None
            dy = _randn(rng, (b, s, nh, hd), torch.bfloat16)
            dhf = _randn(rng, (b, nh, hd, ns), torch.float32)
            row("mamba_chunk_scan", call, shape,
                lambda: mcs.mamba_chunk_scan(*args, h0=h0))
            bwd = (lambda: mcs.mamba_chunk_scan_bwd(  # noqa: E731
                *args, dy, dhf, h0=h0))
            row("mamba_chunk_scan_bwd", call, shape, bwd,
                by_kernel=by_kernel(bwd))


# rows of --flash-bwd-times: the bf16 flash backward at the training
# cells' shapes, (b, s, h, kv, hd, causal, window, cap, scale) with T = S:
# head dim 64 (llama3.2-1b, musicgen-medium), 80 (zamba2-2.7b), 128
# (deepseek-coder-33b, grok-1-314b, the VLM's self- and cross-attention,
# gemma2-27b's local and global layers) and 256 (gemma-7b)
FLASH_BWD_TIMED = [
    (4, 2048, 32, 8, 64, True, None, None, 64 ** -0.5),
    (4, 2048, 24, 24, 64, True, None, None, 64 ** -0.5),
    (4, 2048, 32, 32, 80, True, None, None, 80 ** -0.5),
    (4, 2048, 56, 8, 128, True, None, None, 128 ** -0.5),
    (4, 2048, 48, 8, 128, True, None, 30.0, 128 ** -0.5),
    (4, 2048, 64, 8, 128, True, None, None, 128 ** -0.5),
    (4, 2048, 64, 8, 128, False, None, None, 128 ** -0.5),
    (1, 8192, 32, 16, 128, True, 4096, 50.0, 1 / 12),
    (1, 8192, 32, 16, 128, True, None, 50.0, 1 / 12),
    (4, 2048, 16, 16, 256, True, None, None, 256 ** -0.5)]


def flash_bwd_times(root):
    """The bf16 flash backward of the checkout at ``root`` (already on
    ``sys.path``), timed (cold L2, ``time_ms``) at ``FLASH_BWD_TIMED``,
    from the plain forward's output and log-sum-exp; a head dim the
    checkout's backward is not built for (``build.BWD_HEAD_DIMS`` where a
    checkout has it) is skipped.  Prints one JSON line a timing, each with
    the card."""
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as fa
    if not Path(fa.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {fa.__file__}, not {root}'s")
    build.load(fa.BWD_NAME)
    card = _card()
    print(card)
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(0)
    built = getattr(build, "BWD_HEAD_DIMS", build.HEAD_DIMS)
    with torch.no_grad():
        for b, s, h, kv, hd, causal, window, cap, scale in FLASH_BWD_TIMED:
            if hd not in built:
                continue
            q, do = (_randn(rng, (b, s, h, hd), torch.bfloat16)
                     for _ in range(2))
            k, v = (_randn(rng, (b, s, kv, hd), torch.bfloat16)
                    for _ in range(2))
            kw = dict(causal=causal, window=window, softcap=cap,
                      scale=scale)
            o, lse = (x.contiguous()
                      for x in ref.flash_attention_fwd(q, k, v, **kw))
            ms = time_ms(lambda: fa.flash_attention_bwd(  # noqa: B023
                q, k, v, o, lse, do, **kw), flush)
            print(json.dumps({
                "kernel": "flash_attention_bwd",
                "shape": [b, s, h, kv, hd], "causal": causal,
                "window": window, "softcap": cap, "dtype": "bfloat16",
                "ms": ms, "root": str(root), "card": card}), flush=True)
            del q, k, v, o, lse, do


def serving_runtime(root):
    """The llama3.2-1b serving run of ``serve`` (its 16 requests on a fresh
    engine, events on, ``engine_run``) through the engine of the checkout
    at ``root`` (already on ``sys.path``); prints its ``runtime_costs``
    and tokens/s as one JSON line, with the card."""
    from repro_torch.kernels import build
    from repro_torch.models import model as model_lib
    from repro_torch.serve import engine as engine_lib
    if not Path(engine_lib.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {engine_lib.__file__}, not {root}'s")
    build.build_all()
    card = _card()
    cfg = published_config(*SLICES[0])
    with torch.inference_mode():
        params = model_lib.init_params(
            torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    costs, tokens_per_s = engine_run(cfg, params, make_prompts(cfg))
    print(json.dumps({"serving_runtime": costs, "tokens_per_s": tokens_per_s,
                      "root": str(root), "card": card}), flush=True)


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _category(kernel_name):
    """A device kernel's category by its name.  Past the port's kernels
    and the matmuls, the names that PyTorch gives the MoE routing (top-k,
    sort, cumulative sum) and the index ops (the MoE dispatch and combine,
    the cache writes, the embedding lookup), and softmax (MLA's attention
    and the routers), are split out of "other"."""
    n = kernel_name.lower()
    if "flash_fwd_kernel" in n or "flash_bwd" in n or "decode_kernel" in n:
        return "attention_kernels"
    if "ssd_kernel" in n:
        return "ssd_kernel"
    if "ssd_bwd" in n:
        return "ssd_bwd_kernels"
    if "rms_" in n:
        return "rmsnorm_kernels"
    if any(w in n for w in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
        return "matmul"
    if any(w in n for w in ("topk", "sort", "scan")):
        return "topk_sort_scan"
    if any(w in n for w in ("index", "scatter", "gather")):
        return "index_scatter_gather"
    if "softmax" in n:
        return "softmax"
    return "other"


def _device_kernels(prof):
    """{kernel name: [device ms, launches]} of a profile's device events,
    read from the profiler's raw events: a training step of xlstm-350m
    launches ~580k kernels, and ``key_averages()`` first builds a Python
    object for every event (~2 minutes for that step)."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ms_n = out.setdefault(e.name(), [0.0, 0])
            ms_n[0] += e.duration_ns() / 1e6
            ms_n[1] += 1
    return out


def _device_split(prof, n=1):
    """Device ms by kernel category, launches and the top kernels' ms of a
    profile over ``n`` calls, each a call."""
    kernels = _device_kernels(prof)
    by_cat = {}
    for name, (ms, _) in kernels.items():
        cat = _category(name)
        by_cat[cat] = by_cat.get(cat, 0.0) + ms / n
    top = sorted(kernels, key=lambda k: -kernels[k][0])[:6]
    return (by_cat, sum(c for _, c in kernels.values()) / n,
            {k[:150]: kernels[k][0] / n for k in top})


def profile_slice(cfg, params, card, image_embeds=None):
    """Where the time of one decode step (8 slots, ~300 cached positions)
    and one 512-token prefill (with a VLM's ``image_embeds`` of one
    sequence) goes: host wall time, device busy time by kernel category
    (torch.profiler), and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model as model_lib
    rng = np.random.default_rng(3)
    cache = model_lib.init_cache(cfg, MAX_BATCH, MAX_LEN, device="cuda")
    one = model_lib.init_cache(cfg, 1, MAX_LEN, device="cuda")
    tokens = torch.from_numpy(_token_array(rng, cfg, MAX_BATCH, 1)).cuda()
    prompt = torch.from_numpy(_token_array(rng, cfg, 1, 512)).cuda()
    pos = torch.full((MAX_BATCH,), 300, dtype=torch.int32, device="cuda")

    def decode():
        logits, _ = model_lib.decode_step(params, cfg, tokens, cache, pos)
        torch.argmax(logits[:, 0], dim=-1).cpu()

    def prefill():
        model_lib.prefill(params, cfg, prompt, one, image_embeds)
        torch.cuda.synchronize()

    out = {"arch": cfg.name}
    for name, fn, n in (("decode_step_b8", decode, 20),
                        ("prefill_s512", prefill, 5)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
        by_cat, launches, top = _device_split(prof, n)
        busy = sum(by_cat.values())
        out[name] = {
            "wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall_ms,
            "device_ms_by_category": by_cat,
            "kernel_launches": launches, "top_kernels_ms": top}
    out["card"] = card
    return out


def _widths(arch):
    """The published widths of ``arch`` in ``SLICES``."""
    return next(w for a, w, _ in SLICES if a == arch)


def published_config(arch, widths, layers=None):
    """The port's config of ``arch``, asserted at its published widths; with
    ``layers``, its depth cut to that many layers (whole repeats of its one
    group's pattern), or, for a config of several groups, to a tuple of
    each group's layers, every width kept."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    mc = cfg.mamba
    got = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.dtype,
           None if mc is None else (mc.d_state, mc.d_conv, mc.expand,
                                    mc.head_dim, mc.chunk))
    if got != widths:
        raise AssertionError(f"{arch} is not at its published width: {got}")
    print(f"{arch} at its published width: layers {got[0]}, d {got[1]}, "
          f"heads {got[2]}/{got[3]}, head_dim {got[4]}, d_ff {got[5]}, "
          f"vocab {got[6]}, {got[7]}, mamba {got[8]}"
          + (f", xlstm {cfg.xlstm}" if cfg.xlstm else "")
          + (f", {cfg.num_codebooks} codebooks" if cfg.num_codebooks
             else "")
          + (f", {cfg.moe}" if cfg.moe else "")
          + (f", {cfg.mla}" if cfg.mla else "")
          + (f", vision_dim {cfg.vision_dim}, {cfg.num_image_tokens} image "
             f"tokens" if cfg.vision_dim else ""))
    if arch in PUBLISHED_PARAMS:
        n = cfg.param_count()
        if n != PUBLISHED_PARAMS[arch]:
            raise AssertionError(f"{arch}: param_count() {n}, the JAX "
                                 f"package's {PUBLISHED_PARAMS[arch]}")
        print(f"{arch}: param_count() {n}, the JAX package's count")
    if layers is not None:
        cuts = layers if isinstance(layers, tuple) else (layers,)
        if len(cuts) != len(cfg.groups):
            raise AssertionError(f"{arch}: {len(cfg.groups)} groups, cut "
                                 f"to {layers}")
        groups = []
        for group, n in zip(cfg.groups, cuts):
            reps, rest = divmod(n, len(group.pattern))
            if rest or not 0 < reps <= group.repeat:
                raise AssertionError(f"{arch}: cannot cut a group of "
                                     f"{len(group.pattern) * group.repeat} "
                                     f"layers to {n}")
            groups.append(dataclasses.replace(group, repeat=reps))
            print(f"{arch}: a group cut to {reps} of its {group.repeat} "
                  f"repeats of its {len(group.pattern)}-layer pattern")
        cfg = dataclasses.replace(cfg, groups=tuple(groups))
        print(f"{arch}: depth cut from {got[0]} to {cfg.num_layers} layers, "
              f"every width as published")
    return cfg


def absorbed_parity(arch, widths):
    """MLA's absorbed-vs-naive logits (``compare_absorbed``), checked in
    fp32 on a model of its own at ``ABSORBED_CUT[arch]`` layers (the bf16
    slice's model and an fp32 copy do not fit the card together): in bf16
    the two forms round apart, and the router choices that flip with the
    rounding carry the gap past LOGITS_REL_TOL (the bf16 figures, beside
    the gap with the choices pinned, are ``moe_parity``'s)."""
    from repro_torch.models import model as model_lib
    cfg = dataclasses.replace(published_config(arch, widths,
                                               ABSORBED_CUT[arch]),
                              dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        params = model_lib.init_params(gen, cfg, "cuda")
        _nonzero_router_bias(params, gen)
        out = {"layers": cfg.num_layers,
               "absorbed_vs_naive": compare_absorbed(cfg, params)}
    print(f"{arch} at {cfg.num_layers} layers in float32:", json.dumps(out))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_parity(cfg, params, absorbed_checked):
    """An MoE slice's bf16 logits: kernel vs plain path, checked; for MLA
    absorbed vs naive, checked only where ``absorbed_checked`` (else it
    is checked in fp32, ``absorbed_parity``).  Each gives the share of
    router choices that differ and the gap with them pinned."""
    out = {"kernel_vs_plain": compare_plain_path(cfg, params)}
    if cfg.mla:
        out["absorbed_vs_naive"] = compare_absorbed(
            cfg, params, check=absorbed_checked)
    print(f"{cfg.name} logits ({cfg.dtype}):", json.dumps(out))
    return out


def run_slice(arch, widths, layers, card, conformance=None):
    """Phase 3 for one slice (its depth cut to ``layers`` where that is not
    None); returns its engine-run launch counts, and its rmsnorm launches
    by call and width ("rmsnorm_fwd:<call>:<d>": (norms per call,
    launches)).  An MoE slice holds a one-slot engine to a one-row
    reference (``greedy_reference(batch=1)``), and reports how many of the
    8-slot run's requests equal their one-slot generation, beside its
    dropped shares: batchmates compete for the experts' capacity.  With
    ``conformance``, llama3.2-1b's engine stream is checked (``serve``) and
    its runtime cost a call measured without and with the sink
    (``sink_cost``)."""
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import tree_map
    moe = arch in MOE_ARCHS
    cut = absorbed_parity(arch, widths) if arch in ABSORBED_CUT else None
    cfg = published_config(arch, widths, layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        params = model_lib.init_params(gen, cfg, device="cuda")
        if moe:
            _nonzero_router_bias(params, gen)
        leaves = []
        tree_map(leaves.append, params)
        n_params = sum(p.numel() for p in leaves)
        print(f"{arch}: {n_params} params, {cfg.dtype}, on "
              f"{torch.cuda.get_device_name(0)}")
        if moe:
            parity = moe_parity(cfg, params, absorbed_checked=cut is None)
            if cut is not None:
                parity["float32_cut"] = cut
        else:
            parity = logits_parity(cfg, params)
        prompts = make_prompts(cfg)
        picks = (0, N_REQUESTS - 1)  # slot 0 first, then a reused slot
        if moe:
            solo = solo_generations(cfg, params, prompts)
            for i in picks:
                want = greedy_reference(cfg, params, prompts[i], batch=1)
                if solo[i] != want:
                    raise AssertionError(f"{arch} request {i}: one-slot "
                                         f"engine {solo[i]} != one-row "
                                         f"reference {want}")
            print(f"{arch} requests {picks}: a one-slot engine's tokens "
                  f"equal the one-row greedy reference")
        else:
            want = {i: greedy_reference(cfg, params, prompts[i])
                    for i in picks}
    reqs, launches, rms_calls, stats = serve(
        cfg, params, prompts, trace=arch == TRAIN_ARCH, card=card,
        conformance=conformance if arch == TRAIN_ARCH else None)
    if conformance and arch == TRAIN_ARCH:
        stats["sink_cost"] = sink_cost(cfg, params, prompts, card,
                                       conformance)
    if moe:
        same = [i for i, r in enumerate(reqs) if r.out_tokens == solo[i]]
        stats["equal_to_solo"] = len(same)
        print(f"{arch}: {len(same)} of {N_REQUESTS} requests of the "
              f"{MAX_BATCH}-slot run equal their one-slot generation "
              f"(not checked: a decode step's rows share the experts' "
              f"capacity); dropped shares by call: "
              f"{json.dumps(stats['moe_dropped'])}")
    else:
        for i in picks:
            if reqs[i].out_tokens != want[i]:
                raise AssertionError(f"{arch} request {i}: engine "
                                     f"{reqs[i].out_tokens} != reference "
                                     f"{want[i]}")
        print(f"{arch} requests {picks}: engine tokens equal the "
              f"one-request greedy reference")
    flood = FLOOD.get(arch, FLOOD_REQUESTS)
    memory = serving_memory(cfg, params, prompts, flood)
    print(f"{arch} device memory flat across {memory['requests']} requests "
          f"(a first wave of {MAX_BATCH}, then a flood of {flood}; "
          f"{memory['prefills']} prefills, {memory['decode_steps']} decode "
          f"steps, {memory['tasks']} tasks in the pool's graph): "
          f"{memory['live_bytes_after']} live tensor bytes")
    print(f"{arch} launches over the engine run:", json.dumps(launches))
    stats.update(card=card, n_params=n_params, parity=parity,
                 memory=memory)
    rc = stats["runtime"]
    print(f"{arch} runtime cost a call (wall of _call minus its task "
          f"function; {card}): " + "; ".join(
              f"{k} median {rc[k]['runtime_ms_median']:.4f} ms, p95 "
              f"{rc[k]['runtime_ms_p95']:.4f} ms over {rc[k]['calls']}"
              for k in ("decode step", "prefill"))
          + f"; server_busy {rc['server_busy_s']:.4f} s over "
          f"{rc['epochs']} epochs")
    print(json.dumps({"slice": stats}))
    with torch.inference_mode():
        print(json.dumps({"profile": profile_slice(cfg, params, card)}))
    del params, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rms_calls


def _nonzero_router_bias(params, gen):
    """deepseek-v3's router biases (zeros at init; they move the selection
    only) set to N(0, 0.1^2) draws from ``gen``, so that the bias is at
    work in every check of the slice."""
    for group in params["groups"]:
        for slot in group["slots"]:
            router = slot.get("mlp", {}).get("router", {})
            if "bias" in router:
                b = router["bias"]
                b.copy_(torch.randn(b.shape, generator=gen,
                                    device=b.device) * 0.1)


def generate_codes(cfg, params, prompts, image_embeds=None):
    """Greedy generation for a batch of prompts, (B, S, K) codes of a
    multi-codebook model or (B, S) tokens (with a VLM's image embeddings):
    one prefill of the batch into a cache of MAX_LEN positions, then
    NEW_TOKENS decode steps, each codebook's token its own argmax.
    Returns the (B, 1 + NEW_TOKENS[, K]) codes on the host (the first from
    the prefill's logits) and the seconds of the prefill and of the decode
    steps, each to a sync."""
    from repro_torch.models import model as model_lib
    b, s = prompts.shape[:2]
    cache = model_lib.init_cache(cfg, b, MAX_LEN, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model_lib.prefill(
        params, cfg, torch.from_numpy(prompts).cuda(), cache, image_embeds)
    cur = torch.argmax(logits, dim=-1)                    # (B, 1, K)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out, pos = [cur], torch.full((b,), s, dtype=torch.int32, device="cuda")
    for _ in range(NEW_TOKENS):
        logits, cache = model_lib.decode_step(params, cfg, cur, cache, pos)
        cur = torch.argmax(logits, dim=-1)
        out.append(cur)
        pos += 1
    codes = torch.cat(out, dim=1).cpu()
    return codes, t1 - t0, time.perf_counter() - t1


def run_codebook_slice(arch, widths, card):
    """Phase 3 for musicgen-medium, which the engine refuses (as the JAX
    engine, whose requests carry one token stream): MAX_BATCH prompts of
    MUSIC_PROMPT frames x 4 codebooks prefilled as one batch, then
    NEW_TOKENS greedy decode steps (``generate_codes``), with every launch
    counter set to 0 just before and read just after: one flash a layer
    for the prefill, one decode a layer a step, the norms of a pass at the
    prefill's and the steps' rows.  The first and last prompts generated
    alone (row 0 of a batch whose other rows are zero, so every bf16
    product sees the batched run's shapes) give the batched run's codes;
    kernel-path logits agree with the plain path; a profile of one decode
    step and one 512-frame prefill.  Returns the launch counts and the
    rmsnorm launches by call and width, as ``run_slice``."""
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import tree_leaves
    cfg = published_config(arch, widths)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        params = model_lib.init_params(gen, cfg, device="cuda")
        n_params = sum(p.numel() for p in tree_leaves(params))
        if n_params != cfg.param_count():
            raise AssertionError(f"{arch}: {n_params} params on the card")
        print(f"{arch}: {n_params} params, {cfg.dtype}, on "
              f"{torch.cuda.get_device_name(0)}")
        parity = logits_parity(cfg, params)
        prompts = _token_array(np.random.default_rng(2), cfg, MAX_BATCH,
                               MUSIC_PROMPT)
        _reset_counters()
        codes, prefill_s, decode_s = generate_codes(cfg, params, prompts)
        launches = {n: fn.launches for n, fn in _counters().items()}
        rms_shapes = dict(_counters()["rmsnorm_fwd"].shapes)
        flash_shapes = dict(_counters()["flash_attention"].shapes)
        picks = (0, MAX_BATCH - 1)
        for i in picks:
            alone = np.zeros_like(prompts)
            alone[0] = prompts[i]
            got, _, _ = generate_codes(cfg, params, alone)
            if not torch.equal(got[0], codes[i]):
                raise AssertionError(f"{arch} sequence {i} alone: "
                                     f"{got[0].tolist()} != batched "
                                     f"{codes[i].tolist()}")
    print(f"{arch} sequences {picks} generated alone equal the batched "
          f"run's {NEW_TOKENS + 1} x {cfg.num_codebooks} codes")
    n_attn, widths_per = _n_layers(cfg, "attn"), _norm_widths(cfg)
    want = {"flash_attention": n_attn, "flash_attention_bwd": 0,
            "decode_attention": n_attn * NEW_TOKENS,
            "mamba_chunk_scan": 0, "mamba_chunk_scan_bwd": 0,
            "rmsnorm_fwd": sum(widths_per.values()) * (1 + NEW_TOKENS),
            "rmsnorm_bwd": 0}
    rows = {"prefill": (MAX_BATCH * MUSIC_PROMPT, 1),
            "decode step": (MAX_BATCH, NEW_TOKENS)}
    want_shapes = {(r, d): per * n for r, n in rows.values()
                   for d, per in widths_per.items()}
    if launches != want or rms_shapes != want_shapes:
        raise AssertionError(f"{arch}: launches {launches} by shape "
                             f"{rms_shapes}, expected {want} by shape "
                             f"{want_shapes}")
    print(f"{arch} launches: one prefill of {MAX_BATCH} x {MUSIC_PROMPT} "
          f"frames and {NEW_TOKENS} decode steps: {json.dumps(launches)}")
    rms_calls = {f"rmsnorm_fwd:{call}:{d}": (per, rms_shapes[(r, d)])
                 for call, (r, _) in rows.items()
                 for d, per in widths_per.items()}
    stats = {"arch": cfg.name, "n_params": n_params, "batch": MAX_BATCH,
             "prompt_frames": MUSIC_PROMPT,
             "codebooks": cfg.num_codebooks, "decode_steps": NEW_TOKENS,
             "prefill_s": prefill_s, "decode_s": decode_s,
             "decode_step_ms": 1e3 * decode_s / NEW_TOKENS,
             "frames_per_s": MAX_BATCH * NEW_TOKENS / decode_s,
             "parity": parity, "launches": launches, "card": card}
    print(json.dumps({"codebook_slice": stats}))
    with torch.inference_mode():
        print(json.dumps({"profile": profile_slice(cfg, params, card)}))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rms_calls


def _open_gates(params, gen):
    """Every cross-attention gate (0 at init, so tanh(gate) would shut
    the layer) set to a draw from U(0.5, 1.5) of ``gen``."""
    for group in params["groups"]:
        for slot in group["slots"]:
            gate = slot.get("mixer", {}).get("gate")
            if gate is not None:
                gate.copy_(torch.rand(gate.shape, generator=gen,
                                      device=gate.device) + 0.5)


def run_vision_slice(arch, widths, layers, card):
    """Phase 3 for llama-3.2-vision, which the engine refuses (as the JAX
    engine: requests carry no image): MAX_BATCH prompts of VISION_PROMPT
    tokens, each with 2048 image embeddings from the seed (the vision
    frontend is a stub, as in the JAX config), prefilled as one batch,
    then NEW_TOKENS greedy decode steps (``generate_codes``), every launch
    counter set to 0 just before and read just after: the prefill runs
    one causal flash a self-attention layer and one non-causal flash (the
    prompt against the image tokens) a cross-attention layer; a decode
    step one decode a self-attention layer and one flash of S = 1 against
    the image tokens' cached keys and values a cross-attention layer;
    rmsnorm at d for every layer's two norms and the final norm, and over
    head_dim for cross-attention's q_norm (a row a query head) and, at the
    prefill, k_norm (a row an image token's kv head).  The gates are set
    nonzero (``_open_gates``).  An image's embeddings are one vector of
    the image plus one a token, each N(0, 1): a vision encoder's patch
    embeddings share much of their content, and with independent tokens
    near-uniform attention over 2048 of them averages an image's mark
    away (on an H100 they moved the logits by rel. L2 0.0372, under
    LOGITS_REL_TOL).  Checks:
    the first and last sequences generated alone (row 0 of a batch whose
    other rows are zero) equal the batched run's; kernel-path logits
    against the plain path; other image embeddings move the prefill
    logits by at least IMAGE_MOVE_OF times LOGITS_REL_TOL.  Returns the
    launch counts (the flash ones also by call, from the wrapper's count
    by shape) and the rmsnorm launches by call and width, as
    ``run_slice``."""
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.config import dtype_of
    cfg = published_config(arch, widths, layers)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def images():
        shared = torch.randn((MAX_BATCH, 1, cfg.vision_dim), generator=gen,
                             device="cuda")
        return (shared + torch.randn((MAX_BATCH, cfg.num_image_tokens,
                                      cfg.vision_dim), generator=gen,
                                     device="cuda")).to(dtype_of(cfg))

    with torch.inference_mode():
        params = model_lib.init_params(gen, cfg, device="cuda")
        _open_gates(params, gen)
        n_params = sum(p.numel() for p in tree_leaves(params))
        print(f"{arch}: {n_params} params, {cfg.dtype}, on "
              f"{torch.cuda.get_device_name(0)}")
        img = images()
        parity = logits_parity(cfg, params, image_embeds=img)
        prompts = _token_array(np.random.default_rng(2), cfg, MAX_BATCH,
                               VISION_PROMPT)
        _reset_counters()
        toks, prefill_s, decode_s = generate_codes(cfg, params, prompts, img)
        launches = {n: fn.launches for n, fn in _counters().items()}
        rms_shapes = dict(_counters()["rmsnorm_fwd"].shapes)
        flash_shapes = dict(_counters()["flash_attention"].shapes)
        picks = (0, MAX_BATCH - 1)
        for i in picks:
            alone, alone_img = np.zeros_like(prompts), torch.zeros_like(img)
            alone[0], alone_img[0] = prompts[i], img[i]
            got, _, _ = generate_codes(cfg, params, alone, alone_img)
            if not torch.equal(got[0], toks[i]):
                raise AssertionError(f"{arch} sequence {i} alone: "
                                     f"{got[0].tolist()} != batched "
                                     f"{toks[i].tolist()}")
        other = _rel_l2(*(_prefill_decode(cfg, params, im)[0][0]
                          for im in (images(), img)))
        if not other >= IMAGE_MOVE_OF * LOGITS_REL_TOL:
            raise AssertionError(f"{arch}: other image embeddings move the "
                                 f"prefill logits by rel. L2 {other}, less "
                                 f"than {IMAGE_MOVE_OF} x LOGITS_REL_TOL")
    print(f"{arch} sequences {picks} generated alone equal the batched "
          f"run's {NEW_TOKENS + 1} tokens; other image embeddings move the "
          f"prefill logits by rel. L2 {other:.4f}")
    n_self, n_cross = _n_layers(cfg, "attn"), _n_layers(cfg, "cross_attn")
    n_d = sum(_norm_widths(cfg).values())
    hd, rows = cfg.head_dim, MAX_BATCH * VISION_PROMPT
    want = dict.fromkeys(launches, 0)
    want.update(flash_attention=n_self + n_cross * (1 + NEW_TOKENS),
                decode_attention=n_self * NEW_TOKENS,
                rmsnorm_fwd=(n_d + 2 * n_cross)
                + (n_d + n_cross) * NEW_TOKENS)
    calls = {  # call: ((rows, width), norms a call, calls)
        "prefill": ((rows, cfg.d_model), n_d, 1),
        "prefill q_norm": ((rows * cfg.num_heads, hd), n_cross, 1),
        "prefill k_norm": ((MAX_BATCH * cfg.num_image_tokens
                            * cfg.num_kv_heads, hd), n_cross, 1),
        "decode step": ((MAX_BATCH, cfg.d_model), n_d, NEW_TOKENS),
        "decode step q_norm": ((MAX_BATCH * cfg.num_heads, hd), n_cross,
                               NEW_TOKENS)}
    want_shapes = {shape: per * n for shape, per, n in calls.values()}
    # the flash launches by call, told apart by the wrapper's count by
    # (b, s, t, h, kv, hd, causal, window): the prompt against itself, the
    # prompt and a decode step's token against the image tokens
    heads = (cfg.num_heads, cfg.num_kv_heads, hd)
    flash_calls = {
        "self prefill": ((MAX_BATCH, VISION_PROMPT, VISION_PROMPT, *heads,
                          True, 0), n_self),
        "cross prefill": ((MAX_BATCH, VISION_PROMPT, cfg.num_image_tokens,
                           *heads, False, 0), n_cross),
        "cross decode step": ((MAX_BATCH, 1, cfg.num_image_tokens, *heads,
                               False, 0), n_cross * NEW_TOKENS)}
    want_flash = {shape: n for shape, n in flash_calls.values()}
    if (launches != want or rms_shapes != want_shapes
            or flash_shapes != want_flash):
        raise AssertionError(f"{arch}: launches {launches}, rmsnorm's by "
                             f"shape {rms_shapes}, flash's {flash_shapes}; "
                             f"expected {want}, {want_shapes}, "
                             f"{want_flash}")
    print(f"{arch} launches: one prefill of {MAX_BATCH} x {VISION_PROMPT} "
          f"tokens and {cfg.num_image_tokens} image tokens, and "
          f"{NEW_TOKENS} decode steps: {json.dumps(launches)}")
    launches.update({f"flash_attention:{call}": flash_shapes[shape]
                     for call, (shape, _) in flash_calls.items()})
    rms_calls = {f"rmsnorm_fwd:{call}:{shape[1]}": (per, per * n)
                 for call, (shape, per, n) in calls.items()}
    stats = {"arch": cfg.name, "n_params": n_params, "batch": MAX_BATCH,
             "prompt_tokens": VISION_PROMPT,
             "image_tokens": cfg.num_image_tokens,
             "decode_steps": NEW_TOKENS, "prefill_s": prefill_s,
             "decode_s": decode_s,
             "decode_step_ms": 1e3 * decode_s / NEW_TOKENS,
             "tokens_per_s": MAX_BATCH * NEW_TOKENS / decode_s,
             "other_images_rel_l2": other, "parity": parity,
             "launches": launches, "card": card}
    print(json.dumps({"vision_slice": stats}))
    with torch.inference_mode():
        print(json.dumps({"profile": profile_slice(
            cfg, params, card, image_embeds=img[:1])}))
    del params, img
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rms_calls


def long_context_check():
    """gemma2-27b at full width and LONG_LAYERS layers (2 of its 23
    local/global repeats, so both kinds run): one LONG_PROMPT-token prompt
    prefilled into a cache of LONG_CACHE positions, then one decode step
    at position LONG_PROMPT, where the local layers' 4096 window leaves
    out the prompt's first tokens.  Through the kernels (launch counts
    exact, with every counter set to 0 just before and read just after:
    one flash and one decode a layer, the norms of a pass at the prompt's
    rows and at 1 row) and through the plain path, whose logits must agree
    within LOGITS_REL_TOL.  At full depth the plain path's (1, 32, 4608,
    4608) fp32 scores would not fit beside the 54 GB of weights.  Returns
    the launch counts and the rmsnorm launches by call and width."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import model as model_lib
    cfg = published_config(LONG_ARCH, _widths(LONG_ARCH), LONG_LAYERS)
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, LONG_PROMPT + 1)).astype(np.int32)).cuda()
    pos = torch.full((1,), LONG_PROMPT, dtype=torch.int32, device="cuda")

    def run():
        cache = model_lib.init_cache(cfg, 1, LONG_CACHE, device="cuda")
        pre, cache = model_lib.prefill(params, cfg, toks[:, :LONG_PROMPT],
                                       cache)
        dec, _ = model_lib.decode_step(params, cfg, toks[:, LONG_PROMPT:],
                                       cache, pos)
        return pre.float(), dec.float()

    with torch.inference_mode():
        params = model_lib.init_params(
            torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
        _reset_counters()
        kernel = run()
        torch.cuda.synchronize()
        launches = {n: fn.launches for n, fn in _counters().items()}
        rms_shapes = dict(_counters()["rmsnorm_fwd"].shapes)
        with mock.patch.object(ops, "flash_attention", ref.flash_attention), \
                mock.patch.object(ops, "decode_attention",
                                  ref.decode_attention), \
                mock.patch.object(ops, "rmsnorm", ref.rmsnorm):
            plain = run()
    n_attn, n_norm = _n_layers(cfg, "attn"), _n_norms(cfg)
    want = dict.fromkeys(launches, 0)
    want.update(flash_attention=n_attn, decode_attention=n_attn,
                rmsnorm_fwd=2 * n_norm)
    want_shapes = {(LONG_PROMPT, cfg.d_model): n_norm,
                   (1, cfg.d_model): n_norm}
    if launches != want or rms_shapes != want_shapes:
        raise AssertionError(f"{LONG_KEY}: launches {launches}, rmsnorm "
                             f"{rms_shapes}; expected {want}, {want_shapes}")
    res = {}
    for name, a, w in zip(("prefill", "decode"), kernel, plain):
        rel = _rel_l2(a, w)
        res[name] = {"rel_l2_err": rel, "max_abs_err": float(
            (a - w).abs().max()), "finite": bool(torch.isfinite(a).all())}
        if not (res[name]["finite"] and rel <= LOGITS_REL_TOL):
            raise AssertionError(f"{LONG_KEY} {name} logits, kernel vs "
                                 f"plain path: {res[name]}")
    print(f"{LONG_KEY}: prompt {LONG_PROMPT} tokens, cache {LONG_CACHE} "
          f"positions, {cfg.num_layers} layers (window "
          f"{DENSE_ATTN[LONG_ARCH][3]} on the local ones); launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}; kernel "
          f"vs plain path logits:", json.dumps(res))
    del params, plain, kernel
    gc.collect()
    torch.cuda.empty_cache()
    return launches, {f"rmsnorm_fwd:prefill:{cfg.d_model}": (n_norm, n_norm)}


GAP_DEPTHS = (4, 12, 24, 46)  # gemma2-27b layers in --logits-gap


def logits_gap(card):
    """Where gemma2-27b's kernel-vs-plain logits gap comes from
    (``--logits-gap``): ``compare_plain_path`` at full width on the first
    GAP_DEPTHS layers of one seed-0 model, with both softcaps (attention
    50, final 30) as published and with both off; then at full depth with
    one op at a time swapped for its plain version."""
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import tree_map
    widths = _widths(LONG_ARCH)
    full = published_config(LONG_ARCH, widths)
    (group,) = full.groups
    with torch.inference_mode():
        params = model_lib.init_params(
            torch.Generator(device="cuda").manual_seed(0), full,
            device="cuda")
        rows = []
        for layers in GAP_DEPTHS:
            reps = layers // len(group.pattern)
            cfg = dataclasses.replace(full, groups=(
                dataclasses.replace(group, repeat=reps),))
            cut = dict(params, groups=[tree_map(lambda x: x[:reps],
                                                params["groups"][0])])
            for caps in (True, False):
                c = cfg if caps else dataclasses.replace(
                    cfg, attn_softcap=0.0, final_softcap=0.0)
                res = compare_plain_path(c, cut, check=False)
                rows.append({"layers": layers, "softcaps": caps,
                             "plain_ops": "all", **{
                                 k: v["rel_l2_err"] for k, v in res.items()}})
                print(json.dumps({"logits_gap": rows[-1]}))
        for op in ("flash_attention", "decode_attention", "rmsnorm"):
            res = compare_plain_path(full, params, plain_ops=(op,),
                                     check=False)
            rows.append({"layers": full.num_layers, "softcaps": True,
                         "plain_ops": op, **{
                             k: v["rel_l2_err"] for k, v in res.items()}})
            print(json.dumps({"logits_gap": rows[-1]}))
    print(card)
    print(json.dumps({"logits_gap_rows": rows, "card": card}))


def _params(cfg, as_cfg=None):
    """The params a ``Trainer`` of ``cfg`` starts from (seed 0), as leaves
    that require grad, in the dtype of ``as_cfg`` (default ``cfg``)."""
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import tree_map
    from repro_torch.models.config import dtype_of
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt, to = dtype_of(cfg), dtype_of(as_cfg or cfg)
    # the leaves in the model's dtype; the fp32 ones (zamba2's a_log,
    # dt_bias, d_skip) stay fp32
    return tree_map(lambda p: (p.to(to) if p.dtype == dt else p)
                    .requires_grad_(True),
                    model_lib.init_params(gen, cfg, "cuda"))


XDEPTH_LAYERS = (8, 24)   # --xlstm-depth: one and three repeats


def xlstm_depth(card):
    """How far xlstm-350m's training loss falls at each depth of
    ``XDEPTH_LAYERS`` (``--xlstm-depth``): the training slice's 8 AdamW
    steps (``TRAIN_OPT``, 4 x 2048 tokens on its fixed batch, bf16, remat
    "dots", deterministic algorithms) at the published widths, on the
    kernels; prints each depth's losses, fall and gradient norms."""
    from repro_torch.kernels import build
    from repro_torch.train.optimizer import make_optimizer
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    build.build_all()
    torch.use_deterministic_algorithms(True)
    widths = _widths(XLSTM_ARCH)
    out = {}
    for layers in XDEPTH_LAYERS:
        cfg = published_config(XLSTM_ARCH, widths,
                               None if layers == widths[0] else layers)
        tr = _trainer(cfg, make_optimizer("adamw", **TRAIN_OPT))
        hist = tr.train()
        losses = [r["loss"] for r in hist]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{cfg.name} at {layers} layers: {losses}")
        out[layers] = {"losses": losses, "fall": losses[0] - losses[-1],
                       "grad_norms": [r["grad_norm"] for r in hist]}
        print(f"{XLSTM_ARCH} at {layers} layers: the loss falls "
              f"{out[layers]['fall']:.4f} nat in {len(hist)} steps "
              f"({losses}); gradient norms {out[layers]['grad_norms']} "
              f"({card})")
        del tr, hist
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"xlstm_depth": out, "card": card}))


def parity_sweep(card):
    """Where zamba2-2.7b's bf16 gradients stand (``--parity-sweep``): at
    (2, 512) from the training slice's params, the gradients through the
    kernels and with each of ops.mamba_chunk_scan, ops.flash_attention and
    ops.rmsnorm (then all three) on its plain version, in bf16, and both
    routes in fp32; each set's largest and median leaf rel. L2 against the
    bf16 kernels' and against the fp32 kernels'."""
    from repro_torch.kernels import build, ops, ref
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import tree_paths
    build.build_all()
    cfg = published_config(ZTRAIN_ARCH, _widths(ZTRAIN_ARCH))
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (PARITY_BATCH, PARITY_SEQ + 1)).astype(
            np.int32)).cuda()
    plain = {"ssd": ("mamba_chunk_scan", ref.mamba_chunk_scan),
             "flash": ("flash_attention", ref.flash_attention),
             "rmsnorm": ("rmsnorm", ref.rmsnorm)}

    def grads(c, which=()):
        params = _params(cfg, c)
        with mock.patch.multiple(ops, **{plain[w][0]: plain[w][1]
                                         for w in which}) if which \
                else contextlib.nullcontext():
            loss, _ = model_lib.forward_loss(params, c, toks[:, :-1],
                                             toks[:, 1:])
            out = torch.autograd.grad(loss, [p for _, p in
                                             tree_paths(params)])
        del params
        return float(loss.detach()), [g.cpu() for g in out]

    _, ref32 = grads(cfg32)
    ref16 = None  # the first run's
    runs = [("bf16 kernels", cfg, ())] + [
        (f"bf16, {'+'.join(w)} plain", cfg, w)
        for w in (("ssd",), ("flash",), ("rmsnorm",),
                  ("ssd", "flash", "rmsnorm"))] + [
        ("fp32 kernels", cfg32, ()),
        ("fp32, all plain", cfg32, ("ssd", "flash", "rmsnorm"))]
    for what, c, which in runs:
        loss, g = grads(c, which)
        ref16 = g if ref16 is None else ref16
        row = {"run": what, "loss": loss}
        for name, base in (("vs_bf16_kernels", ref16), ("vs_fp32_kernels",
                                                         ref32)):
            rels = [_rel_l2(a, b) for a, b in zip(g, base)]
            row[name] = {"max": max(rels), "median": float(np.median(rels))}
        print(json.dumps({"parity_sweep": row, "card": card}), flush=True)
        del g
        gc.collect()


def grad_parity(cfg, params, check=True):
    """forward_loss and its gradients on one (2, 512) batch (a VLM's with
    (2, 2048, 7680) image embeddings from the seed) through the kernels,
    against the same with ops.flash_attention, ops.rmsnorm and
    ops.mamba_chunk_scan patched to their plain versions (differentiated
    by autograd: the SSD through its sequential recurrence); with
    ``check``, within PARITY_LOSS_REL and PARITY_GRAD_REL_L2.  An MoE's
    kernel path makes the plain path's router choices (``_routes``): in
    bf16 a choice that flips with one op's rounding moves its expert's
    gradients by far more than the rounding; the figures with the kernel
    path's own choices are reported beside, not checked."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import tree_paths
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(_token_array(rng, cfg, PARITY_BATCH,
                                         PARITY_SEQ + 1)).cuda()
    img = (torch.from_numpy(rng.standard_normal(
        (PARITY_BATCH, cfg.num_image_tokens, cfg.vision_dim)).astype(
            np.float32)).cuda() if cfg.vision_dim else None)
    names, leaves = zip(*tree_paths(params))

    def run():
        loss, _ = model_lib.forward_loss(params, cfg, toks[:, :-1],
                                         toks[:, 1:], img)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    def compare(loss_k, grads_k, what):
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        # a leaf whose plain gradient is 0 (none at these inputs) counts
        # its kernel gradient's norm
        rels = {n: float((a.float() - b.float()).norm()
                         / b.float().norm().clamp(min=1e-30))
                for n, a, b in zip(names, grads_k, grads_p)}
        worst = max(rels, key=rels.get)
        print(f"{cfg.name} gradient parity ({cfg.dtype}{what}) at (B, S) = "
              f"({PARITY_BATCH}, {PARITY_SEQ}): loss {loss_k} vs plain "
              f"{loss_p} (rel {loss_rel:.3e}, tol {PARITY_LOSS_REL}); largest "
              f"gradient rel L2 {rels[worst]:.3e} at {worst} (tol "
              f"{PARITY_GRAD_REL_L2})")
        return {"loss_kernel": loss_k, "loss_plain": loss_p,
                "loss_rel": loss_rel, "worst_leaf": worst,
                "worst_grad_rel_l2": rels[worst], "grad_rel_l2": rels}

    plain_routes = []
    t0 = time.perf_counter()
    with mock.patch.object(ops, "flash_attention", ref.flash_attention), \
            mock.patch.object(ops, "rmsnorm", ref.rmsnorm), \
            mock.patch.object(ops, "mamba_chunk_scan", ref.mamba_chunk_scan), \
            _routes(plain_routes):
        loss_p, grads_p = run()
    plain_s = time.perf_counter() - t0
    if cfg.moe:
        with _routes([], plain_routes):
            res = compare(*run(), ", routes pinned to the plain path's")
        kernel_routes = []
        with _routes(kernel_routes):
            loss_k, grads_k = run()
        res["unpinned_not_checked"] = compare(loss_k, grads_k,
                                              ", the kernel path's routes")
        res["unpinned_not_checked"]["choices_differ"] = _choices_differ(
            kernel_routes, plain_routes)
        del grads_k
    else:
        res = compare(*run(), "")
    res["seconds"] = {"plain_path": plain_s,
                      "all": time.perf_counter() - t0}
    print(f"{cfg.name} gradient parity ({cfg.dtype}): "
          f"{res['seconds']['all']:.1f} s, the plain path {plain_s:.1f} s")
    if check and not (res["loss_rel"] <= PARITY_LOSS_REL
                      and res["worst_grad_rel_l2"] <= PARITY_GRAD_REL_L2):
        raise AssertionError(f"gradient parity failed: {res}")
    return res


def profile_train_step(tr, step_ms, card):
    """Device busy time by kernel category and launches of one training
    step (torch.profiler), and the idle share against the unprofiled
    median step time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tr.train(tr.step + 1)
        torch.cuda.synchronize()
    by_cat, launches, top = _device_split(prof)
    busy = sum(by_cat.values())
    return {"step_ms": step_ms, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / step_ms,
            "device_ms_by_category": by_cat, "kernel_launches": launches,
            "top_kernels_ms": top, "card": card}


def restart_check(cfg):
    """3 steps, checkpoint, restore into a fresh Trainer, 3 more steps,
    against 6 straight steps (tests/test_train_serve_ft.py:83-103), at 2
    layers of the full width."""
    from repro_torch.models.common import tree_paths
    from repro_torch.models.config import uniform_groups
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = dataclasses.replace(
        cfg, groups=uniform_groups(2, cfg.groups[0].pattern[0]))
    d = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    kw = dict(global_batch=2, seq_len=512, log_every=10**9, eval_every=10**9)
    try:
        a = Trainer(cfg, TrainerConfig(steps=6, **kw), device="cuda")
        a.train()
        b1 = Trainer(cfg, TrainerConfig(steps=3, ckpt_every=3,
                                        ckpt_dir=str(d), **kw),
                     device="cuda")
        b1.train()
        del b1
        b2 = Trainer(cfg, TrainerConfig(steps=6, ckpt_dir=str(d), **kw),
                     device="cuda")
        if not (b2.maybe_restore() and b2.step == 3):
            raise AssertionError("restart: no checkpoint at step 3")
        b2.train()
        worst = 0.0
        for (n, x), (_, y) in zip(
                tree_paths({"params": a.params, "opt": a.opt_state}),
                tree_paths({"params": b2.params, "opt": b2.opt_state})):
            x, y = x.detach().double(), y.detach().double()
            if not torch.allclose(y, x, rtol=RESTART_TOL, atol=RESTART_TOL):
                raise AssertionError(f"restart: {n} differs by "
                                     f"{float((x - y).abs().max())}")
            worst = max(worst, float((x - y).abs().max()))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print(f"{cfg.name} at 2 layers: 3 steps + checkpoint + restore + 3 "
          f"steps equal 6 straight steps (params and AdamW state; largest "
          f"difference {worst}, tol {RESTART_TOL})")
    return worst


def _train_launches(cfg, batch, seq):
    """Kernel launches of one training step of ``cfg`` at (batch, seq)
    (forward and backward), and the rmsnorm launches by call as {kernel:
    {(call, rows, d): launches}}: the "training step" norms at batch x
    seq rows by width, and the VLM's cross-attention q_norm (a row a
    query token's head) and k_norm (a row an image token's kv head) over
    head_dim.  Under remat "full" or "dots" each checkpointed repeat's
    forward runs twice (the forward, then the recomputation in the
    backward: the kernels launch outside PyTorch's dispatcher, so "dots"
    recomputes them too); the final norm lies outside the repeats and runs
    once.  A cross-attention layer launches the flash kernels as a
    self-attention layer does (non-causal, against the image tokens)."""
    k = 2 if cfg.remat in ("full", "dots") else 1
    n_cross = _n_layers(cfg, "cross_attn")
    n_attn = _n_layers(cfg, "attn") + n_cross
    n_ssd = _n_layers(cfg, "mamba2")
    rows = batch * seq
    bwd = {("training step", rows, d): n
           for d, n in _norm_widths(cfg).items()}
    if n_cross:
        hd = cfg.head_dim
        bwd[("training step q_norm", rows * cfg.num_heads, hd)] = n_cross
        bwd[("training step k_norm",
             batch * cfg.num_image_tokens * cfg.num_kv_heads, hd)] = n_cross
    fwd = {c: k * n - (k - 1) * (c == ("training step", rows, cfg.d_model))
           for c, n in bwd.items()}
    per_step = {"flash_attention": k * n_attn, "flash_attention_bwd": n_attn,
                "decode_attention": 0, "mamba_chunk_scan": k * n_ssd,
                "mamba_chunk_scan_bwd": n_ssd,
                "rmsnorm_fwd": sum(fwd.values()),
                "rmsnorm_bwd": sum(bwd.values())}
    return per_step, {"rmsnorm_fwd": fwd, "rmsnorm_bwd": bwd}


def _flash_calls(cfg, batch, seq):
    """A training step's flash calls of ``cfg`` at (batch, seq), under
    the wrappers' count key (b, s, t, h, kv, hd, causal, window): {call:
    (key, attention layers)}.  The call names the mask where a step has
    two kinds (gemma2's "local" and "global" layers, the VLM's "self"- and
    "cross"-attention against its image tokens), else it is ""."""
    heads = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    layers = {}
    for g in cfg.groups:
        for spec in g.pattern:
            if spec.kind == "attn":
                key = (batch, seq, seq, *heads, True, spec.window or 0)
            elif spec.kind == "cross_attn":
                key = (batch, seq, cfg.num_image_tokens, *heads, False, 0)
            else:
                continue
            layers[key] = layers.get(key, 0) + g.repeat
    windowed = any(key[-1] for key in layers)
    return {(("local" if key[-1] else "global") if windowed
             else ("self" if key[-2] else "cross")) if len(layers) > 1
            else "": (key, n) for key, n in layers.items()}


def _train_shape(arch):
    """(batch, seq) of a training step of ``arch``."""
    return TRAIN_SHAPE.get(arch, (TRAIN_BATCH, TRAIN_SEQ))


def _trainer(cfg, optimizer, steps=TRAIN_STEPS):
    """A ``Trainer`` of ``cfg`` (params from seed 0) with ``optimizer``,
    ``_train_shape`` tokens a step, on one fixed batch."""
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.train.trainer import Trainer, TrainerConfig

    class FixedBatch(SyntheticDataset):
        def batch_at(self, step):
            return super().batch_at(0)

    batch, seq = _train_shape(cfg.name)
    tr = Trainer(cfg, TrainerConfig(steps=steps, global_batch=batch,
                                    seq_len=seq, log_every=1,
                                    eval_every=10**9),
                 optimizer=optimizer, device="cuda")
    tr.dataset = FixedBatch(cfg, batch, seq)
    return tr


def _train_steps(tr, what):
    """Run ``tr``'s steps with every launch counter set to 0 just before
    and read just after, and the peak of allocated device memory from just
    before (the params and optimizer state included); check every kernel's
    launches, and rmsnorm's by (rows, d), against ``_train_launches``.
    The flash forward's and backward's launches by mask
    (``_flash_calls``) are checked too, and where a step has two masks
    each call's count is returned as "flash_attention:<call>" and
    "flash_attention_bwd:<call>".  Returns (losses, median step ms of
    steps 2.., per-step launches, launches, rmsnorm launches by width,
    peak bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    hist = tr.train()
    peak = torch.cuda.max_memory_allocated()
    launches = {n: fn.launches for n, fn in _counters().items()}
    rms_shapes = {n: dict(_counters()[n].shapes)
                  for n in ("rmsnorm_fwd", "rmsnorm_bwd")}
    flash_shapes = {n: dict(_counters()[n].shapes)
                    for n in ("flash_attention", "flash_attention_bwd")}
    per_step, widths = _train_launches(tr.cfg, tr.tc.global_batch,
                                       tr.tc.seq_len)
    calls = _flash_calls(tr.cfg, tr.tc.global_batch, tr.tc.seq_len)
    n = len(hist)
    want = {k: c * n for k, c in per_step.items()}
    want_shapes = {k: {(rows, d): c * n for (_, rows, d), c in w.items()}
                   for k, w in widths.items()}
    # each attention layer launches the backward once a step and the
    # forward as often as the step's ratio (twice under remat)
    fwd_per_layer = per_step["flash_attention"] // max(
        per_step["flash_attention_bwd"], 1)
    want_flash = {k: {key: c * layers * n for key, layers in calls.values()}
                  for k, c in (("flash_attention", fwd_per_layer),
                               ("flash_attention_bwd", 1))}
    if (launches != want or rms_shapes != want_shapes
            or flash_shapes != want_flash):
        raise AssertionError(f"{what}: launches {launches} by shape "
                             f"{rms_shapes}, flash's {flash_shapes}, "
                             f"expected {want} by shape {want_shapes}, "
                             f"flash's {want_flash} ({per_step} a step)")
    losses = [r["loss"] for r in hist]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{what}: losses {losses}")
    step_ms = 1e3 * float(np.median([r["time_s"] for r in hist[1:]]))
    by_width = {f"{k}:{call}:{d}": (c, rms_shapes[k][(rows, d)])
                for k, w in widths.items() for (call, rows, d), c in w.items()}
    by_call = {f"{k}:{call}": shapes[key]
               for k, shapes in flash_shapes.items()
               for call, (key, _) in calls.items() if call}
    launches.update(by_call)
    print(f"{what}: launches a step {json.dumps(per_step)}"
          + (f"; flash launches by call {json.dumps(by_call)} in {n} steps"
             if by_call else "") + "; losses "
          f"{losses}; step {step_ms:.2f} ms (median of steps 2-{n}); peak "
          f"memory {peak} B")
    return losses, step_ms, per_step, launches, by_width, peak


MFU_FORMULA = ("(6 N B S + 12 hd H B P) / step time / 989e12; N = "
               "param_count(), or active_param_count() for an MoE (top-k of "
               "E experts); P = the live (query, key) pairs of every "
               "attention layer: S (S + 1) / 2 causal, less what a window "
               "masks, S T for cross-attention against T image tokens; an "
               "mLSTM's intra-chunk products are not counted")


def _mfu(cfg, step_ms):
    """(model FLOPs a step, N, MFU) by ``MFU_FORMULA``: 6 N tokens plus
    the attention products, 4 hd FLOPs a live pair forward and 8
    backward."""
    b, s = _train_shape(cfg.name)
    n_params = cfg.active_param_count() if cfg.moe else cfg.param_count()
    pairs = 0
    for g in cfg.groups:
        for spec in g.pattern:
            if spec.kind == "cross_attn":
                pairs += g.repeat * s * cfg.num_image_tokens
            elif spec.kind == "attn":
                w = min(spec.window or s, s)
                pairs += g.repeat * (w * (w + 1) // 2 + (s - w) * w)
    attn = 12 * cfg.head_dim * cfg.num_heads * b * pairs
    flops = 6 * n_params * b * s + attn
    return flops, n_params, flops / (step_ms / 1e3) / PEAK_FLOPS


def slstm_scan_ms(tr):
    """The sLSTM scan alone (``xlstm._slstm_scan``) at the training step's
    shape (B, S, 4, 4, 256) from zero state, with the trained recurrent
    weights of the first sLSTM layer: host wall ms of its forward and of
    its backward, each to a sync, the second of two runs.  A training step
    under remat "dots" runs the forward twice (the forward, then the
    recomputation) and the backward once in each sLSTM layer."""
    from repro_torch.models import xlstm
    cfg = tr.cfg
    (group,) = cfg.groups
    slot = [s.kind for s in group.pattern].index("slstm")
    r = tr.params["groups"][0]["slots"][slot]["mixer"]["r"][0]
    r = r.detach().float().requires_grad_(True)
    _, nh, hd = xlstm._sdims(cfg)
    gen = torch.Generator(device="cuda").manual_seed(5)
    pre = torch.randn((TRAIN_BATCH, TRAIN_SEQ, 4, nh, hd), generator=gen,
                      device="cuda").to(torch.bfloat16).requires_grad_(True)
    zero = torch.zeros((TRAIN_BATCH, nh, hd), device="cuda")
    state = (zero, zero, zero, torch.full_like(zero, -1e30))
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.enable_grad():
            ys, _ = xlstm._slstm_scan(pre, r, state)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.autograd.grad(ys, (pre, r), torch.ones_like(ys))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return 1e3 * (t1 - t0), 1e3 * (t2 - t1)


def run_training(card, arch=TRAIN_ARCH, key=TRAIN_KEY):
    """Phase 3, a training slice: ``arch`` at its published width through
    ``Trainer`` (the config's own remat: "full" for llama, zamba2 and the
    ``WIDE_TRAIN`` families, "dots" for xlstm and musicgen; 8 steps of
    ``_train_shape`` tokens on a fixed batch, deterministic algorithms;
    AdamW, or a ``WIDE_TRAIN`` family's optimizer at its depth cut; at
    ``TRAIN_CUT``'s depth where it names ``arch``), after
    a gradient-parity check at (2, 512) from the same params in
    ``PARITY_DTYPE[arch]`` (at ``PARITY_CUT``'s depth where it names
    ``arch``; for xlstm also the parity in bf16, reported
    and not checked); llama also the restart check, xlstm the sLSTM scan's
    share of a step (``slstm_scan_ms``).  Returns its launch
    counts, its rmsnorm launches as ``run_slice`` does (the call: a
    training step), and its stats."""
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models.common import tree_leaves
    from repro_torch.train.optimizer import make_optimizer
    layers, opt_name = WIDE_TRAIN.get(arch, (TRAIN_CUT.get(arch), "adamw"))
    cfg = published_config(arch, _widths(arch), layers)
    batch, seq = _train_shape(arch)
    pcfg = (published_config(arch, _widths(arch), PARITY_CUT[arch])
            if arch in PARITY_CUT else cfg)
    parity_cfg = dataclasses.replace(pcfg, dtype=PARITY_DTYPE[arch])
    params = _params(pcfg, parity_cfg)
    if cfg.vision_dim:  # gates at 0 would zero the cross-attention's
        with torch.no_grad():  # gradients but the gate's
            _open_gates(params, torch.Generator(device="cuda").manual_seed(1))
    parity = grad_parity(parity_cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if arch == XLSTM_ARCH:  # zamba2's bf16 gradients: --parity-sweep
        parity[f"in_{cfg.dtype}_not_checked"] = grad_parity(
            cfg, _params(cfg), check=False)
        gc.collect()
        torch.cuda.empty_cache()
    tr = _trainer(cfg, make_optimizer(opt_name, **(
        dict(TRAIN_OPT, lr=WIDE_LR) if arch in WIDE_TRAIN else TRAIN_OPT)))
    n_params = sum(p.numel() for p in tree_leaves(tr.params))
    if n_params != cfg.param_count():
        raise AssertionError(f"{cfg.name}: {n_params} params on the card, "
                             f"param_count() {cfg.param_count()}")
    print(f"{cfg.name}: {n_params} params on the card, param_count() at "
          f"{cfg.num_layers} layers; {opt_name}, {batch} x {seq} tokens a "
          f"step")
    torch.use_deterministic_algorithms(True)
    losses, step_ms, per_step, launches, rms_calls, peak = _train_steps(
        tr, f"{cfg.name} training")
    margin = LOSS_MARGIN_OF.get(arch, LOSS_MARGIN)
    if not losses[-1] < losses[0] - margin:
        raise AssertionError(f"loss did not fall by {margin}: {losses}")
    # the loss on a batch it never saw: the tokens are uniform at random,
    # so what the fixed batch taught cannot carry over; a model whose
    # forward saw the next token would predict it there too
    held_out = float(tr._eval_step(tr.params, tr._batch(SyntheticDataset(
        cfg, batch, seq).batch_at(1)))["loss"])
    print(f"{cfg.name} loss on an unseen batch after the 8 steps: "
          f"{held_out} (the fixed batch's: {losses[-1]})")
    held_margin = (HELD_OUT_SHARE_OF[arch] * (losses[0] - losses[-1])
                   if arch in HELD_OUT_SHARE_OF else LOSS_MARGIN)
    if not held_out > losses[-1] + held_margin:
        raise AssertionError(f"{cfg.name}: loss on an unseen batch "
                             f"{held_out}, on the training batch "
                             f"{losses[-1]} (margin {held_margin})")
    flops, n_mfu, mfu = _mfu(cfg, step_ms)
    stats = {"arch": cfg.name, "n_params": n_params, "batch": batch,
             "seq_len": seq, "steps": TRAIN_STEPS, "losses": losses,
             "layers": cfg.num_layers, "optimizer": opt_name,
             "lr": WIDE_LR if arch in WIDE_TRAIN else TRAIN_OPT["lr"],
             "step_ms_median_2_to_8": step_ms,
             "step_ms": [1e3 * r["time_s"] for r in tr.history],
             "tokens_per_s": batch * seq / (step_ms / 1e3),
             "model_flops_per_step": flops, "mfu": mfu,
             "mfu_n_params": n_mfu,
             "mfu_formula": MFU_FORMULA, "remat": cfg.remat,
             "grad_norms": [r["grad_norm"] for r in tr.history],
             "loss_margin": margin, "held_out_margin": held_margin,
             "peak_flops": "989e12, H100 SXM dense bf16",
             "held_out_loss": held_out,
             "peak_memory_bytes": peak, "launches_per_step": per_step,
             "launches": launches, "parity": parity, "card": card}
    n_slstm = _n_layers(cfg, "slstm")
    if n_slstm:
        fwd, bwd = slstm_scan_ms(tr)
        scan = n_slstm * (2 * fwd + bwd)
        stats["slstm_scan"] = {"forward_ms": fwd, "backward_ms": bwd,
                               "layers": n_slstm, "ms_a_step": scan,
                               "share_of_step": scan / step_ms}
        print(f"{cfg.name} sLSTM scan alone at ({TRAIN_BATCH}, {TRAIN_SEQ}):"
              f" forward {fwd:.1f} ms, backward {bwd:.1f} ms; {n_slstm} "
              f"layers x (2 forwards + 1 backward) = {scan:.1f} ms of a "
              f"{step_ms:.1f} ms step ({scan / step_ms:.3f}; {card})")
    print(json.dumps({"train": stats}))
    print(json.dumps({"train_profile": profile_train_step(tr, step_ms,
                                                          card)}))
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    if arch == TRAIN_ARCH:
        restart_check(cfg)
    torch.use_deterministic_algorithms(False)
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rms_calls, stats


def _fused(params):
    """The optimized model's params from the unfused model's: wqkv = the
    concatenation of wq, wk and wv, wgu = stack(wi, wu) on the axis before
    F (tests/test_optimized_configs.py's construction), over the stacked
    repeat axis."""
    def fuse(p):
        if isinstance(p, dict):
            p = {k: fuse(v) for k, v in p.items()}
            if "wq" in p:
                p["wqkv"] = torch.cat([p.pop(k) for k in ("wq", "wk", "wv")],
                                      dim=-1)
            if "wu" in p:
                p["wgu"] = torch.stack([p.pop("wi"), p.pop("wu")], dim=-2)
            return p
        if isinstance(p, (list, tuple)):
            return type(p)(fuse(v) for v in p)
        return p
    return fuse(params)


def run_optimized(card, unfused):
    """The optimized llama3.2-1b config (fused QKV and gate/up projections)
    at full width: one prefill and one decode step's logits against the
    unfused model on the concatenated weights, within ``FUSED_REL_L2``;
    then 8 ``Trainer`` steps (AdamW, remat "full"): the loss falls by
    ``LOSS_MARGIN`` and every kernel launches as the unfused model's.
    ``unfused`` is the unfused training slice's stats."""
    from repro_torch.configs.optimized import optimized_config
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import tree_leaves
    from repro_torch.train.optimizer import make_optimizer
    base = published_config(TRAIN_ARCH, _widths(TRAIN_ARCH))
    cfg = optimized_config(TRAIN_ARCH)
    if not (cfg.fuse_qkv and cfg.fuse_glu) or cfg.remat != "full":
        raise AssertionError(f"optimized {cfg.name}: {cfg}")
    rng = np.random.default_rng(6)
    b, s = 8, 128
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)).cuda()
    pos = torch.full((b,), s, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = model_lib.init_params(gen, base, "cuda")
        outs = []
        for c, p in ((base, params), (cfg, _fused(params))):
            cache = model_lib.init_cache(c, b, 256, device="cuda")
            pre, cache = model_lib.prefill(p, c, toks[:, :s], cache)
            dec, _ = model_lib.decode_step(p, c, toks[:, s:], cache, pos)
            outs.append((pre.float(), dec.float()))
            del cache
        del params, p
    serving = {}
    for name, w, a in zip(("prefill", "decode"), *outs):
        rel = _rel_l2(a, w)
        serving[name] = {"rel_l2_err": rel, "max_abs_err": float(
            (a - w).abs().max()), "token_agreement": float(
                (a.argmax(-1) == w.argmax(-1)).float().mean())}
        if not rel <= FUSED_REL_L2:
            raise AssertionError(f"optimized {cfg.name} {name} logits "
                                 f"against the unfused model: rel L2 {rel} "
                                 f"> {FUSED_REL_L2}")
    del outs
    gc.collect()
    torch.cuda.empty_cache()
    print(f"optimized {cfg.name} (fuse_qkv, fuse_glu) against the unfused "
          f"model on concatenated weights: {json.dumps(serving)} (limit "
          f"{FUSED_REL_L2})")
    tr = _trainer(cfg, make_optimizer("adamw", **TRAIN_OPT))
    n_params = sum(p.numel() for p in tree_leaves(tr.params))
    losses, step_ms, per_step, launches, _, peak = _train_steps(
        tr, f"optimized {cfg.name} training")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    if not losses[-1] < losses[0] - LOSS_MARGIN:
        raise AssertionError(f"optimized {cfg.name}: loss did not fall by "
                             f"{LOSS_MARGIN}: {losses}")
    stats = {"arch": cfg.name, "fuse_qkv": True, "fuse_glu": True,
             "n_params": n_params, "serving_vs_unfused": serving,
             "losses": losses, "step_ms_median_2_to_8": step_ms,
             "unfused_step_ms_median_2_to_8": unfused["step_ms_median_2_to_8"],
             "mfu": _mfu(cfg, step_ms)[2],
             "peak_memory_bytes": peak,
             "unfused_peak_memory_bytes": unfused["peak_memory_bytes"],
             "launches": launches, "card": card}
    print(json.dumps({"optimized": stats}))


def run_remat(card):
    """remat "dots" on llama3.2-1b at full width, 4 x 2048 tokens, beside
    "full" and "none" (AdamW, 3 ``Trainer`` steps each on the fixed batch,
    launches checked): the step-1 gradients of "dots" against "full"'s
    (bit-equal, or within ``DOTS_REL_L2`` a leaf), and each mode's peak
    memory and step time."""
    from repro_torch.models.common import tree_paths
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import make_grad_fn
    base = published_config(TRAIN_ARCH, _widths(TRAIN_ARCH))
    batch = None
    modes, full_grads, cmp = {}, None, None
    torch.use_deterministic_algorithms(True)
    for remat in ("full", "dots", "none"):
        cfg = dataclasses.replace(base, remat=remat)
        tr = _trainer(cfg, make_optimizer("adamw", **TRAIN_OPT), steps=3)
        if remat != "none":
            if batch is None:
                batch = {k: torch.from_numpy(v).cuda()
                         for k, v in tr.dataset.batch_at(0).items()}
            names, _ = zip(*tree_paths(tr.params))
            _, grads = make_grad_fn(cfg)(tr.params, batch)
            grads = [g for _, g in tree_paths(grads)]
            if remat == "full":
                full_grads = [g.cpu() for g in grads]
            else:
                rels = {n: _rel_l2(g, w.cuda()) for n, g, w in
                        zip(names, grads, full_grads)}
                equal = all(torch.equal(g.cpu(), w)
                            for g, w in zip(grads, full_grads))
                worst = max(rels, key=rels.get)
                cmp = {"bit_equal": equal, "worst_leaf": worst,
                       "worst_rel_l2": rels[worst]}
                if not (equal or rels[worst] <= DOTS_REL_L2):
                    raise AssertionError(f'remat "dots" step-1 gradients '
                                         f'against "full": {cmp}')
                full_grads = None
            del grads
            gc.collect()
            torch.cuda.empty_cache()
        losses, step_ms, per_step, _, _, peak = _train_steps(
            tr, f'{base.name} remat "{remat}"')
        modes[remat] = {"peak_memory_bytes": peak, "step_ms": step_ms,
                        "losses": losses, "launches_per_step": per_step}
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(False)
    print(f'{base.name} remat "dots" step-1 gradients against "full": '
          f'{json.dumps(cmp)}')
    print(json.dumps({"remat": {"arch": base.name, "batch": TRAIN_BATCH,
                                "seq_len": TRAIN_SEQ, "dots_vs_full": cmp,
                                "modes": modes, "card": card}}))


def _state_bytes(state):
    from repro_torch.models.common import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(state))


def run_optimizers(card, adamw):
    """Adafactor and Lion on llama3.2-1b at full width (8 ``Trainer`` steps
    each, the fixed batch, TRAIN_OPT, remat "full"): the loss falls,
    Adafactor's state is factored (every param of rank >= 2 keeps row and
    column statistics, nothing its size), and each one's state bytes and
    step time beside AdamW's (``adamw``, the training slice's stats)."""
    from repro_torch.models.common import tree_map
    from repro_torch.train.optimizer import make_optimizer
    cfg = published_config(TRAIN_ARCH, _widths(TRAIN_ARCH))
    out = {"adamw": {"state_bytes": 8 * adamw["n_params"] + 4,
                     "step_ms": adamw["step_ms_median_2_to_8"],
                     "peak_memory_bytes": adamw["peak_memory_bytes"]}}
    for name in ("adafactor", "lion"):
        tr = _trainer(cfg, make_optimizer(name, **TRAIN_OPT))
        state = tr.opt_state
        if name == "adafactor":  # rows and columns, never a param's size
            unfactored = []
            tree_map(lambda p, st: unfactored.append(tuple(p.shape)) if (
                p.dim() >= 2 and not (set(st) == {"vr", "vc"} and (
                    st["vr"].numel() + st["vc"].numel() < p.numel())))
                else None, tr.params, state["stats"])
            if unfactored:
                raise AssertionError(f"adafactor state not factored for "
                                     f"params of shapes {unfactored}")
        out[name] = {"state_bytes": _state_bytes(state)}
        losses, step_ms, _, _, _, peak = _train_steps(
            tr, f"{cfg.name} {name}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{name}: the loss did not fall: {losses}")
        out[name].update(step_ms=step_ms, losses=losses,
                         peak_memory_bytes=peak)
        del tr, state
        gc.collect()
        torch.cuda.empty_cache()
    print(f"{cfg.name} optimizer state bytes and step ms ({card}): " +
          "; ".join(f"{k} {v['state_bytes']} B, {v['step_ms']:.2f} ms"
                    for k, v in out.items()))
    print(json.dumps({"optimizers": {"arch": cfg.name, **out,
                                     "card": card}}))


def _coordinator(cfg, n_executors, timed=None, started=None, trace=False,
                 events=None):
    """A ``MicrobatchCoordinator`` of the phase (params from seed 0), with
    the training slice's AdamW settings; ``timed`` collects the wall time
    of each microbatch's gradient function up to the loss's read-back
    (which the task does next), and ``started`` the start of each; with
    ``trace``, its pool runs with events and ``tracing`` on from its
    first task; ``events``, an event bus for its pool."""
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.trainer import MicrobatchCoordinator
    mc = MicrobatchCoordinator(cfg, n_executors=n_executors,
                               n_microbatches=COORD_MICRO,
                               scheduler="rsds_ws",
                               events=events or trace or None,
                               tracing=trace, device="cuda")
    mc.opt = make_optimizer("adamw", **TRAIN_OPT)
    mc.opt_state = mc.opt.init(mc.params)
    if timed is not None:
        grad = mc._grad

        def timed_grad(params, batch):
            t0 = time.perf_counter()
            if started is not None:
                started.append(t0)
            out = grad(params, batch)
            float(out[0][0])
            timed.append(time.perf_counter() - t0)
            return out

        mc._grad = timed_grad
    return mc


def profile_coordinator_step(mc, batch, step_ms, card):
    """Device busy time by kernel category and launches of one more
    coordinator step (torch.profiler; every executor thread's kernels),
    and the idle share against ``step_ms``, the unprofiled steps' median
    wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mc.train_step(batch)
        torch.cuda.synchronize()
    by_cat, launches, _ = _device_split(prof)
    busy = sum(by_cat.values())
    return {"step_ms": 1e3 * step_ms, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / (1e3 * step_ms),
            "device_ms_by_category": by_cat, "kernel_launches": launches,
            "card": card}


def _first_difference(names, got, want):
    """The first param leaf whose bits differ, or None."""
    for n, a, b in zip(names, got, want):
        if not torch.equal(a, b):
            return f"{n} (max abs diff {float((a.float() - b.float()).abs().max())})"
    return None


def run_coordinator(card, arch=TRAIN_ARCH, conformance=None):
    """A coordinator slice: ``arch`` at full width trained through
    ``MicrobatchCoordinator`` (global batch 4 x 2048 in 4 microbatches of
    1 x 2048, 4 executors, rsds_ws, 2 steps, deterministic algorithms).
    The loss is finite and falls; every kernel's launches are the
    microbatch's count times 4 a step; the params after step 1 are
    bit-equal across 4 executors, 1 executor and 4 executors with
    executor 2 failed mid-step, and within 5e-3 of one full-batch
    ``make_train_step`` step from the same init and batch; live tensor
    bytes are equal after each step; the 4-executor run's trace
    (``trace_split``, tracing on from its first task, 3 steps).  Returns
    its launch counts and rmsnorm launches as ``run_training`` does (the
    call: a microbatch).  With ``conformance``, the failed step's pool
    publishes events, checked live (phase 1c (c)): one ``worker-lost``."""
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import tree_leaves, tree_map, tree_paths
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import make_train_step
    cfg = published_config(arch, _widths(arch))
    batch = SyntheticDataset(cfg, TRAIN_BATCH, TRAIN_SEQ).batch_at(0)
    torch.use_deterministic_algorithms(True)
    walls, fn_walls, steps, live = [], [], [], []
    mc = _coordinator(cfg, COORD_EXECUTORS, fn_walls, trace=True)
    names = [n for n, _ in tree_paths(mc.params)]
    _reset_counters()
    t_traced = time.perf_counter()
    for step in range(COORD_STEPS):
        n0 = len(fn_walls)
        t0 = time.perf_counter()
        r = mc.train_step(batch)
        walls.append(time.perf_counter() - t0)
        if r["timed_out"] or r["loss"] is None:
            raise AssertionError(f"coordinator step {step + 1}: {r}")
        r.update(wall_s=walls[-1], microbatch_fn_s=fn_walls[n0:])
        steps.append(r)
        if step == 0:
            step1 = [p.detach().clone() for p in tree_leaves(mc.params)]
        live.append(_live_bytes())
    launches = {n: fn.launches for n, fn in _counters().items()}
    rms_shapes = {n: dict(_counters()[n].shapes)
                  for n in ("rmsnorm_fwd", "rmsnorm_bwd")}
    per_executor = mc._cluster.runtime.run_stats()["tasks_per_worker"]
    profile = profile_coordinator_step(mc, batch, float(np.median(walls)),
                                       card)
    live.append(_live_bytes())
    per_epoch = COORD_MICRO + 1  # the microbatches, then the reduce
    trace_split(
        mc._cluster, lambda tid: "microbatch" if tid % per_epoch
        < COORD_MICRO else "reduce", time.perf_counter() - t_traced,
        f"{cfg.name} coordinator", card)
    mc.close()
    del mc
    gc.collect()
    torch.cuda.empty_cache()
    losses = [r["loss"] for r in steps]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"coordinator losses {losses}")
    # the pool's graph keeps each step's task closures: none may keep the
    # step's microbatch gradients (4 x 2.47 GB) on the card
    if len(set(live)) != 1:
        raise AssertionError(f"coordinator: live tensor bytes after steps "
                             f"1..{len(live)} {live}, expected one value")
    print(f"{cfg.name} coordinator: live tensor bytes after each of "
          f"{len(live)} steps {live[0]}")
    per_micro, widths = _train_launches(cfg, 1, TRAIN_SEQ)
    runs = COORD_MICRO * COORD_STEPS
    want = {n: c * runs for n, c in per_micro.items()}
    want_shapes = {n: {(rows, d): c * runs for (_, rows, d), c in w.items()}
                   for n, w in widths.items()}
    if launches != want or rms_shapes != want_shapes:
        raise AssertionError(f"coordinator launches {launches} by shape "
                             f"{rms_shapes}, expected {want} by shape "
                             f"{want_shapes} ({per_micro} a microbatch)")
    print(f"{cfg.name} coordinator launches a microbatch: "
          f"{json.dumps(per_micro)}; {COORD_MICRO} a step")
    # the same step on 1 executor, and on 4 with executor 2 failed
    others = {}
    for n_exec, fail in ((1, None), (COORD_EXECUTORS, 2)):
        timed, started = [], []
        label = f"{cfg.name} coordinator, executor {fail} failed"
        bus = conformance.bus(label) if conformance and fail else None
        mc = _coordinator(cfg, n_exec, timed, started, events=bus)
        t0 = time.perf_counter()
        r = mc.train_step(batch, fail_worker=fail)
        r.update(wall_s=time.perf_counter() - t0, microbatch_fn_s=timed)
        if bus is not None:
            conformance.check(label)
            if bus.counts["worker-lost"] != 1:
                raise AssertionError(f"{label}: {dict(bus.counts)}")
        others[f"{n_exec} executors, fail_worker={fail}"] = r
        if r["timed_out"] or r["loss"] != losses[0]:
            raise AssertionError(f"coordinator, {n_exec} executors, "
                                 f"fail_worker={fail}: {r}, step 1 of the "
                                 f"4-executor run: {steps[0]}")
        # the failure hit a running microbatch: it ran again elsewhere
        dead = mc._cluster.runtime.dead
        want = (set(), COORD_MICRO) if fail is None else \
            ({fail}, COORD_MICRO + 1)
        if (dead, len(started)) != want:
            raise AssertionError(f"coordinator, {n_exec} executors, "
                                 f"fail_worker={fail}: dead executors "
                                 f"{dead}, {len(started)} microbatch runs "
                                 f"started, expected {want}")
        diff = _first_difference(names, tree_leaves(mc.params), step1)
        mc.close()
        del mc
        gc.collect()
        torch.cuda.empty_cache()
        if diff is not None:
            raise AssertionError(f"coordinator, {n_exec} executors, "
                                 f"fail_worker={fail}: params after step 1 "
                                 f"differ from the 4-executor run's first "
                                 f"at {diff}")
    print(f"{cfg.name} coordinator: params after step 1 bit-equal across "
          f"{COORD_EXECUTORS} executors, 1 executor and {COORD_EXECUTORS} "
          f"executors with executor 2 failed mid-microbatch (that "
          f"microbatch ran again elsewhere)")
    # one full-batch step from the same init and batch
    opt = make_optimizer("adamw", **TRAIN_OPT)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tree_map(lambda p: p.requires_grad_(True),
                      model_lib.init_params(gen, cfg, "cuda"))
    params, _, _ = make_train_step(cfg, opt)(
        params, opt.init(params),
        {k: torch.from_numpy(v).cuda() for k, v in batch.items()})
    worst = 0.0
    for n, a, b in zip(names, step1, tree_leaves(params)):
        a, b = a.float(), b.detach().float()
        err = (a - b).abs()
        if bool((err > COORD_TOL + COORD_TOL * b.abs()).any()):
            raise AssertionError(f"coordinator step 1 against the "
                                 f"full-batch step: {n} off by "
                                 f"{float(err.max())}")
        worst = max(worst, float(err.max()))
    del params, step1
    gc.collect()
    torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(False)
    print(f"{cfg.name} coordinator step 1 within {COORD_TOL} (abs and rel) "
          f"of one full-batch step: largest difference {worst}")
    stats = {"arch": cfg.name, "executors": COORD_EXECUTORS,
             "microbatches": COORD_MICRO, "microbatch": [1, TRAIN_SEQ],
             "scheduler": "rsds_ws", "losses": losses,
             "full_batch_max_abs_diff": worst, "steps": steps,
             "live_bytes_after_steps": live,
             "step_1_again": others, "tasks_per_executor": per_executor,
             "profile": profile, "card": card}
    runs = [(f"{COORD_EXECUTORS} executors, step {r['step']}", r)
            for r in steps] + [(f"{k}, step 1", r) for k, r in others.items()]
    for what, r in runs:
        print(f"{cfg.name} coordinator, {what} ({card}): wall "
              f"{1e3 * r['wall_s']:.2f} ms, makespan "
              f"{1e3 * r['makespan']:.2f} ms, server_busy "
              f"{1e3 * r['server_busy']:.4f} ms; microbatch functions "
              f"{' + '.join(f'{1e3 * w:.2f}' for w in r['microbatch_fn_s'])}"
              f" = {1e3 * sum(r['microbatch_fn_s']):.2f} ms")
    print(f"{cfg.name} coordinator step profile ({card}): device busy "
          f"{profile['device_busy_ms']:.2f} ms of a {profile['step_ms']:.2f} "
          f"ms step, idle share {profile['device_idle_share']:.4f}, "
          f"{profile['kernel_launches']} launches")
    print(json.dumps({"coordinator": stats}))
    rms_calls = {f"{n}:microbatch:{d}": (c, rms_shapes[n][(rows, d)])
                 for n, w in widths.items() for (_, rows, d), c in w.items()}
    return launches, rms_calls


def hgmma_counts(build):
    """The number of HGMMA (wgmma) instructions in each bf16 flash and SSD
    kernel's SASS (the SSD backward's state and chunk kernels too), from
    ``cuobjdump -sass`` of the built libraries; None if the toolkit has no
    cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    counts = {}
    from concurrent.futures import ThreadPoolExecutor

    def sass_of(lib):
        return subprocess.run([tool, "-sass", str(build.library_path(lib))],
                              capture_output=True, text=True,
                              check=True).stdout

    with ThreadPoolExecutor(4) as ex:     # the disassemblies run at once
        sasses = list(ex.map(sass_of, (
            "flash_attention", "flash_attention_bwd", "mamba_chunk_scan",
            "mamba_chunk_scan_bwd")))
    for sass in sasses:
        fn = None
        for line in sass.splitlines():
            if "Function :" in line:
                # flash: <head dim>; SSD: <padded HD, padded NS>
                m = (re.search(r"(flash_(?:fwd|bwd)\w*?_sm90)ILi(\d+)E",
                               line)
                     or re.search(r"(ssd_kernel_sm90|ssd_bwd_states|"
                                  r"ssd_bwd_chunk)ILi(\d+)ELi(\d+)E", line))
                fn = m and f"{m[1]}<{','.join(m.groups()[1:])}>"
                if fn:
                    counts[fn] = 0
            elif fn and "HGMMA" in line:
                counts[fn] += 1
    return counts


# the paper's runtime on the card's host (run_process_runtime)
RT_SCALE = 0.05                # (b): benchgraphs.suite at this scale
RT_ZERO_SIZES = (10000, 25000)  # (d): the suite's first two merges at 1.0
RT_SIM_SCALE = 0.1             # (e): the simulator's suite
RT_BUDGET_S = 45.0             # what the phase should take
# (d)'s wait for a graph on the Dask wire with batching off, by size:
# over the card's host's loopback TCP its one-segment-a-frame traffic
# (compute and finished frames, and update-graph frames to every worker)
# ran merge(10000) in 2.6 s to more than 60 s and merge(25000) in 169-174
# s (pipes, which only a forked pool has: 3.1 s); a graph not done by
# then is reported as far as it got
RT_PER_FRAME_WAIT_S = {10000: 5.0, 25000: 2.0}
# workers of (a)-(c)'s pools: a process takes ~0.2 s to start on the
# card's host, and parity needs no more than a few
RT_PARITY_WORKERS = 3


def rt_torch_state():
    """Task for the process runtime's workers: what this worker knows of
    torch.  A worker imports this script as ``__mp_main__``, which then
    imports no torch; it must not initialise CUDA in any case."""
    t = sys.modules.get("torch")
    if t is None:
        return "absent"
    return f"cuda_initialized={t.cuda.is_initialized()}"


def _rt_same(a, b):
    if sorted(a) != sorted(b):
        return False
    return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


def _rt_finished(cluster):
    return sum(cluster.runtime.run_stats()["tasks_per_worker"].values())


def _rt_run_graphs(cluster, graphs):
    """Submit each graph as an epoch of the warm ``cluster``, one at a
    time; {name: what it gave}."""
    out = {}
    for g in graphs:
        done0 = _rt_finished(cluster)
        gf = cluster.client.submit_graph(g)
        res = gf.result(120.0)
        e = gf.epoch
        assert e.error is None and e.remaining == 0, (g.name, e.error)
        out[g.name] = {"n_tasks": e.n_tasks, "values": res,
                       "finished": _rt_finished(cluster) - done0}
    return out


def _rt_zero_row(c, g, wait):
    """One zero-worker graph ``g`` on the warm pool ``c``, waited for at
    most ``wait`` seconds: its figures a task, or, where it did not
    finish, the tasks done and frames moved so far."""
    st0 = c.runtime.run_stats()
    t0 = time.perf_counter()
    gf = c.client.submit_graph(g)
    finished = gf.wait(wait)
    wall = time.perf_counter() - t0
    st1 = c.runtime.run_stats()
    e, k = gf.epoch, g.n_tasks
    row = {"finished": finished, "wall_s": wall,
           "n_frames_sent": st1["n_frames_sent"] - st0["n_frames_sent"],
           "frames_coalesced":
               st1["frames_coalesced"] - st0["frames_coalesced"]}
    if not finished:    # remaining is -1 until the server ingests it
        row["tasks_done"] = e.n_tasks - e.remaining if e.remaining >= 0 \
            else 0
        row["wire_frames_so_far"] = st1["wire_frames"] - st0["wire_frames"]
        return row
    row.update(makespan_s=e.makespan,
               server_us_a_task=e.server_busy / k * 1e6,
               wire_bytes_a_task=(st1["wire_bytes"] - st0["wire_bytes"]) / k,
               wire_frames_a_task=(st1["wire_frames"] - st0["wire_frames"])
               / k)
    return row


def run_process_runtime(n_workers=None, conformance=None):
    """The paper's runtime comparison on OS-process workers started by a
    parent that holds a CUDA context: (a) spawn under CUDA, (b) parity
    with the thread runtime, (c) a SIGKILLed worker, (d) the zero-worker
    measurement at its published size, (e) the simulator.  The pools of (b)
    and (c) publish events into live sinks of ``conformance`` (a new
    ``Conformance`` by default; phase 1c (c)).  Returns the figures it
    printed."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.core import Cluster, benchgraphs, simulate
    from repro_torch.ft.faults import kill_worker_after

    t_phase = time.perf_counter()
    conformance = conformance or Conformance()
    torch.ones(1, device="cuda")
    assert torch.cuda.is_initialized(), "the parent holds no CUDA context"
    nw = n_workers or min(8, os.cpu_count() or 1)
    npar = min(RT_PARITY_WORKERS, nw)
    starts, out = {}, {"n_workers": {"a-c": npar, "d": nw}}
    parts, mark = {}, [t_phase]

    def part(name):
        now = time.perf_counter()
        parts[name] = round(now - mark[0], 2)
        mark[0] = now

    closing = []

    def stream_label(key):
        server, driver, p2p = key
        return (f"runtime {server} {driver} {'p2p' if p2p else 'relay'}"
                + (" with the kill" if key == ("rsds", "selector", True)
                   else ""))

    def retire(c, force=False):
        """Close a pool on a thread of its own (its workers exit while the
        phase goes on); the phase joins them all."""
        t = threading.Thread(target=c.close, kwargs={"force": force})
        t.start()
        closing.append((t, c))

    def join_closing():
        while closing:
            t, c = closing.pop()
            t.join(60.0)
            assert not t.is_alive() and not any(
                pr.is_alive() for pr in c.runtime.procs), \
                "a pool did not close"

    def cluster(label, n=npar, **kw):
        """A warm process pool; its start is timed to the end of a first
        task (the server loop serves once every worker has connected)."""
        t0 = time.perf_counter()
        c = Cluster(n_workers=n, runtime="process", timeout=300.0, **kw)
        f = c.client.submit(abs, -1)
        assert c.runtime.wait_epoch(f.eid, 120.0), label
        starts[label] = round(time.perf_counter() - t0, 3)
        f.release()
        return c

    # The pools start at once, on threads: (a)-(c)'s six run their
    # checks as they come up, and (d)'s four wait, idle, to be measured
    # one at a time once the rest are done (a pool's start is the phase's
    # largest cost, ~1-2 s a pool on the card's host).
    graphs = benchgraphs.suite(scale=RT_SCALE) + [
        benchgraphs.value_reduction(24, fan=4),
        benchgraphs.array_reduction(16, elems=1024, fan=4)]
    value_graphs = {graphs[-2].name, graphs[-1].name}
    parity_keys = [(server, driver, p2p) for server in ("dask", "rsds")
                   for driver, p2p in (("selector", True), ("asyncio", True),
                                       ("selector", False))]
    zero_keys = [(server, batching) for server in ("dask", "rsds")
                 for batching in (True, False)]

    def parity(key):
        """One (b) pool's graphs, (a)'s checks on the first pool and (c)'s
        kill on the rsds selector pool; the pool closes in the background."""
        server, driver, p2p = key
        first = key == parity_keys[0]
        label = f"{server} {driver} {'p2p' if p2p else 'relay'}"
        c = cluster(label, server=server, driver=driver, p2p=p2p,
                    simulate_durations=False,
                    transport="pipe" if first else "socket",
                    events=conformance.bus(stream_label(key)))
        res = {}
        try:
            if first:
                # the pool (a) is about: spawned, pipe asked
                res["a"] = {
                    "start": sorted({type(pr._popen).__module__.rsplit(
                        ".", 1)[-1] for pr in c.runtime.procs}),
                    "transport": c.runtime.run_stats()["transport"],
                    "worker_torch": sorted(set(c.client.gather(
                        [c.client.submit(rt_torch_state)
                         for _ in range(4 * npar)], 60.0))),
                    "workers_ran": len(
                        c.runtime.run_stats()["tasks_per_worker"])}
            res["got"] = _rt_run_graphs(c, graphs)
            res["stats"] = c.runtime.run_stats()
            if key == ("rsds", "selector", True):
                # (c) a SIGKILLed worker mid-graph: the same values
                g = benchgraphs.value_reduction(24, fan=4)
                sleeps = c.client.map(time.sleep, [0.2] * (2 * npar))
                timer = kill_worker_after(c.runtime, 1, 0.1)
                res["killed"] = c.client.submit_graph(g).result(120.0)
                c.client.gather(sleeps, 120.0)
                timer.join(30.0)
                proc = c.runtime.procs[1]
                proc.join(10.0)
                res["c"] = {"dead": 1 in c.runtime.dead,
                            "exitcode": proc.exitcode}
        finally:
            retire(c)
        return res

    with ThreadPoolExecutor(len(parity_keys) + len(zero_keys)) as ex:
        zero_pools = {
            (server, batching): ex.submit(
                cluster, f"{server} zero "
                f"{'batched' if batching else 'per-frame'}", n=nw,
                server=server, zero_worker=True, batching=batching)
            for server, batching in zero_keys}
        runs = {key: ex.submit(parity, key) for key in parity_keys}
        want = {}
        for server in ("dask", "rsds"):
            with Cluster(server=server, runtime="thread", n_workers=npar,
                         simulate_durations=False, timeout=300.0) as ct:
                want[server] = _rt_run_graphs(ct, graphs)
        runs = {key: f.result() for key, f in runs.items()}
        zero_pools = {key: f.result() for key, f in zero_pools.items()}

    # (a) spawn under CUDA: pipe asked, socket run, no worker has CUDA
    a = runs[parity_keys[0]]["a"]
    print(f"runtime (a): start {a['start']}, transport asked pipe, ran "
          f"{a['transport']}; workers' torch: {a['worker_torch']} (over "
          f"{a['workers_ran']} of {npar} workers)", flush=True)
    assert a["start"] == ["popen_spawn_posix"], a
    assert a["transport"] == "socket", a
    assert a["worker_torch"] and set(a["worker_torch"]) <= {
        "absent", "cuda_initialized=False"}, a
    out["a"] = a

    # (b) parity with the thread runtime
    checked = []
    for (server, driver, p2p), res in runs.items():
        label = f"{server} {driver} {'p2p' if p2p else 'relay'}"
        got, st = res["got"], res["stats"]
        for g in graphs:
            w, r = want[server][g.name], got[g.name]
            assert r["n_tasks"] == w["n_tasks"] == g.n_tasks, label
            assert r["finished"] >= g.n_tasks, (label, g.name)
            assert sorted(r["values"]) == sorted(w["values"]), \
                (label, g.name)
            if g.name in value_graphs:
                assert _rt_same(r["values"], w["values"]), (label, g.name)
        # with p2p on no payload byte rides through the server (how many
        # move worker to worker depends on where tasks ran)
        if p2p:
            assert st["relay_bytes"] == 0, (label, st["relay_bytes"])
        else:
            assert st["relay_bytes"] > 0 == st["p2p_bytes"], label
        checked.append(f"{label}: relay {st['relay_bytes']} B, "
                       f"p2p {st['p2p_bytes']} B")
    print(f"runtime (b): {len(graphs)} graphs "
          f"({sum(g.n_tasks for g in graphs)} tasks) equal to the thread "
          f"runtime's on {checked}", flush=True)
    out["b"] = {"graphs": [g.name for g in graphs], "runs": checked}

    # (c) the kill
    res = runs[("rsds", "selector", True)]
    assert res["c"]["dead"] and res["c"]["exitcode"] == -9, res["c"]
    assert _rt_same(res["killed"], want["rsds"]["reduce"]["values"])
    print(f"runtime (c): worker 1 SIGKILLed (exit {res['c']['exitcode']}) "
          f"mid-graph on rsds selector p2p; reduce values equal",
          flush=True)
    out["c"] = res["c"]
    # phase 1c (c): every (b) and (c) pool's event stream, checked live
    out["conformance"] = {stream_label(key):
                          conformance.check(stream_label(key))
                          for key in parity_keys}
    part("a, b, c and the pools' starts")

    join_closing()      # (d) measures with no other pool busy

    # (d) zero workers at the published size, one pool at a time
    zero = {}
    merges = {n: benchgraphs.merge(n) for n in RT_ZERO_SIZES}
    for (server, batching), c in zero_pools.items():
        label = f"{server} zero {'batched' if batching else 'per-frame'}"
        waits = RT_PER_FRAME_WAIT_S if (server, batching) == \
            ("dask", False) else {}
        done = True
        for n in RT_ZERO_SIZES:
            # a pool still busy with an unfinished graph takes no more
            row = (_rt_zero_row(c, merges[n], waits.get(n, 300.0))
                   if done else
                   {"finished": False, "not_run": "pool still busy"})
            done = row["finished"]
            zero[f"{label} merge-{n}"] = row
            print(f"runtime (d): {label} merge({n}): " + json.dumps(row),
                  flush=True)
        retire(c, force=not done)   # an unfinished graph is abandoned
    for n in RT_ZERO_SIZES:
        d = zero[f"dask zero per-frame merge-{n}"]
        r = zero[f"rsds zero per-frame merge-{n}"]
        assert r["finished"] and zero[f"dask zero batched merge-{n}"][
            "frames_coalesced"] > 0, n
        if d["finished"]:
            assert d["wire_frames_a_task"] >= 2.0 and \
                r["wire_frames_a_task"] < d["wire_frames_a_task"], (n, d, r)
        elif "tasks_done" in d:
            # unfinished: a done task has moved a compute and a finished
            # frame of its own, and the Dask wire has already moved more
            # frames than the static wire did for the whole graph
            assert d["wire_frames_so_far"] >= 2 * d["tasks_done"] and \
                d["wire_frames_so_far"] > r["wire_frames_a_task"] * \
                merges[n].n_tasks, (n, d, r)
    out["d"] = zero
    join_closing()
    part("d")

    # (e) the simulator (virtual time; server cost measured)
    ratios = {}
    for g in benchgraphs.suite(scale=RT_SIM_SCALE):
        ws = simulate(g, server="dask", scheduler="ws", n_workers=24)
        rnd = simulate(g, server="dask", scheduler="random", n_workers=24)
        assert not ws.timed_out and not rnd.timed_out, g.name
        assert ws.n_tasks == rnd.n_tasks == g.n_tasks
        ratios[g.name] = ws.makespan / rnd.makespan
    g = benchgraphs.merge(8000)
    sims = {s: simulate(g, server=s, scheduler="ws", n_workers=168,
                        zero_worker=True) for s in ("dask", "rsds")}
    assert all(not r.timed_out for r in sims.values())
    out["e"] = {
        "ws_over_random_makespan": ratios,
        "ws_over_random_geomean": float(np.exp(np.mean(np.log(
            list(ratios.values()))))),
        "merge-8000 at 168 workers rsds_over_dask_makespan":
            sims["rsds"].makespan / sims["dask"].makespan,
        "aot_us": {s: r.aot * 1e6 for s, r in sims.items()}}
    print("runtime (e): " + json.dumps(out["e"]), flush=True)
    part("e")
    out["pool_start_s"] = starts
    out["part_seconds"] = parts
    out["seconds"] = time.perf_counter() - t_phase
    print(f"runtime: pools started in {json.dumps(starts)} s; parts "
          f"{json.dumps(parts)} s; the phase took {out['seconds']:.1f} s of "
          f"its {RT_BUDGET_S:.0f} s budget", flush=True)
    return out


# phase 1c: the invariant checker (repro_torch.analysis) on the card's host
CONFORMANCE_BUDGET_S = 20.0    # (a), (b), (d) and every live sink's time
CONFORMANCE_DRAIN_S = 0.05     # a live sink feeds its checker this often
# (b): the explorer at tests/test_protocol.py's parameters (merge(12), 3
# workers), both servers, and its failure-injection run
EXPLORE_SIM = [("rsds", dict(n_schedules=20, seed=0, width=3, depth=2)),
               ("dask", dict(n_schedules=20, seed=0, width=3, depth=2)),
               ("dask", dict(n_schedules=8, seed=1, width=2, depth=1,
                             failures=((0.002, 0),)))]
EXPLORE_INPROC = 3             # schedules of the thread runtime
TRACE_DIR = ROOT / "build" / "chip_smoke_trace"   # (d)'s JSONL
class _TimedSink:
    """``repro_torch.analysis.trace.ConformanceSink`` on one event bus,
    off the publishing thread: the bus calls its sinks on the thread that
    publishes (the server loop's, under the bus's lock), where the checker
    added ~16 us an event to the runtime's cost a call on the card's host
    (PERF.md), so this sink only queues the event, and a thread of its own
    feeds the checker in order every ``CONFORMANCE_DRAIN_S``.  ``seconds``
    is the checker's time; ``close`` (the bus's, when its Cluster closes)
    stops the thread after a last drain."""

    def __init__(self, label):
        from repro_torch.analysis.trace import ConformanceSink
        self.label = label
        self.sink = ConformanceSink(path=f"<{label}>")
        self.seconds = 0.0
        self._queue = collections.deque()
        self._feeding = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"conformance {label}")
        self._thread.start()

    def __call__(self, ev):
        self._queue.append(ev)

    def _run(self):
        while not self._stop.wait(CONFORMANCE_DRAIN_S):
            self.drain()

    def drain(self):
        with self._feeding:
            t0 = time.perf_counter()
            while self._queue:
                self.sink(self._queue.popleft())
            self.seconds += time.perf_counter() - t0

    def close(self):
        self._stop.set()
        self._thread.join(30.0)
        self.drain()


class Conformance:
    """Phase 1c's state: the run's live streams (``streams``: label ->
    ``_TimedSink``) and the figures of its parts (``figures``: (a), (b),
    (d)).  ``main`` makes one and hands it to the runs whose streams it
    checks."""

    def __init__(self):
        self.streams = {}
        self.figures = {}

    def attach(self, bus, label):
        """Attach a live sink to ``bus`` (it replays the ring first, so the
        stream is whole from ``stream-open``) under ``label``."""
        if label in self.streams:
            raise AssertionError(f"stream {label!r} attached twice")
        self.streams[label] = _TimedSink(label)
        bus.add_sink(self.streams[label])

    def bus(self, label):
        """A new ``EventBus`` with a live sink, for a Cluster's
        ``events=``."""
        from repro_torch.core.events import EventBus
        bus = EventBus()
        self.attach(bus, label)
        return bus

    def check(self, label):
        """Print the stream's events checked, findings and the sink's
        time; any finding, an internal error of the checker, a hole in the
        stream (the checker would then run windowed, without its history
        guards) or an empty stream fails the run."""
        s = self.streams[label]
        s.drain()
        sink = s.sink
        found = [f"{f.key} @ {f.where}: {f.message}" for f in sink.findings]
        row = {"events": sink.n_events, "findings": len(found),
               "strict": sink.strict,
               "internal_errors": sink.n_internal_errors,
               "sink_ms": 1e3 * s.seconds}
        print(f"conformance {label}: " + json.dumps(row), flush=True)
        if found or sink.n_internal_errors or not sink.strict \
                or sink.n_events == 0:
            raise AssertionError(f"{label}: {row}; {found[:20]}")
        return row

    def static_and_explore(self):
        """(a) The static rules RA1-RA8 over this checkout: 0 findings; the
        suppressed count equal to the allowlist's matches with suppression
        off, and those keys the allowlist's.  (b) The explorer on the
        port's simulator and thread runtime: no violation in any run."""
        from repro_torch.analysis import engine
        from repro_torch.analysis.explore import explore_inproc, explore_sim
        from repro_torch.core import benchgraphs
        t0 = time.perf_counter()
        findings, n_suppressed = engine.run_rules(ROOT)
        allow, problems = engine.load_allowlist(engine.DEFAULT_ALLOWLIST)
        raw, _ = engine.run_rules(ROOT, allowlist=None)
        static = {"findings": len(findings), "suppressed": n_suppressed,
                  "allowlist_matches": sum(f.key in allow for f in raw),
                  "allowlist_keys": len(allow),
                  "seconds": time.perf_counter() - t0}
        print(f"conformance (a) static rules {', '.join(engine.rule_ids())} "
              f"over {ROOT}: " + json.dumps(static), flush=True)
        if findings or problems or \
                n_suppressed != static["allowlist_matches"] or \
                {f.key for f in raw} != set(allow):
            raise AssertionError("static rules: " + engine.format_text(
                findings + problems, n_suppressed, engine.rule_ids()))
        t0 = time.perf_counter()
        g = benchgraphs.merge(12)
        runs = []
        for server, kw in EXPLORE_SIM:
            r = explore_sim(server, graph=g, n_workers=3, **kw)
            runs.append({"explorer": "sim", "server": server,
                         "failures": bool(kw.get("failures")),
                         "runs": r.n_runs, "distinct": r.n_distinct,
                         "violations": [str(v) for v in r.violations]})
        for server in ("rsds", "dask"):
            r = explore_inproc(server, graph=g, n_schedules=EXPLORE_INPROC,
                               seed=0, n_workers=3)
            runs.append({"explorer": "inproc", "server": server,
                         "runs": r.n_runs, "distinct": r.n_distinct,
                         "violations": [str(v) for v in r.violations]})
        explore = {"graph": g.name, "runs": runs,
                   "seconds": time.perf_counter() - t0}
        for r in runs:
            print(f"conformance (b) explore_{r['explorer']} {r['server']}"
                  f"{' with a failure' if r.get('failures') else ''}: "
                  f"{r['runs']} runs, {r['distinct']} distinct "
                  f"interleavings, {len(r['violations'])} violations",
                  flush=True)
        bad = [r for r in runs if r["violations"]]
        if bad or runs[0]["distinct"] < EXPLORE_SIM[0][1]["n_schedules"]:
            raise AssertionError(f"explorer: {bad or runs[0]}")
        self.figures.update(a=static, b=explore)

    def offline(self, bus, label):
        """(d) Write the events of ``bus`` (its ring, whole) as JSONL with
        the runtime's own writer and check the file with ``python -m
        repro_torch.analysis --trace`` in a subprocess: exit 0, no
        finding, as many events as the live sink checked."""
        from repro_torch.core.events import JsonlEventLog
        t0 = time.perf_counter()
        sink = self.streams[label]
        sink.drain()
        events = bus.since(-1)
        if bus.n_dropped or len(events) != sink.sink.n_events:
            raise AssertionError(f"{label}: {len(events)} events in the "
                                 f"ring, {bus.n_dropped} dropped, the sink "
                                 f"checked {sink.sink.n_events}")
        TRACE_DIR.mkdir(parents=True, exist_ok=True)
        path = TRACE_DIR / "llama-engine.jsonl"
        log = JsonlEventLog(path)
        for ev in events:
            log(ev)
        log.close()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", "--trace",
             str(path), "--format", "json"], capture_output=True, text=True,
            timeout=120, cwd=ROOT,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        out = {"events": len(events), "returncode": proc.returncode,
               "seconds": time.perf_counter() - t0}
        if proc.returncode == 0:
            out["findings"] = json.loads(proc.stdout)["n_findings"]
        print(f"conformance (d) {label} as JSONL ({path.stat().st_size} "
              f"bytes) through python -m repro_torch.analysis --trace: "
              + json.dumps(out), flush=True)
        if proc.returncode != 0 or out["findings"] != 0:
            raise AssertionError(f"offline trace check: {out}\n"
                                 f"{proc.stdout}\n{proc.stderr}")
        shutil.rmtree(TRACE_DIR)
        self.figures["d"] = out

    def report(self, card):
        """The summary: every live stream again, each closed first, and the
        phase's time, (a) + (b) + (d) + every sink's, beside its
        budget."""
        for s in self.streams.values():
            s.close()
        rows = {label: self.check(label) for label in self.streams}
        parts = {"a static rules": self.figures["a"]["seconds"],
                 "b explorer": self.figures["b"]["seconds"],
                 "c live sinks": sum(s.seconds
                                     for s in self.streams.values()),
                 "d offline trace": self.figures["d"]["seconds"]}
        total = sum(parts.values())
        print(f"phase 1c conformance ({card}): {len(rows)} live streams, "
              f"{sum(r['events'] for r in rows.values())} events checked, "
              f"{sum(r['findings'] for r in rows.values())} findings; parts "
              + json.dumps({k: round(v, 3) for k, v in parts.items()})
              + f" s; {total:.2f} s of its {CONFORMANCE_BUDGET_S:.0f} s "
              f"budget", flush=True)
        print(json.dumps({"conformance": {**self.figures, "streams": rows,
                                          "part_seconds": parts,
                                          "seconds": total, "card": card}}))


# phase 5, the sharded step: the 1-rank NCCL group's store, the dry-run
# cells printed on the card's host, the prompt of its serving checks, its
# budget (seconds), and the leaves' rel. L2 a sharded step may differ by
SHARDED_STORE = ROOT / "build" / "chip_smoke_sharded_store"
SHARDED_DRYRUN = [("llama3.2-1b", "train_4k", "single"),
                  ("deepseek-v3-671b", "train_4k", "single"),
                  ("zamba2-2.7b", "long_500k", "single"),
                  ("gemma2-27b", "decode_32k", "multi")]
SHARDED_PROMPT, SHARDED_DECODE, SHARDED_ZAMBA_LAYERS = 512, 8, 12
SHARDED_BUDGET_S = 60.0
SHARDED_REL_L2 = 1e-4


def _launch_counts():
    return {k: fn.launches for k, fn in _counters().items()}


def _sharded_checks(out):
    """Phase 5 (a), in a spawned child: a 1-rank NCCL group, a (1, 1)
    ``("data", "model")`` mesh on the card, and the llama3.2-1b training
    step (4 x 2048, 16 layers, AdamW), its prefill and 8 greedy decode
    steps and zamba2-2.7b's prefill at 2 repeats, each on DTensor params
    inside ``logical_rules`` and unsharded on the same params and inputs:
    the differences and both runs' kernel launches go to ``out``."""
    global torch  # a spawned child imports this script without torch
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import (ShapeCase, tree_leaves,
                                           tree_map)
    from repro_torch.parallel import sharding
    from repro_torch.parallel.annotate import logical_rules, make_rules
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import make_train_step
    t0 = time.perf_counter()
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    SHARDED_STORE.unlink(missing_ok=True)
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(SHARDED_STORE), 1), rank=0,
        world_size=1, device_id=torch.device("cuda", 0))
    res = {}
    try:
        mesh = make_host_mesh((1, 1))
        rng = np.random.default_rng(5)

        def inputs(cfg, b, s, kind):
            specs = sharding.input_specs(cfg, ShapeCase("c", s, b, kind),
                                         mesh)
            return {k: torch.from_numpy(rng.integers(
                0, cfg.vocab_size, i.shape).astype(np.int64)).cuda()
                for k, i in specs.items() if k != "pos"}, specs

        def placed(batch, specs):
            return {k: sharding.distribute(v, specs[k].spec, mesh)
                    for k, v in batch.items()}

        def rel(a, b):
            a, b = a.detach().float(), b.detach().float()
            return float((a - b).norm() / b.norm().clamp(min=1e-30))

        def run(fn, label):
            _reset_counters()
            t = time.perf_counter()
            got = fn()
            torch.cuda.synchronize()
            return got, _launch_counts(), time.perf_counter() - t

        # the training step
        cfg = published_config(TRAIN_ARCH, _widths(TRAIN_ARCH))
        params = _params(cfg)
        batch, specs = inputs(cfg, TRAIN_BATCH, TRAIN_SEQ, "train")
        opt = make_optimizer("adamw", **TRAIN_OPT)
        ref = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                       params)
        (ref, _, m_u), n_u, s_u = run(lambda: make_train_step(cfg, opt)(
            ref, opt.init(ref), batch), "unsharded")
        sp = sharding.shard_params(params, cfg, mesh)
        del params
        with logical_rules(mesh, make_rules(cfg, mesh, TRAIN_BATCH)):
            (sp, _, m_s), n_s, s_s = run(lambda: make_train_step(cfg, opt)(
                sp, opt.init(sp), placed(batch, specs)), "sharded")
        leaves = [rel(a.full_tensor(), b) for a, b in zip(
            tree_leaves(sp), tree_leaves(ref))]
        res["train"] = {
            "loss": [float(m_u["loss"]), float(m_s["loss"].full_tensor())],
            "leaf_rel_l2_max": max(leaves),
            "leaves_bit_equal": sum(r == 0.0 for r in leaves),
            "leaves": len(leaves), "launches": [n_u, n_s],
            "seconds": [s_u, s_s]}
        del sp, ref
        gc.collect()
        torch.cuda.empty_cache()

        # serving: prefill and greedy decode steps
        def serve(arch, layers, steps):
            cfg = published_config(arch, _widths(arch), layers)
            with torch.inference_mode():
                p = model_lib.init_params(
                    torch.Generator(device="cuda").manual_seed(0), cfg,
                    device="cuda")
            b = 4
            toks, specs = inputs(cfg, b, SHARDED_PROMPT, "prefill")
            toks = toks["tokens"]
            total = SHARDED_PROMPT + steps

            def generate(params, cache, place):
                logits, cache = model_lib.prefill(params, cfg, place(toks),
                                                  cache)
                out, seq = [logits], []
                for i in range(steps):
                    nxt = logits.argmax(-1) if not hasattr(
                        logits, "full_tensor") else \
                        logits.full_tensor().argmax(-1)
                    seq.append(nxt)
                    pos = torch.full((b,), SHARDED_PROMPT + i,
                                     dtype=torch.int64, device="cuda")
                    logits, cache = model_lib.decode_step(
                        params, cfg, place(nxt), cache, place(pos))
                    out.append(logits)
                return out, seq

            with torch.no_grad():
                (lu, tu), n_u, s_u = run(lambda: generate(
                    p, model_lib.init_cache(cfg, b, total, device="cuda"),
                    lambda t: t), "unsharded")
                with logical_rules(mesh, make_rules(cfg, mesh, b)):
                    sp = sharding.shard_params(p, cfg, mesh)
                    cache = sharding.shard_cache(model_lib.init_cache(
                        cfg, b, total, device="cuda"), cfg, mesh, b)
                    (ls, ts), n_s, s_s = run(lambda: generate(
                        sp, cache, lambda t: sharding.distribute(
                            t, (sharding.batch_axes(mesh, b) or None,)
                            + (None,) * (t.dim() - 1), mesh)), "sharded")
            return {"logits_max_abs": max(float(
                (a.full_tensor().float() - b.float()).abs().max())
                for a, b in zip(ls, lu)),
                "greedy_equal": all(bool((a == b).all())
                                    for a, b in zip(ts, tu)),
                "launches": [n_u, n_s], "seconds": [s_u, s_s]}

        res["llama_serve"] = serve(TRAIN_ARCH, None, SHARDED_DECODE)
        gc.collect()
        torch.cuda.empty_cache()
        res["zamba2_prefill"] = serve(ZTRAIN_ARCH, SHARDED_ZAMBA_LAYERS, 0)
    finally:
        dist.destroy_process_group()
        SHARDED_STORE.unlink(missing_ok=True)
    res["seconds"] = time.perf_counter() - t0
    out.put(res)


def _sharded_dryrun(out):
    """Phase 5 (b), in a spawned child: the dry-run's cells of
    ``SHARDED_DRYRUN`` on meta tensors over the fake 256- or 512-rank
    mesh of device type cuda, on the card's host (no tensor on the
    card)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import release
    t0 = time.perf_counter()
    recs = []
    d = ROOT / "build" / "dryrun_torch" / "chip_smoke"
    d.mkdir(parents=True, exist_ok=True)
    for arch, shape, mesh in SHARDED_DRYRUN:
        t = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, mesh, d, force=True)
        rec["seconds"] = time.perf_counter() - t
        recs.append(rec)
    release()
    out.put({"records": recs, "seconds": time.perf_counter() - t0})


def run_sharded():
    """Phase 5: the sharded step (``_sharded_checks``) and the dry-run on
    the card's host (``_sharded_dryrun``), two spawned children at once
    (a process holds one default process group: NCCL for the one, fake
    for the other).  Checks (a): loss and every leaf of the step within
    ``SHARDED_REL_L2`` of the unsharded step, the same greedy tokens, and
    the same kernel launches as the unsharded calls, so the DTensor route
    reached the hand-written kernels; (b): every record ok.  Prints both
    and the phase's seconds beside ``SHARDED_BUDGET_S``."""
    import multiprocessing as mp
    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    qa, qb = ctx.Queue(), ctx.Queue()
    procs = [ctx.Process(target=_sharded_checks, args=(qa,)),
             ctx.Process(target=_sharded_dryrun, args=(qb,))]
    for pr in procs:
        pr.start()
    got = []
    for q, pr in zip((qa, qb), procs):
        res = None
        while res is None and (pr.is_alive() or not q.empty()):
            try:
                res = q.get(timeout=1)
            except Exception:
                if time.perf_counter() - t0 > 10 * SHARDED_BUDGET_S:
                    break
        got.append(res)
        pr.join(timeout=30)
        if pr.is_alive():
            pr.kill()
    a, b = got
    if a is None or b is None:
        raise AssertionError(f"phase 5: a child failed (exit codes "
                             f"{[pr.exitcode for pr in procs]})")
    print("sharded step on the card:", json.dumps(a, default=str))
    tr = a["train"]
    lu, ls = tr["loss"]
    if not (abs(lu - ls) <= SHARDED_REL_L2 * abs(lu)
            and tr["leaf_rel_l2_max"] <= SHARDED_REL_L2):
        raise AssertionError(f"sharded training step: loss {ls} against "
                             f"{lu}, leaves up to {tr['leaf_rel_l2_max']}")
    for key in ("train", "llama_serve", "zamba2_prefill"):
        n_u, n_s = a[key]["launches"]
        if n_u != n_s or not any(n_s.values()):
            raise AssertionError(f"sharded {key}: launches {n_s}, "
                                 f"unsharded {n_u}")
    for key in ("llama_serve", "zamba2_prefill"):
        if not a[key]["greedy_equal"]:
            raise AssertionError(f"sharded {key}: other greedy tokens")
    if not a["zamba2_prefill"]["launches"][1]["mamba_chunk_scan"]:
        raise AssertionError("sharded zamba2 prefill: no SSD launch")
    for rec in b["records"]:
        r = rec.get("roofline", {})
        full = rec.get("full", {})
        mem = full.get("memory", {})
        print(f"dry-run {rec['arch']} {rec['shape']} {rec['mesh']}: "
              f"{rec['status']} {rec.get('error', '')}; args "
              f"{mem.get('argument_bytes_per_dev')} B, saved "
              f"{mem.get('saved_bytes_per_dev')} B a device; flops "
              f"{full.get('flops')}; wire "
              f"{json.dumps(full.get('collective_bytes_by_op'))}; terms "
              f"{r.get('t_compute_s')} / {r.get('t_memory_s')} / "
              f"{r.get('t_collective_s')} s, {r.get('bottleneck')}; "
              f"{rec['seconds']:.1f} s", flush=True)
        if rec["status"] != "ok":
            raise AssertionError(f"dry-run {rec['arch']} {rec['shape']}: "
                                 f"{rec.get('trace', '')[-2000:]}")
    wall = time.perf_counter() - t0
    print(f"phase 5 sharded: {wall:.1f} s (budget {SHARDED_BUDGET_S} s; "
          f"(a) {a['seconds']:.1f} s, (b) {b['seconds']:.1f} s in their "
          f"children)", flush=True)
    return a, b


def main(argv=()) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rmsnorm-times", action="store_true",
                    help="only time the rmsnorm kernels (rmsnorm_times)")
    ap.add_argument("--serving-runtime", action="store_true",
                    help="only serve llama3.2-1b through the engine and "
                         "print the runtime's cost a call (serving_runtime)")
    ap.add_argument("--ssd-times", action="store_true",
                    help="only time the SSD forward and backward kernels "
                         "(ssd_times)")
    ap.add_argument("--flash-bwd-times", action="store_true",
                    help="only time the bf16 flash backward at the "
                         "training shapes (flash_bwd_times)")
    ap.add_argument("--parity-sweep", action="store_true",
                    help="only measure zamba2's bf16 gradients against "
                         "each plain version and fp32 (parity_sweep)")
    ap.add_argument("--logits-gap", action="store_true",
                    help="only measure gemma2-27b's kernel-vs-plain logits "
                         "gap by depth, softcaps and op (logits_gap)")
    ap.add_argument("--xlstm-depth", action="store_true",
                    help="only train xlstm-350m at one and three repeats "
                         "and print each depth's loss fall (xlstm_depth)")
    ap.add_argument("--process-runtime", action="store_true",
                    help="only build the kernels (timed by library) and "
                         "run the task runtime's phase on the card's host "
                         "(run_process_runtime)")
    ap.add_argument("--sharded", action="store_true",
                    help="only build the kernels and run phase 5, the "
                         "sharded step and the dry-run (run_sharded)")
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose src/repro_torch --rmsnorm-times, "
                         "--ssd-times, --flash-bwd-times or "
                         "--serving-runtime runs (default: this one)")
    args = ap.parse_args(argv)
    root = args.root.resolve()
    if root != ROOT and not (args.rmsnorm_times or args.ssd_times
                             or args.flash_bwd_times
                             or args.serving_runtime):
        ap.error("--root is for --rmsnorm-times, --ssd-times, "
                 "--flash-bwd-times and --serving-runtime")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (root / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {root} is not a checkout of the repo",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    if args.rmsnorm_times:
        rmsnorm_times(root)
        return 0
    if args.ssd_times:
        ssd_times(root)
        return 0
    if args.flash_bwd_times:
        flash_bwd_times(root)
        return 0
    if args.serving_runtime:
        serving_runtime(root)
        return 0
    if args.parity_sweep:
        parity_sweep(_card())
        return 0
    if args.logits_gap:
        logits_gap(_card())
        return 0
    if args.xlstm_depth:
        xlstm_depth(_card())
        return 0
    if args.sharded:
        from repro_torch.kernels import build
        print(_card())
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        build.build_all()
        run_sharded()
        return 0
    if args.process_runtime:
        from repro_torch.kernels import build
        print(_card())
        t0 = time.perf_counter()
        build.build_all()
        print(f"kernel build: {time.perf_counter() - t0:.1f} s; by library: "
              + json.dumps({k: round(v, 1)
                            for k, v in build.build_seconds.items()}))
        print("process runtime:", json.dumps(run_process_runtime(),
                                             default=str))
        return 0
    # cuBLAS reads this when it starts; the training slice's restart check
    # runs with deterministic algorithms, which require it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from repro_torch.kernels import build
    from repro_torch.kernels import rmsnorm as rn

    # 1. environment
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: matmul", torch.backends.cuda.matmul.allow_tf32,
          "cudnn", torch.backends.cudnn.allow_tf32)
    card = _card()
    print(card)
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "device", torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(logs) or 'cached'}); by library: "
          + json.dumps({k: round(v, 1)
                        for k, v in build.build_seconds.items()}))
    # (kernel, a tag of its instance): bf16 instances, and fp32 ones where
    # the tag starts with "If" (a template whose first argument is float)
    shown = [(k, t) for k in ("flash_fwd_kernel_sm90",
                              "flash_bwd_dq_kernel_sm90",
                              "flash_bwd_dkdv_kernel_sm90")
             for t in ("Li64E", "Li80E")] + [
        ("flash_fwd_kernel_sm90", "Li128E"), ("flash_fwd_kernel_sm90",
                                              "Li256E"),
        ("flash_fwd_kernel", "IfLi256E"),
        ("flash_bwd_dq_kernel_sm90", "Li256E"),
        ("flash_bwd_dkdv_split_kernel_sm90", "Li256E"),
        ("flash_bwd_dq_kernel", "IfLi256E"),
        ("flash_bwd_dkdv_kernel", "IfLi256E"), ("decode_kernel", "Li128ELi7E"),
        ("decode_kernel", "Li128ELi6E"), ("decode_kernel", "IfLi128ELi6E"),
        ("decode_kernel", "IfLi128ELi7E"), ("decode_kernel", "IfLi256ELi8E")
    ] + [("decode_kernel", f"Li256ELi{g}E") for g in (1, 2, 4, 7, 8)] + [
        ("decode_kernel", "Li64ELi4E"), ("decode_kernel", "Li80ELi1E"),
        ("decode_kernel", "Li64ELi1E"),
        ("ssd_kernel_sm90", "Li64ELi64E"), ("ssd_kernel_sm90", "Li64ELi128E"),
        ("ssd_kernel_sm90", "Li128ELi64E"),
        ("ssd_kernel_sm90", "Li128ELi128E"),
        ("ssd_bwd_states", "Li64ELi64E"), ("ssd_bwd_scan", ""),
        ("ssd_bwd_chunk", "Li64ELi64E"), ("ssd_bwd_chunk", "Li128ELi128E"),
        ("ssd_bwd_reduce", "13__nv_bfloat16")] + sorted({
            (f"{kind}_kernel", "Li{}ELi{}E".format(*rn.launch_shape(
                n, d, torch.bfloat16, backward=kind == "rms_bwd")[:2]))
            for _, call, n, ds in RMS_CALLS for d in ds
            for kind in _rms_kinds(call)})
    for name, log in logs.items():
        what = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
                bf16 = "13__nv_bfloat16" in entry or "sm90b" in entry
                what = next((f"{'fp32' if t.startswith('If') else 'bf16'} "
                             f"{k} {t}" for k, t in shown
                             if k in entry and t in entry
                             and (bf16 or t.startswith("If"))), None)
            elif what and ("Used" in line or "spill" in line):
                print(f"  {name} {what}: "
                      f"{line.split(':', 1)[-1].strip()}")
    print("HGMMA instructions in the SASS:", json.dumps(hgmma_counts(build)))

    # wall seconds of each phase and of each part of phase 3
    seconds = {"1 environment and build": time.perf_counter() - t_start}
    mark = time.perf_counter()

    def done(what):
        nonlocal mark
        now = time.perf_counter()
        seconds[what] = now - mark
        mark = now
        print(f"phase {what}: {seconds[what]:.1f} s", flush=True)

    # 1b. the paper's runtime on the card's host, beside the CUDA context
    conformance = Conformance()
    runtime_numbers = run_process_runtime(conformance=conformance)
    print("process runtime:", json.dumps(runtime_numbers, default=str))
    done("1b runtime")

    # 1c. the invariant checker: static rules and the explorer here, the
    # live streams' sinks where their runs are (1b, 3), the summary last
    conformance.static_and_explore()
    done("1c conformance (a, b)")

    # 2. kernels against their plain versions
    # phase 4's inputs wait on the host: the slices of phase 3 need the
    # card's memory (deepseek-v3's 50.9 GB of weights did not fit beside
    # them once the wide training shapes joined)
    inputs = _to(check_kernels(), "cpu")
    torch.cuda.empty_cache()
    done("2 kernels")

    # 3. the slices: serving, then training
    launches, rms_calls = {}, {}
    for arch, widths, layers in SLICES:
        if arch == MUSIC_ARCH:
            launches[arch], rms_calls[arch] = run_codebook_slice(
                arch, widths, card)
        elif arch == VISION:
            launches[arch], rms_calls[arch] = run_vision_slice(
                arch, widths, layers, card)
        else:
            launches[arch], rms_calls[arch] = run_slice(
                arch, widths, layers, card, conformance)
        done(f"3 {arch}")
        if arch == LONG_ARCH:
            launches[LONG_KEY], rms_calls[LONG_KEY] = long_context_check()
            done(f"3 {LONG_KEY}")
    launches[TRAIN_KEY], rms_calls[TRAIN_KEY], llama = run_training(card)
    done(f"3 {TRAIN_KEY}")
    launches[COORD_KEY], rms_calls[COORD_KEY] = run_coordinator(
        card, conformance=conformance)
    done(f"3 {COORD_KEY}")
    launches[ZTRAIN_KEY], rms_calls[ZTRAIN_KEY], _ = run_training(
        card, ZTRAIN_ARCH, ZTRAIN_KEY)
    done(f"3 {ZTRAIN_KEY}")
    launches[ZCOORD_KEY], rms_calls[ZCOORD_KEY] = run_coordinator(
        card, ZTRAIN_ARCH, conformance)
    done(f"3 {ZCOORD_KEY}")
    for arch, key in ((XLSTM_ARCH, XTRAIN_KEY), (MUSIC_ARCH, MTRAIN_KEY)):
        launches[key], rms_calls[key], _ = run_training(card, arch, key)
        done(f"3 {key}")
    run_optimized(card, llama)
    run_remat(card)
    run_optimizers(card, llama)
    done("3 optimized, remat, optimizers")
    for arch, key in WIDE_KEYS.items():
        launches[key], rms_calls[key], _ = run_training(card, arch, key)
        done(f"3 {key}")

    # 5. the sharded step and the dry-run (before the numbers, whose
    # launch counts are those of phase 3)
    run_sharded()
    done("5 sharded")

    # 4. numbers
    rows = kernel_numbers(inputs, launches, rms_calls, card)
    done("4 numbers")
    conformance.report(card)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s, the kernel "
          f"build included")
    print("phase seconds:", json.dumps(seconds))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
