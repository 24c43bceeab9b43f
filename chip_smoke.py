#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

Run from a checkout of the repository, on a machine with a CUDA card::

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. **build** — nvcc builds the kernels' shared library from
   ``src/repro_torch/csrc`` (or finds a fresh build); the ptxas report
   (registers, spills) of the Hopper flash kernel, the weave kernel and
   the interface kernel, and the flash kernel's shared memory.
2. **kernels** — each per-call CUDA kernel against its plain PyTorch
   version on the card: ``frfcfs_select`` and ``decode_packed`` bit for
   bit over the main path's shapes, then ``frfcfs_select`` timed at the
   Mess sweep's dense batch and ``decode_packed`` at the trace route's
   former window batch (and at the sweep's); ``flash_attention`` at the
   shapes of ``tests/test_kernels.py``
   plus a decode (Sq = 1) and a ragged query tile at D = 128 and 64, in
   fp32 (within 2e-6) and bf16 (within 2e-2), each check on the route
   that ``route`` gives it (bf16 at D 64, 80 or 128: the Hopper kernel;
   the rest: the CUDA-core kernel), at a causal shape with Sq > Sk (rows
   that see no key must be exactly 0), at the LM path's shape, where both
   routes are timed beside ``scaled_dot_product_attention`` as a
   yardstick (the Hopper route in bf16, the CUDA-core route in fp32 and
   on the same bf16 inputs), and at zamba2's shared block (B 2, H 32, S
   2048, D 80, causal), the Hopper route's D 80 instance timed the same
   way.
3. **inject** — the two routes of the bound phase and interface hand-off
   on the card, window by window on the same state (4 windows, four
   points, the queues partly full after the first): ``window_inject``
   (one launch per window) against the eager ``generate`` ->
   ``inject_queue`` -> ``update`` (whose Skylake decode is one
   ``decode_packed`` launch), bit for bit in the seven queue planes, the
   core state, ``injected`` and ``l_ir_cycles``, on stages 01 (simple),
   05 and 07 (Skylake XOR, without and with prefetch) on ddr4_2666 (one
   and two sockets, interleaved and partitioned), stages 07 and 01 on
   ddr5_4800 (xor_fold and simple) and 07 on hbm2e (xor_fold; one and
   two sockets).  Then the trace instance, ``window_inject_trace``,
   against the eager ``bound`` -> ``inject_queue`` -> ``update`` on the
   same card state and against the eager route on the CPU from that
   state, window by window (4 windows), bit for bit in the queue, every
   ``TraceState`` field, ``injected`` and ``l_ir_cycles``: the six apps
   (a ``Trace`` batch) and the three mixes (a ``TraceMix`` batch) on
   ddr4_2666, ddr5_4800 and hbm2e, one and two sockets, all three
   decodes.
4. **weave** — the two weave routes on the card, window by window on
   the same injected state (3 windows, paces 4 and 48): ``weave_window``
   (one launch per window) against the stepwise loop (``dram.tick`` /
   ``next_event`` with one ``frfcfs_select`` launch per step), bit for
   bit in every state field, stat, event count and saturation flag, on
   ddr4_2666 (1 and 2 sockets), ddr5_4800 (REFsb, the row-hit-capped
   ``ramulator2`` flavor) and hbm2e (the stage-10 delay buffer), each
   dense and event; then the card's fused route against the CPU's
   stepwise route on one case.  The launch counts of this phase give
   ``frfcfs_select``'s row.
   **telemetry** (run after phase 6, so that the main path's host
   timing follows the same phases as before) — the same grid with both
   recorders on: the recording
   instance of ``weave_window`` (``<true, true>``) against the stepwise
   loop with ``dram.tick``'s flags, on the card, bit for bit in every
   state field, stat, ``tele_*`` plane, ``TeleState`` and ``cmd_*``
   field; the plain instance on the same state gives the same state and
   stats (the flags move nothing); the event engine with a budget that
   covers the window gives the dense planes.
5. **main_path** — the repository's default benchmark run of the full
   paper stack: ``sweep(get_stage("07-prefetch", windows=48,
   warmup=16), paces=(1, 4, 12, 24, 48, 64), write_mixes=(0, 16, 32))``
   on ``ddr4_2666``, with every kernel's launch count and the weave
   steps read just after: ``window_inject`` and ``weave_window`` x 96
   each (48 windows x two engine batches), 40,032 weave steps,
   ``frfcfs_select`` and ``decode_packed`` x 0.  Then the same sweep
   under ``torch.profiler`` (a ``profile`` line: the two kernels' device
   time, the device's idle share), ``weave_window`` and
   ``window_inject`` timed at the sweep's two batches beside their plain
   routes on the same state (``weave_timing``, ``inject_timing``),
   ``window_inject_trace`` at the replay ladder's batch
   (``trace_inject_timing``), and a ``main_path_weave`` line: the
   sweep's wall, the weave phase's device time, µs per step.
6. **parity** — one stage-07 ``run_point`` on the card (the fused
   route) and on the CPU (the stepwise route) through the same port:
   equal integers, float views within 1e-6.
7. **replay** — the application perspective on the trace route (one
   ``window_inject_trace`` and one ``weave_window`` launch per window
   batch): the six apps (``n=2048``, 4 windows) at stages 01, 07
   and 10 and the three mixes of ``app_validation.MIXES`` on two sockets
   at stage 10, card against CPU (counts, cursors and runtimes equal,
   float views within 1e-6); then the validation ladder at its full
   setting (``app_validation.run_preset("ddr4_2666", full=True)``: 6
   apps x 8192 accesses, 96 windows, five stages) with each stage's
   wall, host ms per window batch, runtimes, MAPE (within 5e-5 of the
   JAX package's CPU values), dense re-runs and launches
   (``weave_window`` >= 96 and as many ``window_inject_trace`` at every
   stage, ``window_inject`` and ``decode_packed`` 0), the
   multiprogrammed ladder (``run_mixes``, FAST), and stage 10 once
   more under ``torch.profiler`` (device time by kernel, idle share).
   The ladder runs with telemetry, as the reference's does (the
   telemetry instance of ``weave_window``, the ``if_p50/95/99`` per app).
   The ladder's launches give ``window_inject_trace``'s and
   ``decode_packed``'s rows.
8. **perspectives** — the port's ``bench.perspectives`` ladder (stages
   01-10, one STREAM + GUPS mix, telemetry on) at ``SMOKE`` on the card,
   every ladder value held within 1e-9 of the reference's
   ``reports/benchmarks/perspectives.json`` (read, never written) and its
   summaries equal; 240 telemetry launches, and no other weave instance,
   240 ``window_inject_trace`` launches and no ``decode_packed``;
   stages 01 and 10 at 4 windows on the card against the CPU (planes and
   summaries equal); then ``FULL`` (96 windows, n = 2^17), the paper's
   setting: wall, host ms per window batch, the ladder.  The SMOKE
   ladder's launches give the recording instance's row.
9. **cmd_oracle** — the port's ``bench.cmd_oracle`` SMOKE cells on the
   card (both engines with ``cmd_trace``): equal dense and event streams,
   no protocol violation, equal stream statistics, one exported
   ``.cmd.trace`` validated; one DDR5 cell's card stream (and raw
   records) against its CPU stream.  Then ``record_timing``: the
   recording instance (both recorders) at the Mess sweep's window 8 and
   at the perspectives ladder's batch, beside the plain instance.
10. **lm_path** — the dense LM serving path at the full width and depth
   of tinyllama-1.1b (bf16, weights from a seed, flash kernel on): five
   forwards over 2 x 2048 tokens (each 22 launches of the Hopper route,
   none of the CUDA-core one; the median wall gives tokens/s), one more
   forward under ``torch.profiler``
   (device time by kernel and the device's idle share, a ``profile``
   line), prefill of the first 2047 tokens (22 Hopper launches) + one
   decode step agreeing with the forward's last position, and the
   greedy Engine answering 8 requests on 4 slots.
11. **lm_parity** — the port's forward at tinyllama widths, 2 layers,
   256 tokens, fp32 (the CUDA-core route), on the card and on the CPU
   (plain version), from the same weights, within 1e-4.
11b. **lm_families** — the five other families on the serving path, each
   at its published full width in bf16 with weights from seed 0 and the
   flash kernel on (grok-1-314b on the chunked route, which applies its
   logit softcap; the vision model's cross gates opened to 0.5):
   grok-1-314b at 2 of its 64 layers over 1 x 2048 tokens (one dispatch
   group), xlstm-1.3b, zamba2-2.7b and llama-3.2-vision-11b over 2 x 2048
   (the vision model with 2 x 1600 patches), whisper-large-v3 over 2 x
   448 decoder tokens and 2 x 1500 frames.  Per family: (a) three timed
   forwards (median tokens/s, flash launches by route asserted: one per
   attention layer, all on the Hopper route, zamba2's D 80 included;
   peak memory) and one profiled (idle share); one more
   forward with every flash call held against the plain version on its
   inputs (within 2e-2); (b) the decode check, grok-1 by prefill of
   2047 tokens + one decode step (at the capacity that drops no token;
   the timed forward's drops counted), the others by decoding the last
   16 tokens step by step from a fresh state (after ``fill_ctx``)
   against a forward over them, in fp32 on the same weights within
   6e-3(1 + |x|) (grok-1's chunked route: relative L2 within 2^-8) and
   in bf16, whose decode must lie within twice the bf16 forward's
   relative L2 distance from the fp32 forward, or within 2e-2 (the bf16
   gap to the forward printed beside 1/16 + 2e-2|x|; the bf16 run's
   flash calls checked as in (a)), argmax agreement printed; (c) the
   Engine, 4 slots, 8 requests of 4-16 prompt tokens and 16 new each (a
   per-slot ctx for the vision and audio families): ms per tick,
   tokens/s, flash launches per tick.  Then each family at full width
   and the fewest layers its layout allows (grok-1 1, xlstm 8, zamba2
   6, vision 5, whisper 1 + 1), fp32, 1 x 256 tokens (the ctx at full
   length), card against CPU within 1e-4, with the host RAM it took;
   grok-1 at its configured capacity factor (tokens dropped): the
   card's routing of the CPU's gates bit for bit, every top-k flip a
   near-tie, kept slots, dispatch and combine compared, and the logits
   of the tokens that kept the same experts within 5e-4 relative L2;
   then ``flash_attention`` at the families' shapes (whisper's encoder,
   decoder self- and cross-attention, the vision self- and
   cross-attention, the cross-attention at Sq = 1 too, zamba2's D 80 on
   the Hopper route) against its plain version, timed beside its bound
   and ``scaled_dot_product_attention``.
11c. **train** — the training path on the card: (a) tinyllama-1.1b at
   full width and depth (22 layers, d 2048, ~1.10 B parameters), fp32
   master params and bf16 compute, the chunked attention with every block
   recomputed, through ``Trainer`` on batches of the synthetic stream (B 4
   x S 2048): one warm step and five timed (median s/step, tokens/s, the
   losses and pre-clip norms, peak memory, the model-FLOP share 6N +
   12·L·S·d a token over 989 TFLOP/s), one more step under
   ``torch.profiler`` (a ``profile`` line: device time by kind — bf16 and
   fp32 products, the optimizer by correlation id, copies, reductions,
   elementwise — and the idle share), AdamW alone beside its bytes bound,
   then one timed step of a fresh Trainer with the int8 round trip; every
   loss and norm finite, the params moved, and 0 launches of every
   hand-written kernel (no kernel has a backward); (b) one ``accum=2``
   fp32 step on the card and on the CPU from the same weights at
   tinyllama widths (2 layers, 2 x 256 tokens) and at each family's small
   config: the loss within 1e-5 relative, the norm within 1e-4, each
   gradient element within 1e-4 relative + 1e-6 + 2e-3 of its leaf's
   largest magnitude, the new params within 1e-5 where the gradient's
   sign is certain and within 2 lr elsewhere (the tests' rule); (c) at
   the smoke width a Trainer fits 20 steps with a checkpoint every 5 (2
   kept), a fresh Trainer resumes with every leaf bit-equal, and
   ``prune`` keeps what it is told (no full-width checkpoint: 17.6 GB to
   disk); one ``train`` line.  The kernel table gives each kernel's
   launches in (a) as ``train_step_launches``.
12. **serving** — LLM-serving traffic (``bench.serving``, stage 10 with
   telemetry, the event engine under a budget of a whole window's
   ticks): (a) the SMOKE grid through ``serving.main`` on the card, every
   cell held against the reference's tracked
   ``reports/benchmarks/BENCH_serve.json`` (read, never written): the
   integer fields exactly, the floats within 1e-6 relative, 6 telemetry
   ``weave_window`` launches a preset; (b) the reference's serving golden
   grid (4 cells of ``tests/test_serving.py``: stages 01/04/10, three
   presets, one and two sockets, smoke configs), dense == covering-budget
   event on the card in every view and window output, no ``weave_sat``;
   (c) the FULL grid (4 models x 3 presets x 3 rates, 24 requests, 12
   windows): wall per preset and per cell, 12 telemetry and 12
   ``window_inject_trace`` launches a preset, no ``decode_packed``; (d) the
   FULL ddr4_2666 batch (12 scenarios) in 2 windows on the card and on
   the CPU, equal bit for bit in every view, count and ``tele_*`` plane;
   then the ddr4_2666 replay once more under ``torch.profiler``.
13. **figures** — every figure script of the port at FULL (14 paces x 5
   mixes, 96 windows) on the card: Fig. 2 on all three presets, Figs.
   3/4, 5, 6 and 7, CSVs into a temporary directory; each derived number
   beside the paper's value, each figure's wall and launches
   (``window_inject`` == ``weave_window``, no other kernel), each
   sweep's wall on its ``sweep.`` line; then stage 10 on ddr5_4800 and
   hbm2e, one and two sockets (6 windows, paces 1 and 24), and stage 07
   on ddr4_2666 and hbm2e at the FULL 70-point grid (2 windows, the
   points split between the two engines' batches as the figures split
   them; ``window_inject``'s Skylake decode), card against CPU, every
   view equal bit for bit.
14. **weave_bench** — ``bench.weave_bench`` at FULL on the card: per
   preset the dense and event sweep walls, the per-pace events and the
   event-rate fit beside the tracked calibration report's fit (the one
   ``mess.load_event_calibration`` registers), and the step
   reduction equal to ``weave_budgets(preset)["picosecond"]``.
15. **placement** — the batch axis split into chunks (``core.shard``):
   (a) the main path's FAST sweep (its engine, ``mess._run_points``, over
   the 18 points) on ``device=[cuda:0] * k`` for k = 1-4, every view
   and count equal to k = 1 bit for bit (and the main path's
   ``device=None`` views to k = 1), ``window_inject`` == ``weave_window``
   == k x 48 per engine batch, no ``decode_packed``, each wall printed;
   over every card too when the host has more than one, else a line
   saying that only one card was present; (b) stage 10 at
   ``app_validation.FULL`` (six apps, telemetry) on ``[cuda:0] * 4``
   equal to one device bit for bit, at the stage's event budget and at
   one of 48 that sends every row to the dense re-run (merged by row);
   (c) ``python -m repro_torch.bench.run`` in processes of its own:
   ``--list`` (the 12 names), ``--only kernels`` (every row matching its
   plain version; its device µs go into the kernel table as
   ``kernels_bench_device_us``) and ``--only fig5``, whose CSV equals a
   direct ``fig5_model_correct.main`` run's.

Then the kernel table (``{"kernels": [...]}``), the card's name and
power limit as nvidia-smi reports them, and the result line.  Any
failure raises: the script then exits non-zero and prints no result.
Without a card, or without the repository beside it, it exits non-zero.
"""
import contextlib
import ctypes
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# time_ms: mean ms per eager call by CUDA events; device_ms: mean device
# ms per launch, launches captured in one CUDA graph and replayed; the
# main path's batches and the kernels' C entry points on them
from repro_torch.bench.kernels_bench import (  # noqa: E402
    decode_launch, device_ms, inject_launch, sweep_state, time_ms,
    weave_launch, weave_state)

MEM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (published peak)
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor cores
FP32_FLOP_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
FAST_PACES = (1, 4, 12, 24, 48, 64)
FAST_MIXES = (0, 16, 32)
RTOL = 1e-6

# flash_attention checks: (b, hq, hkv, sq, sk, d, causal)
FLASH_SHAPES = [(2, 4, 4, 128, 128, 64, False), (2, 4, 2, 128, 128, 64, True),
                (1, 8, 1, 200, 200, 64, True), (2, 4, 1, 64, 384, 128, True),
                (1, 2, 2, 1, 300, 80, True), (1, 4, 2, 257, 512, 32, True),
                (1, 2, 2, 1, 300, 128, True), (1, 4, 2, 257, 512, 64, True)]
FLASH_EMPTY_ROWS = (1, 4, 2, 96, 40, 64, True)    # 56 rows see no key
# zamba2-2.7b's shared attention block (Hq = Hkv = 32, D = 80) at its
# 2 x 2048-token forward: the Hopper route's D 80 instance
FLASH_D80 = (2, 32, 32, 2048, 2048, 80, True)
FLASH_TOL = {torch.float32: 2e-6, torch.bfloat16: 2e-2}
LM_ARCH, LM_B, LM_S = "tinyllama-1.1b", 2, 2048
LM_FORWARDS = 5                # timed forwards; launches are per forward
FLASH_SLICE = (LM_B, 32, 4, LM_S, LM_S, 64, True)   # tinyllama prefill
# prefill + decode against the forward, both bf16 over 22 layers: the two
# routes round activations to bf16 at different places (attention over
# the cache vs the flash kernel, each layer), and the logits themselves
# are bf16, whose ulp is 2^-6 at |x| in [2, 4).  Bound: |d| <= 1/16 +
# 2e-2 |forward| per logit and a relative L2 error <= 2e-2.
LM_ATOL, LM_RTOL = 0.0625, 2e-2
# card vs CPU in fp32 (TF32 off): the products sum 2048-5632 terms in
# another order than the CPU's BLAS (~1e-5 relative), over 2 layers and
# the 32000-wide head; the kernel adds at most 2e-6.
PARITY_TOL = 1e-4
# lm_families: (arch, layers run, batch, decoder tokens) at full width,
# bf16, weights from seed 0, the flash kernel on (grok-1: the chunked
# route, which applies its logit softcap); grok-1 at 2 of its 64 layers
# (one layer's experts are 19.3 GB in fp32) and one dispatch group
FAMILY_RUNS = [("grok-1-314b", 2, 1, 2048), ("xlstm-1.3b", None, 2, 2048),
               ("zamba2-2.7b", None, 2, 2048),
               ("whisper-large-v3", None, 2, 448),   # the decoder context
               ("llama-3.2-vision-11b", None, 2, 2048)]
FAMILY_FORWARDS = 3             # timed forwards (median)
FAMILY_DECODE = 16              # tokens decoded against a forward
FAMILY_GATE = 0.5               # the vision model's cross gates (0 at init)
# decode against the forward in fp32: the reference's invariant
# (tests/test_models.py, decode == forward at 6e-3)
FAMILY_FP32_TOL = 6e-3
# the chunked route rounds probabilities to bf16 (as the reference's
# does): against the exact attention over the cache that a decode step
# runs, a probability moves by up to one bf16 step, 2^-8 of itself; its
# fp32 decode check holds the logits' relative L2 error to that step
# (2.57e-3 measured for grok-1 at 2 layers on an H100)
CHUNKED_REL_L2 = 2.0 ** -8
# decode against the forward in bf16: the decode's relative L2 distance
# from the fp32 forward (same weights) within this multiple of the bf16
# forward's own, or within LM_RTOL.  In the reference's bf16 model too
# the decode and the forward part by a few bf16 steps, more with depth
# (tests/test_torch_models.py, at zamba2's and xlstm's depths)
BF16_DECODE_MULT = 2.0
FAMILY_PARITY_S = 256           # card vs CPU, fp32, the fewest layers
# grok-1 card vs CPU (fp32, the chunked route, the configured capacity
# factor): the logits' relative L2 error over the tokens that kept the
# same experts on both sides; 1.33e-4 measured at capacity factor 4 on
# an H100, the limit a little under four times that
MOE_PARITY_REL_L2 = 5e-4
# flash_attention at the families' shapes: (what, (b, hq, hkv, sq, sk, d,
# causal)); the decode shapes at the Engine's 4 slots
FAMILY_FLASH = [
    ("whisper encoder", (2, 20, 20, 1500, 1500, 64, False)),
    ("whisper decoder self-attention", (2, 20, 20, 448, 448, 64, True)),
    ("whisper cross", (2, 20, 20, 448, 1500, 64, False)),
    ("whisper cross, decode tick", (4, 20, 20, 1, 1500, 64, False)),
    ("vision self-attention", (2, 32, 8, 2048, 2048, 128, True)),
    ("vision cross", (2, 32, 8, 2048, 1600, 128, False)),
    ("vision cross, decode tick", (4, 32, 8, 1, 1600, 128, False)),
    ("zamba2 shared block", (2, 32, 32, 2048, 2048, 80, True))]
# train (phase 11c): tinyllama-1.1b at full width and depth, fp32 master
# params, bf16 compute, the chunked attention with every block
# recomputed, B x S tokens a step from the synthetic stream
TRAIN_ARCH, TRAIN_B, TRAIN_S = "tinyllama-1.1b", 4, 2048
TRAIN_TIMED = 5                 # timed steps after one warm step (median)
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=100)
# card vs CPU in fp32, one step at accum 2: tinyllama widths at 2 layers
# over 2 x 256 tokens, then one small config per family (get_smoke)
TRAIN_PARITY_LAYERS, TRAIN_PARITY_B, TRAIN_PARITY_S = 2, 2, 256
TRAIN_FAMILY_ARCHS = ("tinyllama-1.1b", "grok-1-314b", "xlstm-1.3b",
                      "zamba2-2.7b", "llama-3.2-vision-11b",
                      "whisper-large-v3")
TRAIN_FAMILY_B, TRAIN_FAMILY_S = 4, 16
TRAIN_LR = 1e-3
TRAIN_LOSS_RTOL, TRAIN_NORM_RTOL = 1e-5, 1e-4
# the tests' rule (tests/test_torch_train_families.py): each gradient
# element within 1e-4 relative + 1e-6 absolute + 2e-3 of its leaf's
# largest magnitude (the chunked route rounds probabilities to bf16, and
# an ulp of exp can round one the other way); new params within 1e-5
# where the gradient's sign is certain, elsewhere within 2 lr
TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL, TRAIN_FLIP_SCALE = 1e-4, 1e-6, 2e-3
TRAIN_PARAM_ATOL, TRAIN_GRAD_SMALL = 1e-5, 1e-5
# checkpoints on the card: the smoke width, 20 steps, one every 5, 2 kept
TRAIN_CKPT_STEPS, TRAIN_CKPT_EVERY, TRAIN_CKPT_KEEP = 20, 5, 2


# weave phase: (stage, preset, sockets, engine), each WEAVE_WINDOWS
# windows of two points through the fused and the stepwise route
WEAVE_CASES = [("07-prefetch", "ddr4_2666", 1, "dense"),
               ("07-prefetch", "ddr4_2666", 1, "event"),
               ("07-prefetch", "ddr4_2666", 2, "dense"),
               ("07-prefetch", "ddr4_2666", 2, "event"),
               ("09-ramulator2", "ddr5_4800", 1, "dense"),
               ("09-ramulator2", "ddr5_4800", 1, "event"),
               ("10-delay-buffer", "hbm2e", 1, "dense"),
               ("10-delay-buffer", "hbm2e", 1, "event")]
WEAVE_WINDOWS, WEAVE_PACES, WEAVE_WR = 3, (4, 48), 16
WEAVE_CPU_CASE = ("07-prefetch", "ddr4_2666", 1, "event")
MAIN_WEAVE_STEPS = 48 * (635 + 199)     # windows x (dense + event steps)
MAIN_WEAVE_LAUNCHES = 96                # windows x engine batches
MAIN_INJECT_LAUNCHES = 96               # windows x engine batches

# inject phase: (stage, preset, sockets, channel ownership), each
# INJECT_WINDOWS windows of INJECT_POINTS through both routes
INJECT_CASES = [("01-baseline", "ddr4_2666", 1, "interleaved"),   # simple
                ("05-addrmap", "ddr4_2666", 1, "interleaved"),    # skylake
                ("07-prefetch", "ddr4_2666", 1, "interleaved"),   # + pf
                ("07-prefetch", "ddr4_2666", 2, "interleaved"),
                ("07-prefetch", "ddr4_2666", 2, "partitioned"),
                ("07-prefetch", "ddr5_4800", 1, "interleaved"),   # xor_fold
                ("07-prefetch", "ddr5_4800", 2, "partitioned"),
                ("01-baseline", "ddr5_4800", 1, "interleaved"),   # simple
                ("07-prefetch", "hbm2e", 1, "interleaved"),       # xor_fold
                ("07-prefetch", "hbm2e", 2, "partitioned")]
INJECT_WINDOWS = 4
INJECT_POINTS = ((1, 0), (12, 16), (48, 32), (64, 48))    # (pace, wr_num)
# the trace instance: (stage, preset, sockets, channel ownership,
# container), each INJECT_WINDOWS windows of the six apps (a Trace
# batch) or of app_validation's three mixes (a TraceMix batch) through
# the instance, the eager route on the card and the eager route on the
# CPU, from the same state
TRACE_INJECT_CASES = [
    ("07-prefetch", "ddr4_2666", 1, "interleaved", "trace"),   # skylake
    ("10-delay-buffer", "ddr4_2666", 2, "partitioned", "mix"),
    ("01-baseline", "ddr5_4800", 1, "interleaved", "trace"),   # simple
    ("07-prefetch", "ddr5_4800", 2, "interleaved", "mix"),     # xor_fold
    ("10-delay-buffer", "hbm2e", 1, "interleaved", "mix"),
    ("07-prefetch", "hbm2e", 2, "partitioned", "trace")]

# replay phase: the six apps through the card's trace route and the CPU's
# eager route, then the validation ladder at its full setting
REPLAY_N, REPLAY_WINDOWS, REPLAY_WARMUP = 2048, 4, 1
REPLAY_STAGES = ("01-baseline", "07-prefetch", "10-delay-buffer")
REPLAY_MIX_STAGE, REPLAY_MIX_SOCKETS = "10-delay-buffer", 2
# exact on both routes: the counts, cursors and the runtimes made of them
REPLAY_EXACT = ("progress", "runtime_windows", "done", "n_rd", "n_wr",
                "injected", "weave_events", "weave_sat", "progress_final",
                "core_runtime_windows", "core_done", "app_runtime_windows",
                "app_done")
LADDER_PROFILED_STAGE = "10-delay-buffer"
# the FULL ladder's MAPE (%) per stage, the JAX package's CPU run of
# ``benchmarks/app_validation.py --full`` (PERF.md), to its 4 decimals
LADDER_MAPE_REF = {"01-baseline": 36.1302, "03-ps-clock": 32.1636,
                   "04-model-correct": 12.7073, "07-prefetch": 18.0374,
                   "10-delay-buffer": 24.9727}
LADDER_MAPE_ATOL = 5e-5

# placement phase: the sweep split into k chunks on one card, the FULL
# stage-10 replay in 4 chunks at the stage's event budget and at one that
# sends every row to the dense re-run, and the benchmark CLI
PLACEMENT_SPLITS = (1, 2, 3, 4)
PLACEMENT_REPLAY_STAGE = "10-delay-buffer"
PLACEMENT_RERUN_BUDGET = 48
PLACEMENT_BENCH_ROWS = 6        # flash x 2 routes, select, decode, weave,
                                # inject


def emit(obj):
    print(json.dumps(obj), flush=True)


def select_inputs(rng, rows, q, dev, idle_rows=0):
    def grid(lo, hi):
        return torch.from_numpy(
            rng.integers(lo, hi, size=(rows, q), dtype="int32")).to(dev)

    planes = [grid(0, 2), grid(0, 2), grid(0, 8), grid(-1, 8),
              grid(0, 100), grid(0, 100), grid(0, 100), grid(0, 100),
              grid(0, 2), grid(0, 2), grid(0, 20)]
    planes[0][:idle_rows] = 0              # rows with no eligible entry
    scal = rng.integers(0, 100, size=(rows, 8), dtype="int32")
    scal[:, 0] = 50
    scal[:, 4] &= 1
    return planes, torch.from_numpy(scal).to(dev)


def chase_lines(rng, n, dev):
    lines = rng.integers(0, 2 ** 32, n, dtype="uint64")
    lines[::3] |= 1 << 31                  # pointer-chase lines: bit 31
    return torch.from_numpy(lines.astype("int64")).to(dev)


def flash_inputs(gen, shape, dtype, dev, model_layout=False):
    """q, k, v of ``shape``; ``model_layout``: (B,H,S,D) views of
    (B,S,H,D) tensors, as the model hands them to the kernel."""
    b, hq, hkv, sq, sk, d, _ = shape

    def draw(h, s):
        if model_layout:
            return torch.randn((b, s, h, d), generator=gen, device=dev,
                               dtype=dtype).transpose(1, 2)
        return torch.randn((b, h, s, d), generator=gen, device=dev,
                           dtype=dtype)

    return draw(hq, sq), draw(hkv, sk), draw(hkv, sk)


def core_launch(q, k, v, causal):
    """The CUDA-core kernel called straight through its C entry point on
    any input it takes (bf16 at D=64 included, which the wrapper routes
    to the Hopper kernel), to time both kernels on the same inputs.  Not
    counted: it bypasses the wrapper."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import default_scale, ops

    b, hq, sq, d = q.shape
    out = torch.empty((b, sq, hq, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    fn = _build.function("flash_attention_launch", ops._ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             *[s for x in (q, k, v, out) for s in x.stride()[:3]], b, hq,
             k.shape[1], sq, k.shape[2], d, ops._DTYPES[q.dtype],
             int(causal), default_scale(d),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_launch: error {err}")
    return out


def check_flash(dev):
    """flash_attention against its plain version on the card, through
    the wrapper, each check on the route the rule gives it; then, at the
    LM path's shape, each route's device time, eager call, plain
    version, bound and the library's fused attention, and the same for
    the Hopper route's D 80 instance at zamba2's shape (with the
    CUDA-core kernel on the same inputs, its route before)."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     mha_plain, route)

    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(s, dt) for s in FLASH_SHAPES + [FLASH_EMPTY_ROWS]
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(FLASH_SLICE, torch.bfloat16), (FLASH_D80, torch.bfloat16)]
    checked, failed = [], []
    worst = {}                              # per route and dtype
    for shape, dt in cases:
        q, k, v = flash_inputs(gen, shape, dt, dev,
                               model_layout=shape in (FLASH_SLICE, FLASH_D80))
        before = dict(flash_attention.launches_by_route)
        got = flash_attention(q, k, v, causal=shape[-1]).float()
        took = [r for r, n in flash_attention.launches_by_route.items()
                if n != before[r]]
        want = mha_plain(q, k, v, causal=shape[-1]).float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = FLASH_TOL[dt]
        ok = bool(torch.allclose(got, want, atol=tol, rtol=tol))
        ok &= took == [route(q, k, v)]
        empty = max(shape[3] - shape[4], 0) if shape[-1] else 0
        if empty:
            ok &= not bool(got[:, :, :empty].any())
        checked.append({"shape": list(shape), "dtype": str(dt)[6:],
                        "route": took, "max_abs_err": err, "tol": tol,
                        "ok": ok, "empty_rows": empty})
        for r in took:     # the Hopper route's D 80 instance apart
            key = (f"{r}{'_d80' if shape[5] == 80 and r == 'sm90_bf16' else ''}"
                   f"/{str(dt)[6:]}")
            worst[key] = max(worst.get(key, 0.0), err)
        if not ok:
            failed.append(checked[-1])

    sdpa = torch.nn.functional.scaled_dot_product_attention
    timing = {}
    for name, shape, dt, peak in (
            ("sm90_bf16", FLASH_SLICE, torch.bfloat16, BF16_FLOP_PER_S),
            ("cuda_core", FLASH_SLICE, torch.float32, FP32_FLOP_PER_S),
            ("sm90_bf16_d80", FLASH_D80, torch.bfloat16, BF16_FLOP_PER_S)):
        b, hq, hkv, s, _, d, _ = shape
        if name == "sm90_bf16_d80":     # the visible pairs, exactly
            flops = 4 * b * hq * (s * (s + 1) // 2) * d
            formula = "4*B*Hq*S(S+1)/2*D FLOP"
        else:                           # QK^T and PV, causal half
            flops = 4 * b * hq * s * s * d / 2
            formula = "4*B*Hq*S^2*D/2 FLOP"
        q, k, v = flash_inputs(gen, shape, dt, dev, True)
        qc, kc, vc = (x.contiguous() for x in (q, k, v))
        io_bytes = sum(x.numel() * x.element_size() for x in (q, k, v, q))
        timing[name] = dict(
            ms=device_ms(lambda: flash_attention(q, k, v, causal=True), 20),
            call_ms=time_ms(lambda: flash_attention(q, k, v, causal=True),
                            20),
            plain_ms=time_ms(lambda: mha_plain(q, k, v, causal=True), 3),
            library_ms=device_ms(lambda: sdpa(qc, kc, vc, is_causal=True,
                                              enable_gqa=True), 20),
            flops=flops, bound_formula=f"{formula} / {peak:.3g} FLOP/s",
            bound_ms=flops / peak * 1e3,
            bytes_bound_ms=io_bytes / MEM_BYTES_PER_S * 1e3,
            shape=f"B={b} Hq={hq} Hkv={hkv} S={s} D={d} {str(dt)[6:]} "
                  f"causal")
        if name != "cuda_core":
            # the CUDA-core kernel on the same bf16 inputs (their route
            # before the Hopper kernel), for the speed-up within this run
            timing[name]["cuda_core_same_inputs_ms"] = device_ms(
                lambda: core_launch(q, k, v, True), 10)
    emit({"phase": "kernels", "kernel": "flash_attention",
          "checked": checked, "max_abs_err": worst, "timing": timing})
    if failed:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version or its route: {failed}")
    return worst, timing


def device_events(prof):
    """The profile's device events, each with ``name`` and ``time_range``
    (µs), read from the raw kineto events: parsing every event into a
    FunctionEvent (``prof.events()``) takes tens of seconds for a forward
    of ~10^5 launches (xlstm's)."""
    from types import SimpleNamespace

    cuda = torch.autograd.DeviceType.CUDA
    return [SimpleNamespace(name=e.name(), time_range=SimpleNamespace(
        start=e.start_ns() / 1e3, end=e.end_ns() / 1e3))
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == cuda]


def profile_forward(api, params, batch, forward_wall_s, what):
    """One warm forward under torch.profiler: device time by kernel name
    and by kind, and the device's idle share, over the profiled forward
    and over ``forward_wall_s``, the same forward's wall-clock without
    the profiler (whose own host cost varies between machines).  Emits a
    ``profile`` line and returns it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        api.forward(params, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_events = device_events(prof)
    out = {"phase": "profile", "what": what, "wall_ms_profiled":
           wall_us / 1e3, "device_events": len(dev_events)}
    if not dev_events:
        out["note"] = "the profiler showed no device time on this machine"
        emit(out)
        return out
    busy, window = device_busy(dev_events)
    by_name, by_kind = {}, {}
    kinds = (("attention", ("flash",)),
             ("matmul", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
             ("copy/cast", ("copy", "memcpy", "memset")),
             ("reduction", ("reduce",)),
             ("elementwise", ("elementwise",)))
    for e in dev_events:
        us = e.time_range.end - e.time_range.start
        n, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (n + us, c + 1)
        low = e.name.lower()
        kind = next((k for k, words in kinds
                     if any(w in low for w in words)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    out.update(device_window_ms=window / 1e3, device_busy_ms=busy / 1e3,
               idle_share_of_window=1 - busy / window,
               idle_share_of_wall=1 - busy / wall_us,
               idle_share_of_unprofiled_wall=1 - busy / (forward_wall_s
                                                         * 1e6),
               by_kind_ms=by_kind,
               top_kernels=[{"name": n[:100], "ms": us / 1e3, "count": c}
                            for n, (us, c) in top])
    emit(out)
    return out


def check_routes(what, routes, n_layers):
    """The bf16 prefill takes the Hopper kernel once per layer, and the
    CUDA-core kernel never."""
    if routes != {"sm90_bf16": n_layers, "cuda_core": 0}:
        raise AssertionError(f"{what} launched flash_attention {routes}, "
                             f"not sm90_bf16 x {n_layers} and cuda_core x 0")


def max_diff(a, b):
    """Largest absolute difference over two trees of tensors, and whether
    they are bit-identical (floats compared by value, NaN-free)."""
    if isinstance(a, torch.Tensor):
        a, b = a.cpu(), b.cpu()
        if a.dtype == torch.bool:
            a, b = a.int(), b.int()
        diff = float((a.double() - b.double()).abs().max()) if a.numel() \
            else 0.0
        return diff, bool(torch.equal(a, b))
    if isinstance(a, dict):
        a, b = list(a.values()), [b[k] for k in a]
    worst, same = 0.0, True
    for x, y in zip(a, b):
        d, e = max_diff(x, y)
        worst, same = max(worst, d), same and e
    return worst, same


def inject_phase(dev):
    """Both routes of the bound phase and interface hand-off on the card,
    window by window on the same state: `window_inject` (one launch)
    must equal the eager route bit for bit in the queue, the core state,
    ``injected`` and ``l_ir_cycles``; the window loop goes on through
    `_window_step` (the card's routes), so the queues are partly full
    from the second window on."""
    from repro_torch import kernels
    from repro_torch.core import get_stage, platform, workload

    kernels.reset_launch_counts()
    rows, failed, worst = [], [], 0.0
    fused_s = eager_s = 0.0
    with torch.inference_mode():
        for case in INJECT_CASES:
            stage, preset, sockets, owner = case
            cfg = get_stage(stage, preset=preset, n_sockets=sockets,
                            socket_channels=owner, windows=INJECT_WINDOWS,
                            warmup=0)
            clock, wcfg = cfg.clock(), cfg.workload_config()
            paces = torch.tensor([p for p, _ in INJECT_POINTS],
                                 dtype=torch.int32, device=dev)
            wrs = torch.tensor([w for _, w in INJECT_POINTS],
                               dtype=torch.int32, device=dev)
            frontend = workload.MessFrontend(paces, wrs, wcfg)
            carry = platform._init_carry(cfg, frontend, len(paces), dev)
            same_all, injected, occupancy = True, 0, []
            for w in range(cfg.windows):
                occupancy.append(float(carry[0].valid.float().mean()))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fused = platform._bound_inject_fused(cfg, clock, wcfg,
                                                     frontend, carry, w)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                eager = platform._bound_inject_eager(cfg, clock, wcfg,
                                                     frontend, carry, w)
                torch.cuda.synchronize()
                fused_s += t1 - t0
                eager_s += time.perf_counter() - t1
                diff, same = max_diff(fused, eager)
                worst = max(worst, diff)
                same_all &= same
                injected += int(fused[2].sum())
                carry, _ = platform._window_step(cfg, clock, wcfg, frontend,
                                                 carry, w)
            rows.append({"case": list(case), "windows": cfg.windows,
                         "q": carry[0].valid.shape[-1],
                         "injected": injected,
                         "occupancy_before": occupancy,
                         "bit_identical": same_all})
            if not same_all or not injected or max(occupancy[1:]) <= 0:
                failed.append(case)
        counts = kernels.launch_counts()
    emit({"phase": "inject", "cases": rows, "windows": INJECT_WINDOWS,
          "points": [list(p) for p in INJECT_POINTS],
          "max_abs_diff": worst, "launches": counts, "fused_s": fused_s,
          "eager_s": eager_s})
    n_windows = 2 * len(INJECT_CASES) * INJECT_WINDOWS   # compared + loop
    if failed:
        raise AssertionError(f"window_inject and the eager route differ "
                             f"(or injected nothing): {failed}")
    if counts["window_inject"] != n_windows or counts["decode_packed"] <= 0:
        raise AssertionError(f"inject phase launches {counts}: expected "
                             f"{n_windows} window_inject, decode_packed > 0")
    return worst, counts["decode_packed"]


def trace_batch(kind, sockets):
    """The replay phase's inputs as a trace container on the CPU: the six
    apps (``n=REPLAY_N``) as a `Trace` batch, or app_validation's three
    mixes over ``sockets`` sockets as a `TraceMix` batch."""
    from repro_torch.bench.app_validation import MIXES
    from repro_torch.traces import (assign_traces, make_suite, split_cores,
                                    stack_mixes, stack_traces)

    if kind == "trace":
        return stack_traces(make_suite(n=REPLAY_N)[1])
    return stack_mixes([assign_traces(make_suite(n=REPLAY_N, names=k)[1],
                                      split_cores(len(k), 24 * sockets))
                        for _, k in MIXES])


def trace_inject_phase(dev):
    """The trace instance of `window_inject` against the eager route, on
    the same card state window by window, and against the eager route on
    the CPU from the same state moved there: bit for bit in the queue,
    every `TraceState` field, ``injected`` and ``l_ir_cycles``.  The
    window loop goes on through `_window_step` (the card's routes).
    Returns the largest difference and the eager route's
    `decode_packed` launches."""
    from repro_torch import kernels
    from repro_torch.core import get_stage, platform
    from repro_torch.traces import TraceFrontend, to

    kernels.reset_launch_counts()
    rows, failed, worst = [], [], 0.0
    fused_s = eager_s = 0.0
    with torch.inference_mode():
        for case in TRACE_INJECT_CASES:
            stage, preset, sockets, owner, kind = case
            cfg = get_stage(stage, preset=preset, n_sockets=sockets,
                            socket_channels=owner, windows=INJECT_WINDOWS,
                            warmup=0)
            clock, wcfg = cfg.clock(), cfg.workload_config()
            data = trace_batch(kind, sockets)
            on_card = TraceFrontend(to(data, dev), wcfg)
            on_cpu = TraceFrontend(data, wcfg)
            carry = platform._init_carry(cfg, on_card, on_card.batch, dev)
            same_all, cpu_same, injected, taken = True, True, 0, 0
            for w in range(cfg.windows):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fused = platform._bound_inject_fused_trace(
                    cfg, clock, wcfg, on_card, carry, w)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                eager = platform._bound_inject_eager(cfg, clock, wcfg,
                                                     on_card, carry, w)
                torch.cuda.synchronize()
                fused_s += t1 - t0
                eager_s += time.perf_counter() - t1
                cpu = platform._bound_inject_eager(
                    cfg, clock, wcfg, on_cpu,
                    tuple(move_state(x, "cpu") for x in carry[:5]), w)
                diff, same = max_diff(fused, eager)
                diff_c, same_c = max_diff(fused, cpu)
                worst = max(worst, diff, diff_c)
                same_all &= same
                cpu_same &= same_c
                injected += int(fused[2].sum())
                taken += int((fused[1].pos - carry[2].pos).sum())
                carry, _ = platform._window_step(cfg, clock, wcfg, on_card,
                                                 carry, w)
            rows.append({"case": list(case), "windows": cfg.windows,
                         "points": on_card.batch,
                         "q": carry[0].valid.shape[-1],
                         "injected": injected, "accesses_taken": taken,
                         "bit_identical": same_all,
                         "bit_identical_to_cpu": cpu_same})
            if not (same_all and cpu_same and injected and taken):
                failed.append(case)
        counts = kernels.launch_counts()
    emit({"phase": "inject", "part": "trace", "cases": rows,
          "windows": INJECT_WINDOWS, "max_abs_diff": worst,
          "launches": counts, "fused_s": fused_s, "eager_s": eager_s})
    n_windows = 2 * len(TRACE_INJECT_CASES) * INJECT_WINDOWS
    if failed:
        raise AssertionError(f"window_inject_trace and the eager route "
                             f"differ (card or CPU), or nothing was "
                             f"injected: {failed}")
    if (counts["window_inject_trace"] != n_windows
            or counts["window_inject"] or counts["decode_packed"] <= 0):
        raise AssertionError(f"trace inject launches {counts}: expected "
                             f"{n_windows} window_inject_trace, no "
                             f"window_inject, decode_packed > 0 (the "
                             f"eager route's Skylake decode)")
    return worst, counts["decode_packed"]


def move_state(x, where):
    """A carry item (a tensor or a NamedTuple of tensors) on ``where``."""
    if isinstance(x, torch.Tensor):
        return x.to(where)
    return type(x)(*(t.to(where) for t in x))


def weave_case(case, dev, windows=WEAVE_WINDOWS):
    """The stage config, frontend and first carry of one weave case."""
    from repro_torch.core import get_stage, platform, workload

    stage, preset, sockets, engine = case
    cfg = get_stage(stage, preset=preset, n_sockets=sockets, weave=engine,
                    windows=windows, warmup=0)
    paces = torch.tensor(WEAVE_PACES, dtype=torch.int32, device=dev)
    frontend = workload.MessFrontend(
        paces, torch.full_like(paces, WEAVE_WR), cfg.workload_config())
    return cfg, frontend, platform._init_carry(cfg, frontend, len(paces),
                                               dev)


def weave_phase(dev):
    """Both weave routes on the card, window by window on the same
    injected state, over presets, engines, socket counts and backend
    flavors: the fused kernel must equal the stepwise loop (the
    `frfcfs_select` route) bit for bit in state, stats, event counts and
    saturation flags; the window loop goes on through `_window_step` (the
    card's route).  One case also against the CPU's stepwise route."""
    from repro_torch import kernels
    from repro_torch.core import platform

    kernels.reset_launch_counts()
    rows, failed, worst = [], [], 0.0
    stepwise_s = fused_s = 0.0
    with torch.inference_mode():
        for case in WEAVE_CASES:
            cfg, frontend, carry = weave_case(case, dev)
            clock, wcfg = cfg.clock(), cfg.workload_config()
            same_all, sat, served = True, 0, 0
            for w in range(cfg.windows):
                queue = platform._bound_inject(cfg, clock, wcfg, frontend,
                                               carry, w)[0]
                args = (cfg, clock, platform._tick_kw(cfg, clock, dev),
                        queue, carry[1], w)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fused = platform._weave_fused(*args)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                step = platform._weave_stepwise(*args)
                torch.cuda.synchronize()
                fused_s += t1 - t0
                stepwise_s += time.perf_counter() - t1
                diff, same = max_diff(fused, step)
                worst = max(worst, diff)
                same_all &= same
                sat += int(fused[4].sum())
                served += int(fused[2].served_rd.sum()
                              + fused[2].served_wr.sum())
                carry, _ = platform._window_step(cfg, clock, wcfg, frontend,
                                                 carry, w)
            rows.append({"case": list(case), "windows": cfg.windows,
                         "q": carry[0].valid.shape[-1], "served": served,
                         "bit_identical": same_all, "sat_windows": sat})
            if not same_all or not served:
                failed.append(case)
        counts = kernels.launch_counts()

        # the CPU's stepwise route on one case, from the same seeds
        cfg, fe_card, carry_card = weave_case(WEAVE_CPU_CASE, dev)
        _, fe_cpu, carry_cpu = weave_case(WEAVE_CPU_CASE, "cpu")
        clock, wcfg = cfg.clock(), cfg.workload_config()
        cpu_int_equal, cpu_rel = True, 0.0
        for w in range(cfg.windows):
            carry_card, (out_c, diag_c) = platform._window_step(
                cfg, clock, wcfg, fe_card, carry_card, w)
            carry_cpu, (out_p, diag_p) = platform._window_step(
                cfg, clock, wcfg, fe_cpu, carry_cpu, w)
            for got, ref in zip(list(carry_card[:2]) + list(out_c)
                                + list(diag_c.values()),
                                list(carry_cpu[:2]) + list(out_p)
                                + list(diag_p.values())):
                for g, r in (zip(got, ref) if isinstance(got, tuple)
                             else [(got, ref)]):
                    g = g.cpu()
                    if g.is_floating_point():
                        cpu_rel = max(cpu_rel, float(
                            ((g - r).abs() / r.abs().clamp(min=1e-30))
                            .max()))
                    else:
                        cpu_int_equal &= bool(torch.equal(g, r))
    out = {"phase": "weave", "cases": rows, "windows": WEAVE_WINDOWS,
           "paces": list(WEAVE_PACES), "wr_num": WEAVE_WR,
           "max_abs_diff": worst, "launches": counts,
           "fused_s": fused_s, "stepwise_s": stepwise_s,
           "cpu_case": list(WEAVE_CPU_CASE),
           "cpu_ints_equal": cpu_int_equal, "cpu_max_rel_err": cpu_rel}
    emit(out)
    n_windows = 2 * len(WEAVE_CASES) * WEAVE_WINDOWS  # compared + loop
    if failed:
        raise AssertionError(f"fused and stepwise weave differ: {failed}")
    if counts["weave_window"] != n_windows or counts["frfcfs_select"] <= 0:
        raise AssertionError(f"weave phase launches {counts}: expected "
                             f"{n_windows} weave_window, frfcfs_select > 0")
    if not cpu_int_equal or not cpu_rel <= RTOL:
        raise AssertionError(f"card fused vs CPU stepwise: ints equal "
                             f"{cpu_int_equal}, float rel {cpu_rel}")
    return worst, counts["frfcfs_select"]


def rec_diff(a, b):
    """`max_diff` over trees that may hold None (an unset recorder)."""
    if a is None or b is None:
        return (0.0, True) if a is None and b is None else (float("inf"),
                                                            False)
    if isinstance(a, (tuple, list)) and not isinstance(a, torch.Tensor):
        worst, same = 0.0, len(a) == len(b)
        for x, y in zip(a, b):
            d, e = rec_diff(x, y)
            worst, same = max(worst, d), same and e
        return worst, same
    return max_diff(a, b)


def telemetry_phase(dev):
    """The recording instances of `weave_window` on the card against the
    stepwise route on the card (`dram.tick` with the flags), window by
    window on the same injected state and telemetry carry, over the weave
    phase's grid: bit for bit in every state field, stat, ``tele_*``
    plane, ``TeleState`` and ``cmd_*`` field.  On each window also: the
    plain instance on the same state gives the same state and stats (the
    flags move nothing), and on the dense cases the event engine with a
    budget that covers the window gives the dense planes."""
    from repro_torch import kernels
    from repro_torch.core import dram, platform
    from repro_torch.kernels.weave_window import weave_window

    kernels.reset_launch_counts()
    rows, failed, worst = [], [], 0.0
    fused_s = stepwise_s = 0.0
    counts = {"tele": 0, "cmds": 0, "refs": 0, "idle_records": 0}
    with torch.inference_mode():
        for case in WEAVE_CASES:
            cfg0, frontend, carry = weave_case(case, dev)
            cfg = dataclasses.replace(cfg0, telemetry=True, cmd_trace=True)
            carry = carry[:5] + (dram.init_tele(
                cfg.platform.dram, len(WEAVE_PACES), dev),)
            clock, wcfg = cfg.clock(), cfg.workload_config()
            same_all = flags_neutral = engines_equal = True
            for w in range(cfg.windows):
                queue = platform._bound_inject(cfg, clock, wcfg, frontend,
                                               carry, w)[0]
                kw = platform._tick_kw(cfg, clock, dev)
                args = (clock, kw, queue, carry[1], w, carry[5])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fused = platform._weave_fused(cfg, *args)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                step = platform._weave_stepwise(cfg, *args)
                torch.cuda.synchronize()
                fused_s += t1 - t0
                stepwise_s += time.perf_counter() - t1
                diff, same = rec_diff(fused, step)
                worst = max(worst, diff)
                same_all &= same
                plain = platform._weave_fused(cfg0, *args[:-1])
                flags_neutral &= rec_diff(fused[:5], plain)[1]
                if cfg.weave == "dense":
                    full = dataclasses.replace(
                        cfg, weave="event",
                        weave_events=clock.ticks_per_window_static)
                    ev = platform._weave_fused(full, *args)
                    engines_equal &= rec_diff(fused[5][0], ev[5][0])[1]
                    engines_equal &= not bool(ev[4].any())
                cmds = fused[5][2]
                counts["tele"] += int(fused[5][0].n_cas_rd.sum())
                counts["cmds"] += int((cmds.cmd != 0).sum())
                counts["refs"] += int(cmds.ref.sum())
                counts["idle_records"] += int((cmds.cmd == 0).sum())
                carry, _ = platform._window_step(cfg, clock, wcfg, frontend,
                                                 carry, w)
            rows.append({"case": list(case), "windows": cfg.windows,
                         "bit_identical": same_all,
                         "flags_move_nothing": flags_neutral,
                         "event_planes_equal_dense": engines_equal})
            if not (same_all and flags_neutral and engines_equal):
                failed.append(case)
        launches = dict(kernels.launch_counts(),
                        by_instance=dict(weave_window.launches_by_instance))
    emit({"phase": "telemetry", "cases": rows, "windows": WEAVE_WINDOWS,
          "paces": list(WEAVE_PACES), "max_abs_diff": worst,
          "mismatched_cases": len(failed), "recorded": counts,
          "launches": launches, "fused_s": fused_s,
          "stepwise_s": stepwise_s})
    if failed:
        raise AssertionError(f"recording weave_window and the stepwise "
                             f"route differ: {failed}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"telemetry phase recorded nothing: {counts}")
    n_rec = len(WEAVE_CASES) * WEAVE_WINDOWS * 2     # compared + loop
    if launches["by_instance"]["telemetry+cmd_trace"] < n_rec:
        raise AssertionError(f"telemetry phase launches {launches}")
    return worst


def record_launch(cfg, clock, kw, queue, banks, tele, w):
    """The C entry point of ``cfg``'s recording instance on prepared
    buffers: ``(launch, bytes, steps)``, bytes = state and recorder carry
    in, state, increments and record out."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.weave_window import ops as wops

    B, C, Q = queue.valid.shape
    d = cfg.platform.dram
    start, end = clock.window_start_tick(w), clock.window_end_tick(w)
    event = cfg.weave == "event"
    n_steps = cfg.event_budget() if event else clock.ticks_per_window_static
    inp, res = wops.pack_inputs(queue, banks)
    rin, rout = wops.pack_recorder(
        tele, B, C, d.banks_per_channel, d.ranks_per_channel, n_steps,
        queue.valid.device, telemetry=cfg.telemetry,
        cmd_trace=cfg.cmd_trace)
    params = wops.pack_params(d, cfg.policy, **{
        k: kw[k] for k in ("tick2cpu_num", "tick2cpu_den",
                           "cpu_ps_per_clk")})
    c_params = (ctypes.c_int * len(params))(*params)
    fn = _build.function("weave_window_record_launch",
                         wops._RECORD_ARGTYPES)
    ptrs = ([x.data_ptr() for x in inp.values()]
            + [x.data_ptr() for x in res.values()]
            + [rin[k].data_ptr() if k in rin else None
               for k in ("opened", "burst")]
            + [rout[k].data_ptr() if k in rout else None
               for k in ("opened", "burst", "counters", "busy", "hist",
                         "rec")])

    def launch():
        err = fn(*ptrs, ctypes.addressof(c_params), len(params), B * C, Q,
                 d.banks_per_channel, d.ranks_per_channel, start, end,
                 start + clock.ticks_per_window_static, n_steps, int(event),
                 int(cfg.telemetry), int(cfg.cmd_trace),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"weave_window_record_launch: error {err}")

    launch.buffers = (inp, res, rin, rout)   # alive while launch is
    io_bytes = sum(x.numel() * x.element_size() for x in list(inp.values())
                   + list(res.values()) + list(rin.values())
                   + list(rout.values()))
    return launch, io_bytes, n_steps


RECORD_INSTANCES = {"plain": (False, False), "telemetry": (True, False),
                    "cmd_trace": (False, True),
                    "telemetry+cmd_trace": (True, True)}


def record_timing(dev, persp_cfg, persp_state, w=8):
    """The recording instances at the main path's two batches (window
    ``w`` of the FAST sweep) and at the perspectives ladder's batch.
    First, on the same state: the recording instance (both recorders)
    against the stepwise route with the flags (its plain version, the
    dense batch).  Then each instance's device time (its C entry point in
    a CUDA graph; ``plain`` the same entry point with no recorder), one
    wrapper call, and the bytes bound of each."""
    from repro_torch.core import dram, platform

    out, diffs = {}, {}
    with torch.inference_mode():
        for engine in ("dense", "event"):
            cfg_e, clock, kw, queue, banks = weave_state(dev, engine, w)
            tele = dram.init_tele(cfg_e.platform.dram, queue.valid.shape[0],
                                  dev)
            args = (clock, kw, queue, banks, w, tele)
            both = dataclasses.replace(cfg_e, telemetry=True, cmd_trace=True)
            row = {}
            if engine == "dense":
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want = platform._weave_stepwise(both, *args)
                torch.cuda.synchronize()
                row["plain_ms"] = (time.perf_counter() - t0) * 1e3
                got = platform._weave_fused(both, *args)
                row["max_abs_diff"], row["bit_identical"] = rec_diff(got,
                                                                     want)
                diffs = {f"{i}.{j}": rec_diff(x, y)[1]
                         for i, (a, b) in enumerate(zip(got, want))
                         for j, (x, y) in enumerate(
                             zip(a, b) if isinstance(a, tuple) else [(a, b)])}
            for name, (tl, ct) in RECORD_INSTANCES.items():
                icfg = dataclasses.replace(cfg_e, telemetry=tl, cmd_trace=ct)
                launch, io_bytes, n_steps = record_launch(
                    icfg, clock, kw, queue, banks, tele, w)
                row[name] = dict(
                    ms=device_ms(launch, 5), bytes=io_bytes,
                    bound_ms=io_bytes / MEM_BYTES_PER_S * 1e3)
            row.update(
                ms=row["telemetry+cmd_trace"]["ms"],
                bytes=row["telemetry+cmd_trace"]["bytes"],
                bound_ms=row["telemetry+cmd_trace"]["bound_ms"],
                call_ms=time_ms(lambda: platform._weave_fused(both, *args),
                                5),
                steps=n_steps,
                rows=queue.valid.shape[0] * queue.valid.shape[1])
            out[engine] = row
        clock, kw, queue, banks, tele, pw = persp_state
        row = {}
        for name in ("plain", "telemetry"):
            tl, ct = RECORD_INSTANCES[name]
            icfg = dataclasses.replace(persp_cfg, telemetry=tl, cmd_trace=ct)
            launch, io_bytes, n_steps = record_launch(
                icfg, clock, kw, queue, banks, tele, pw)
            row[name] = dict(ms=device_ms(launch, 10), bytes=io_bytes,
                             bound_ms=io_bytes / MEM_BYTES_PER_S * 1e3)
        out["perspectives"] = dict(
            row, ms=row["telemetry"]["ms"],
            bound_ms=row["telemetry"]["bound_ms"], steps=n_steps,
            rows=queue.valid.shape[0] * queue.valid.shape[1],
            stage=persp_cfg.name, window=pw)
    emit({"phase": "record_timing", "window": w, "timing": out,
          "fields_equal": diffs})
    if not out["dense"]["bit_identical"]:
        raise AssertionError(f"recording weave_window differs from the "
                             f"stepwise route at the main path's batch: "
                             f"{[k for k, v in diffs.items() if not v]}")
    return out


def perspectives_state(dev, w=8):
    """The perspectives ladder's window batch (stage 10, SMOKE, telemetry
    on) after window ``w``'s injection: ``(cfg, state)`` for
    `record_timing`."""
    from repro_torch.bench import perspectives
    from repro_torch.core import get_stage, platform
    from repro_torch.traces import (TraceFrontend, assign_traces,
                                    split_cores, stack_mixes, to)
    from repro_torch.traces.kernels import gups, stream

    knobs = perspectives.SMOKE
    cfg = get_stage(perspectives.LADDER[-1], windows=knobs["windows"],
                    warmup=knobs["warmup"], telemetry=True)
    wcfg, clock = cfg.workload_config(), cfg.clock()
    mix = assign_traces([stream(n=knobs["n"]), gups(n=knobs["n"])],
                        split_cores(2, wcfg.n_cores), phase_offsets=None)
    fe = TraceFrontend(to(stack_mixes([mix]), dev), wcfg)
    with torch.inference_mode():
        carry = platform._init_carry(cfg, fe, 1, dev)
        for i in range(w):
            carry, _ = platform._window_step(cfg, clock, wcfg, fe, carry, i)
        queue = platform._bound_inject(cfg, clock, wcfg, fe, carry, w)[0]
    return cfg, (clock, platform._tick_kw(cfg, clock, dev), queue, carry[1],
                 carry[5], w)


def perspectives_phase(dev):
    """The port's perspectives ladder on the card: SMOKE held against the
    reference's ``reports/benchmarks/perspectives.json`` (rho per stage,
    monotone_ok, end_to_end_gain within 1e-9), its launches; card vs CPU
    at stages 01 and 10 (4 windows: planes and summaries equal); then
    FULL, the paper's setting.  Returns the SMOKE ladder's launches."""
    from repro_torch import kernels, obs
    from repro_torch.bench import perspectives
    from repro_torch.kernels.weave_window import weave_window

    want = json.loads((ROOT / "reports" / "benchmarks"
                       / "perspectives.json").read_text())
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    smoke = perspectives.main(full=False, device=dev, write=False)
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts(),
                    by_instance=dict(weave_window.launches_by_instance))
    worst, bad = 0.0, []
    for got_row, want_row in zip(smoke["ladder"], want["ladder"]):
        for k, v in want_row.items():
            g = got_row[k]
            if isinstance(v, float):
                worst = max(worst, abs(g - v))
                if not abs(g - v) <= 1e-9:
                    bad.append((want_row["stage"], k, g, v))
            elif g != v:
                bad.append((want_row["stage"], k, g, v))
    for k in ("monotone_ok", "end_to_end_gain"):
        if smoke[k] != want[k]:
            bad.append((k, smoke[k], want[k]))
    summaries_equal = smoke["summaries"] == want["summaries"]
    n_batches = len(perspectives.LADDER) * perspectives.SMOKE["windows"]
    emit({"phase": "perspectives", "part": "smoke",
          "knobs": perspectives.SMOKE, "wall_s": wall,
          "host_ms_per_window_batch": wall * 1e3 / n_batches,
          "ladder": [{k: r[k] for k in ("stage", "rho_sim_app", "rho_sim_if",
                                        "rho_if_app")}
                     for r in smoke["ladder"]],
          "monotone_ok": smoke["monotone_ok"],
          "end_to_end_gain": smoke["end_to_end_gain"],
          "max_abs_diff_vs_reference_file": worst,
          "summaries_equal_reference_file": summaries_equal,
          "stage_wall_s": smoke["wall_s"], "launches": launches})
    if bad or not summaries_equal:
        raise AssertionError(f"perspectives SMOKE differs from the "
                             f"reference's file: {bad[:10]}, summaries "
                             f"equal {summaries_equal}")
    if (launches["by_instance"]["telemetry"] != n_batches
            or launches["window_inject_trace"] != n_batches
            or launches["window_inject"] or launches["frfcfs_select"]
            or launches["decode_packed"]):
        raise AssertionError(f"perspectives launches {launches}: expected "
                             f"{n_batches} telemetry weave_window and "
                             f"window_inject_trace, no decode_packed")

    # card vs CPU at two stages, 4 windows
    cpu_rows = []
    for stage in (perspectives.LADDER[0], perspectives.LADDER[-1]):
        knobs = dict(perspectives.SMOKE, windows=4, warmup=1)
        cfg, on_card, outs_c = perspectives.stage_run(stage, "ddr4_2666",
                                                      device=dev, **knobs)
        _, on_cpu, outs_p = perspectives.stage_run(stage, "ddr4_2666",
                                                   device="cpu", **knobs)
        planes = all(torch.equal(on_card[k].cpu(), on_cpu[k])
                     for k in obs.TELE_KEYS if k != "tele_lat_est_ps")
        lat_rel = float(((on_card["tele_lat_est_ps"].cpu()
                          - on_cpu["tele_lat_est_ps"]).abs()
                         / on_cpu["tele_lat_est_ps"].abs()).max())
        summ = (obs.summarize(obs.collect(cfg, on_card, outs_c))
                == obs.summarize(obs.collect(cfg, on_cpu, outs_p)))
        cpu_rows.append({"stage": stage, "int_planes_equal": planes,
                         "lat_est_max_rel_err": lat_rel,
                         "summaries_equal": summ})
        if not (planes and summ and lat_rel <= RTOL):
            raise AssertionError(f"perspectives card vs CPU: {cpu_rows}")
    emit({"phase": "perspectives", "part": "card_vs_cpu", "rows": cpu_rows})

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    full = perspectives.main(full=True, device=dev)
    full_wall = time.perf_counter() - t0
    n_full = len(perspectives.LADDER) * perspectives.FULL["windows"]
    emit({"phase": "perspectives", "part": "full",
          "knobs": perspectives.FULL, "wall_s": full_wall,
          "host_ms_per_window_batch": full_wall * 1e3 / n_full,
          "stage_wall_s": full["wall_s"],
          "ladder": [{k: r[k] for k in ("stage", "rho_sim_app", "rho_sim_if",
                                        "rho_if_app", "sim_lat_ns_mean",
                                        "app_lat_ns_mean")}
                     for r in full["ladder"]],
          "monotone_ok": full["monotone_ok"],
          "end_to_end_gain": full["end_to_end_gain"],
          "exceptions": full["exceptions"],
          "launches": dict(kernels.launch_counts(), by_instance=dict(
              weave_window.launches_by_instance))})
    full_launches = kernels.launch_counts()
    for r in full["ladder"]:
        if not all(np.isfinite(r[k]) for k in ("rho_sim_app",
                                                "sim_lat_ns_mean")):
            raise AssertionError(f"perspectives FULL: {r}")
    if (full_launches["window_inject_trace"] != n_full
            or full_launches["decode_packed"]):
        raise AssertionError(f"perspectives FULL launches {full_launches}: "
                             f"expected {n_full} window_inject_trace, no "
                             f"decode_packed")
    return launches, wall


def cmd_oracle_phase(dev):
    """The port's command oracle on the card: every SMOKE cell with equal
    dense and event streams, no violation, equal stream stats; one
    exported trace validated; one cell's card stream against its CPU
    stream (the event engine)."""
    from repro_torch import kernels
    from repro_torch.bench import cmd_oracle
    from repro_torch.kernels.weave_window import weave_window
    from repro_torch.oracle import diff_streams

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    report = cmd_oracle.main(full=False, device=dev)
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts(),
                    by_instance=dict(weave_window.launches_by_instance))
    n_batches = sum(2 * c[3] for c in cmd_oracle.SMOKE)
    cell = next(c for c in cmd_oracle.SMOKE if c[1] == "ddr5_4800"
                and c[2].app.startswith("mess"))
    t1 = time.perf_counter()
    _, v_card, s_card = cmd_oracle.record(*cell, "event", device=dev)
    _, v_cpu, s_cpu = cmd_oracle.record(*cell, "event", device="cpu")
    cpu_s = time.perf_counter() - t1
    raw_equal = all(torch.equal(v_card[k].cpu(), v_cpu[k])
                    for k in v_cpu if k.startswith("cmd_"))
    same = diff_streams(s_card, s_cpu) is None
    emit({"phase": "cmd_oracle", "wall_s": wall, "all_ok": report["all_ok"],
          "cells": [{k: c[k] for k in ("stage", "preset", "app", "windows",
                                       "n_commands", "counts",
                                       "streams_identical", "legal_ok",
                                       "mix_agree", "weave_sat", "wall_s")}
                    | {"checks": sum(c["n_checked"].values()),
                       "violations": sum(c["violation_counts"].values())}
                    for c in report["cells"]],
          "exported_rows": report["exported_rows"], "launches": launches,
          "card_vs_cpu": {"cell": [cell[0], cell[1], cell[2].app, cell[3]],
                          "engine": "event", "raw_records_equal": raw_equal,
                          "streams_equal": same, "commands": len(s_card),
                          "seconds": cpu_s}})
    if not (report["all_ok"] and raw_equal and same):
        raise AssertionError("cmd_oracle: a cell failed or the card's "
                             "stream differs from the CPU's")
    if launches["by_instance"]["cmd_trace"] != n_batches:
        raise AssertionError(f"cmd_oracle launches {launches}: expected "
                             f"{n_batches} cmd_trace weave_window")
    return launches


def inject_timing(dev, w=8):
    """`window_inject` at the main path's two batches (window ``w`` of the
    FAST sweep): the kernel's device time (its C entry point on prepared
    arguments, in a CUDA graph), one call of the card's route
    (`_bound_inject_fused`, checks and allocation included), the eager
    route on the same state (its plain version), one whole
    `_window_step` on the card's routes, their agreement, and the bytes
    bound (every input read once, every output written once)."""
    from repro_torch.core import platform

    out = {}
    with torch.inference_mode():
        for engine in ("dense", "event"):
            cfg_e, clock, wcfg, frontend, carry = sweep_state(dev, engine, w)
            args = (cfg_e, clock, wcfg, frontend, carry, w)
            want = platform._bound_inject_eager(*args)
            got = platform._bound_inject_fused(*args)
            diff, same = max_diff(got, want)
            launch, io_bytes = inject_launch(*args)
            ms = device_ms(launch, 20)
            B, C, Q = carry[0].valid.shape
            out[engine] = dict(
                ms=ms, call_ms=time_ms(
                    lambda: platform._bound_inject_fused(*args), 50),
                plain_ms=time_ms(
                    lambda: platform._bound_inject_eager(*args), 20),
                window_step_ms=time_ms(lambda: platform._window_step(
                    cfg_e, clock, wcfg, frontend, carry, w), 20),
                bytes=io_bytes, bound_ms=io_bytes / MEM_BYTES_PER_S * 1e3,
                points=B, max_abs_diff=diff, bit_identical=same,
                shape=f"B={B} points x {wcfg.n_cores * 80} candidates, "
                      f"{C} channels x {Q} slots")
    emit({"phase": "inject_timing", "window": w, "timing": out})
    bad = [e for e, t in out.items() if not t["bit_identical"]]
    if bad:
        raise AssertionError(f"window_inject and the eager route differ at "
                             f"the main path's batch: {bad}")
    return out


def trace_inject_timing(dev, w=8):
    """`window_inject_trace` at the replay ladder's batch (the six apps
    at ``app_validation.FULL``, stage 10 with telemetry, window ``w``):
    the kernel's device time (its C entry point on prepared arguments,
    in a CUDA graph), one call of the card's route
    (`_bound_inject_fused_trace`), the eager route on the same state
    (its plain version), one whole `_window_step`, their agreement, and
    the bytes bound: the queue planes and the state read and written
    once, and of the trace arrays the entries this window's cursors
    read (a `Trace` row is shared by the cores: each entry once)."""
    from repro_torch.bench import app_validation as av
    from repro_torch.core import addrmap, get_stage, platform
    from repro_torch.kernels.window_inject import ops as iops
    from repro_torch.traces import (TraceFrontend, make_suite, stack_traces,
                                    to)

    cfg = get_stage(LADDER_PROFILED_STAGE, windows=av.FULL["windows"],
                    warmup=av.FULL["warmup"], telemetry=True)
    clock, wcfg = cfg.clock(), cfg.workload_config()
    frontend = TraceFrontend(to(stack_traces(make_suite(n=av.FULL["n"])[1]),
                                dev), wcfg)
    with torch.inference_mode():
        carry = platform._init_carry(cfg, frontend, frontend.batch, dev)
        for i in range(w):
            carry, _ = platform._window_step(cfg, clock, wcfg, frontend,
                                             carry, i)
        args = (cfg, clock, wcfg, frontend, carry, w)
        want = platform._bound_inject_eager(*args)
        got = platform._bound_inject_fused_trace(*args)
        diff, same = max_diff(got, want)
        queue, _, fstate, l_ir, lat_est = carry[:5]
        cpu = cfg.platform.cpu
        c_args, res = iops.prepare_trace(
            queue, fstate, frontend.trace, l_ir, lat_est, w=w, wcfg=wcfg,
            clock=clock,
            mapping=addrmap.decode_route(wcfg.mapping, wcfg.dram),
            window_cycles=cpu.window_cycles,
            window_ps=cpu.window_cycles * cpu.cpu_ps_per_clk)
        ms = device_ms(lambda: iops.launch_trace(
            c_args, torch.cuda.current_stream().cuda_stream), 20)
        B, C, Q = queue.valid.shape
        L = frontend.trace.n_slots
        pos = torch.clamp(fstate.pos, max=L - 64).long().cpu()
        read = sum(len(set((pos[b, :, None] + torch.arange(64)).flatten()
                           .tolist())) for b in range(B))
        reads = sum(x.numel() * x.element_size() for x in (
            *fstate, l_ir, lat_est, frontend.trace.length,
            frontend.trace.footprint_lines))
        writes = sum(res[k].numel() * 4 for k in ("core", "point"))
        io_bytes = 2 * 7 * B * C * Q * 4 + reads + writes + 3 * read * 4
        out = dict(
            ms=ms, call_ms=time_ms(
                lambda: platform._bound_inject_fused_trace(*args), 50),
            plain_ms=time_ms(lambda: platform._bound_inject_eager(*args),
                             20),
            window_step_ms=time_ms(lambda: platform._window_step(
                cfg, clock, wcfg, frontend, carry, w), 20),
            bytes=io_bytes, bound_ms=io_bytes / MEM_BYTES_PER_S * 1e3,
            points=B, trace_entries_read=read, max_abs_diff=diff,
            bit_identical=same,
            shape=f"B={B} apps x {wcfg.n_cores} cores x 64 accesses "
                  f"(L={L}), {C} channels x {Q} slots")
    emit({"phase": "inject_timing", "instance": "trace", "stage": cfg.name,
          "window": w, "timing": out})
    if not same:
        raise AssertionError("window_inject_trace and the eager route "
                             "differ at the ladder's batch")
    return out


def weave_timing(dev, w=8):
    """`weave_window` at the main path's two batches (window ``w`` of the
    FAST sweep): the kernel's device time (its C entry point on packed
    inputs, in a CUDA graph), one wrapper call (`_weave_fused`, packing
    included), the stepwise route on the same state (its plain version,
    ~170 eager ops + one `frfcfs_select` per step), their agreement, and
    the bytes bound (state in and out once)."""
    from repro_torch.core import platform

    out = {}
    with torch.inference_mode():
        for engine in ("dense", "event"):
            cfg_e, clock, kw, queue, banks = weave_state(dev, engine, w)
            args = (cfg_e, clock, kw, queue, banks, w)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = platform._weave_stepwise(*args)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            got = platform._weave_fused(*args)
            diff, same = max_diff(got, want)
            launch, io_bytes, n_steps = weave_launch(*args)
            ms = device_ms(launch, 5)
            B, C, Q = queue.valid.shape
            out[engine] = dict(
                ms=ms, us_per_step=ms * 1e3 / n_steps,
                call_ms=time_ms(lambda: platform._weave_fused(*args), 5),
                plain_ms=plain_ms, bytes=io_bytes,
                bound_ms=io_bytes / MEM_BYTES_PER_S * 1e3,
                rows=B * C, q=Q, steps=n_steps, max_abs_diff=diff,
                bit_identical=same,
                shape=f"{B * C} rows x {Q} slots, {n_steps} {engine} steps")
    emit({"phase": "weave_timing", "window": w, "timing": out})
    bad = [e for e, t in out.items() if not t["bit_identical"]]
    if bad:
        raise AssertionError(f"fused and stepwise weave differ at the main "
                             f"path's batch: {bad}")
    return out


def device_busy(dev_events):
    """Union of the device events' spans (us), and their window (us)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in dev_events)
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for a, z in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, z
        else:
            cur_e = max(cur_e, z)
    busy += cur_e - cur_s
    return busy, max(z for _, z in spans) - spans[0][0]


def profile_run(head, run, unprofiled_wall_s, kernels):
    """``run()`` once more under torch.profiler: the device time and
    launches of each kernel in ``kernels`` (key prefix -> a substring of
    its name), the device's busy time by kernel and its idle share over
    the run's wall (profiled and not).  ``head`` starts the JSON line."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    out = dict(head, wall_s_profiled=wall_us / 1e6,
               device_events=len(dev_events))
    if not dev_events:
        out["note"] = "the profiler showed no device time on this machine"
        emit(out)
        return out
    busy, window = device_busy(dev_events)
    n_named = 0
    for key, word in kernels.items():
        named = [e for e in dev_events if word in e.name]
        n_named += len(named)
        out[f"{key}_launches"] = len(named)
        out[f"{key}_device_s"] = sum(e.time_range.end - e.time_range.start
                                     for e in named) / 1e6
    by_name = {}
    for e in dev_events:
        n, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (n + e.time_range.end - e.time_range.start, c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    out.update(
        other_kernels=len(dev_events) - n_named,
        device_busy_s=busy / 1e6, device_window_s=window / 1e6,
        idle_share_of_wall=1 - busy / wall_us,
        idle_share_of_unprofiled_wall=1 - busy / (unprofiled_wall_s * 1e6),
        top_kernels=[{"name": n[:80], "ms": us / 1e3, "count": c}
                     for n, (us, c) in top])
    emit(out)
    return out


def profile_sweep(cfg, unprofiled_wall_s):
    """The main path's sweep once more under torch.profiler (the weave
    and interface kernels)."""
    from repro_torch.core import sweep

    return profile_run(
        {"phase": "profile", "what": "the main path's FAST sweep"},
        lambda: sweep(cfg, paces=FAST_PACES, write_mixes=FAST_MIXES),
        unprofiled_wall_s, {"weave": "weave_window",
                            "inject": "window_inject"})


def compare_replay(card, cpu):
    """Worst relative float error between two replay dicts; raises where
    an exact key (counts, cursors, runtimes made of them) differs."""
    worst = 0.0
    for k, ref in cpu.items():
        got = card[k]
        if k in REPLAY_EXACT or not np.issubdtype(ref.dtype, np.floating):
            if not np.array_equal(got, ref, equal_nan=ref.dtype.kind == "f"):
                raise AssertionError(f"replay {k}: card {got.tolist()} != "
                                     f"cpu {ref.tolist()}")
            continue
        both = np.isfinite(ref)
        if not np.array_equal(both, np.isfinite(got)):
            raise AssertionError(f"replay {k}: card {got} vs cpu {ref}")
        rel = np.abs(got[both] - ref[both]) / np.maximum(np.abs(ref[both]),
                                                         1e-30)
        worst = max(worst, float(rel.max(initial=0.0)))
    return worst


def replay_parity(dev):
    """The trace route on the card (`window_inject_trace`, `weave_window`)
    against the CPU's eager and stepwise routes: the six apps at three
    stages, then the three mixes on two sockets."""
    from repro_torch import kernels
    from repro_torch.bench.app_validation import MIXES
    from repro_torch.core import get_stage
    from repro_torch.traces import (assign_traces, make_suite, replay_mixes,
                                    replay_suite, split_cores, stack_mixes,
                                    stack_traces, to)

    knobs = dict(windows=REPLAY_WINDOWS, warmup=REPLAY_WARMUP)
    names, traces = make_suite(n=REPLAY_N)
    batch = stack_traces(traces)
    n_cores = 24 * REPLAY_MIX_SOCKETS
    mixes = stack_mixes([assign_traces(make_suite(n=REPLAY_N, names=k)[1],
                                       split_cores(len(k), n_cores))
                         for _, k in MIXES])
    cases = [(st, 1, batch, replay_suite) for st in REPLAY_STAGES] + [
        (REPLAY_MIX_STAGE, REPLAY_MIX_SOCKETS, mixes, replay_mixes)]
    rows, worst = [], 0.0
    for stage, sockets, data, fn in cases:
        cfg = get_stage(stage, n_sockets=sockets, **knobs)
        on_card_data = to(data, dev)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        card = fn(cfg, on_card_data)
        card_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
        t0 = time.perf_counter()
        cpu = fn(cfg, data, device="cpu")
        cpu_s = time.perf_counter() - t0
        rel = compare_replay(card, cpu)
        worst = max(worst, rel)
        batches = cfg.windows * (1 + int((card["weave_sat"] > 0).any()))
        rows.append({"stage": stage, "sockets": sockets,
                     "what": "3 mixes" if fn is replay_mixes else "6 apps",
                     "ints_equal": True, "max_rel_err": rel,
                     "dense_reruns": int((card["weave_sat"] > 0).sum()),
                     "launches": launches, "card_s": card_s, "cpu_s": cpu_s,
                     "injected": card["injected"].tolist()})
        if (launches["weave_window"] != batches
                or launches["window_inject_trace"] != batches
                or launches["window_inject"] or launches["decode_packed"]):
            raise AssertionError(f"replay {stage}: launches {launches}, "
                                 f"expected {batches} weave_window and "
                                 f"window_inject_trace, 0 decode_packed "
                                 f"and window_inject")
    emit({"phase": "replay", "part": "card_vs_cpu", "apps": list(names),
          "n": REPLAY_N, **knobs, "cases": rows, "max_rel_err": worst,
          "rtol": RTOL})
    if not worst <= RTOL:
        raise AssertionError(f"replay float views differ by {worst} > "
                             f"{RTOL}")
    return worst


def profile_replay(cfg, batch, unprofiled_wall_s):
    """One stage of the ladder once more under torch.profiler (the weave
    kernel and the trace instance of the interface kernel)."""
    from repro_torch.traces import replay_suite

    return profile_run(
        {"phase": "replay", "part": "profile", "stage": cfg.name},
        lambda: replay_suite(cfg, batch), unprofiled_wall_s,
        {"weave": "weave_window", "inject": "window_inject_kernel"})


def ladder(dev):
    """The application-validation ladder at its full setting on the card
    (6 apps x 8192 accesses, 96 windows, the five stages), with each
    stage's launches; then the multiprogrammed ladder (FAST), and one
    stage profiled.  Returns the launches of the whole ladder and the
    profile."""
    from repro_torch import kernels
    from repro_torch.bench import app_validation as av
    from repro_torch.core import get_stage
    from repro_torch.traces import make_suite, replay_suite, stack_traces, to

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    results = av.run_preset("ddr4_2666", full=True)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    stages, bad = [], []
    for stage, out in results.items():
        reruns = int((out["weave_sat"] > 0).sum())
        batches = av.FULL["windows"] * (1 + int(reruns > 0))
        n = out["launches"]
        stages.append({
            "stage": stage, "wall_s": out["wall_s"],
            "window_batches": batches,
            "host_ms_per_window_batch": out["wall_s"] * 1e3 / batches,
            "mape_pct": out["mape_pct"], "dense_reruns": reruns,
            "runtime_ms": dict(zip(out["apps"],
                                   out["runtime_ms"].tolist())),
            "anchor_ms": dict(zip(out["apps"], out["anchor_ms"].tolist())),
            "done": out["done"].tolist(),
            "weave_events": out["weave_events"].tolist(),
            "if_p50_p95_p99_ns": {
                app: av._if_percentiles_ns(out, av.FULL["warmup"],
                                           i).tolist()
                for i, app in enumerate(out["apps"])},
            "launches": n})
        if (n["weave_window"] < av.FULL["windows"] or n["window_inject"]
                or n["window_inject_trace"] != n["weave_window"]
                or n["decode_packed"]):
            bad.append((stage, n))
        if not abs(out["mape_pct"] - LADDER_MAPE_REF[stage]) \
                <= LADDER_MAPE_ATOL:
            bad.append((stage, "mape_pct", out["mape_pct"],
                        LADDER_MAPE_REF[stage]))
        for k in ("runtime_ms", "sim_bw_gbs", "if_lat_ns"):
            if not np.isfinite(out[k]).all() or (out[k] <= 0).any():
                bad.append((stage, k, out[k].tolist()))
        # the ladder runs with telemetry: every app's reads in its
        # interface histogram, after warm-up as the percentiles read it
        served = out["tele_hist_if_ps"].sum(axis=(1, 2, 3))
        if not np.array_equal(served, out["tele_n_cas_rd"].sum(axis=(1, 2))):
            bad.append((stage, "tele_hist_if_ps", served.tolist()))
        if n["weave_window"] != n["weave_window_recording"]:
            bad.append((stage, "weave_window instances", n))
    emit({"phase": "replay", "part": "ladder", "preset": "ddr4_2666",
          "knobs": av.FULL, "apps": list(results[av.STAGES[0]]["apps"]),
          "wall_s": wall, "stages": stages, "launches": launches,
          "mape_reference_pct": LADDER_MAPE_REF})
    if bad:
        raise AssertionError(f"ladder: launches or results out of rule: "
                             f"{bad} (expected weave_window >= 96 and as "
                             f"many window_inject_trace, window_inject "
                             f"and decode_packed 0, the MAPE within "
                             f"{LADDER_MAPE_ATOL} of the reference's)")

    t0 = time.perf_counter()
    mixes = av.run_mixes("ddr4_2666", full=False)
    emit({"phase": "replay", "part": "mix_ladder", "preset": "ddr4_2666",
          "knobs": av.FAST, "wall_s": time.perf_counter() - t0,
          "stages": [{"stage": st, "wall_s": out["wall_s"],
                      "mix_mape_pct": dict(zip(
                          [m for m, _ in out["mixes"]],
                          out["mix_mape_pct"])),
                      "app_runtime_ms": {
                          m: dict(zip(a, out["app_runtime_ms"][i].tolist()))
                          for i, (m, a) in enumerate(out["mixes"])},
                      "solo_runtime_ms": {k: float(v) for k, v in
                                          out["solo_runtime_ms"].items()},
                      "mix_if_p50_p95_p99_ns": {
                          m: av._if_percentiles_ns(out, av.FAST["warmup"],
                                                   i).tolist()
                          for i, (m, _) in enumerate(out["mixes"])},
                      "dense_reruns": int((out["weave_sat"] > 0).sum())}
                     for st, out in mixes.items()]})

    cfg = get_stage(LADDER_PROFILED_STAGE, windows=av.FULL["windows"],
                    warmup=av.FULL["warmup"], telemetry=True)
    batch = to(stack_traces(make_suite(n=av.FULL["n"])[1]), dev)
    prof = profile_replay(cfg, batch,
                          results[LADDER_PROFILED_STAGE]["wall_s"])

    # what telemetry costs the profiled stage: off, on, on, off
    walls = {"off": [], "on": []}
    for tele in ("off", "on", "on", "off"):
        c = dataclasses.replace(cfg, telemetry=tele == "on")
        t0 = time.perf_counter()
        replay_suite(c, batch)
        walls[tele].append(time.perf_counter() - t0)
    emit({"phase": "replay", "part": "telemetry_cost",
          "stage": cfg.name, "wall_s": walls,
          "window_batches": 2 * cfg.windows})
    return launches, prof


def move(tree, where):
    """A tree of tensors copied to ``where``."""
    return {k: move(v, where) if isinstance(v, dict) else v.to(where)
            for k, v in tree.items()}


def lm_path(dev):
    """The dense serving path of tinyllama-1.1b at full width and depth."""
    from repro_torch import kernels
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.registry import count_params, get_model
    from repro_torch.models.transformer import prefill
    from repro_torch.serve.engine import Engine, Request

    cfg = dataclasses.replace(get_config(LM_ARCH), use_flash_kernel=True)
    api = get_model(cfg)
    params = api.init(0)                      # on the card
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (LM_B, LM_S))).to(dev)
    out = {"phase": "lm_path", "arch": cfg.name, "dtype": "bfloat16",
           "n_layers": cfg.n_layers, "params": count_params(params),
           "batch": LM_B, "seq": LM_S}
    with torch.inference_mode():
        api.forward(params, {"tokens": toks})      # warm-up, not counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        # (a) forwards over B x S tokens, each counted and timed; the
        # median wall, since one call on a shared host can stall
        walls = []
        for _ in range(LM_FORWARDS):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            full = api.forward(params, {"tokens": toks})
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches = kernels.launch_counts()
            routes = dict(flash_attention.launches_by_route)
            check_routes("forward", routes, cfg.n_layers)
        wall = float(np.median(walls))
        out["forward"] = {"wall_s": wall, "walls_s": walls,
                          "tokens_per_s": LM_B * LM_S / wall,
                          "launches": launches, "flash_routes": routes,
                          "peak_mem_gb": torch.cuda.max_memory_allocated()
                          / 1e9}
        if full.shape != (LM_B, LM_S, cfg.vocab) or not bool(
                full.isfinite().all()):
            raise AssertionError(f"forward logits: shape {full.shape}, "
                                 f"finite {bool(full.isfinite().all())}")

        profile_forward(api, params, {"tokens": toks}, wall,
                        f"one warm {LM_ARCH} forward, {LM_B} x {LM_S} "
                        f"tokens, bf16")

        # (b) prefill S-1 tokens, decode the last, against (a)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        _, cache = prefill(cfg, params, toks[:, :-1], LM_S + 16)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prefill_routes = dict(flash_attention.launches_by_route)
        check_routes("prefill", prefill_routes, cfg.n_layers)
        dec, cache = api.decode(params, cache, toks[:, -1])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ref = full[:, -1].float()
        diff = (dec.float() - ref).abs()
        rel_l2 = float((dec.float() - ref).norm() / ref.norm())
        within = bool((diff <= LM_ATOL + LM_RTOL * ref.abs()).all())
        launches_b = kernels.launch_counts()
        # a second step, past the first call's one-time costs
        nxt = dec.argmax(-1)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        api.decode(params, cache, nxt)
        torch.cuda.synchronize()
        out["prefill_decode"] = {
            "prefill_s": t1 - t0, "decode_s": t2 - t1,
            "second_decode_s": time.perf_counter() - t3,
            "launches": launches_b, "prefill_flash_routes": prefill_routes,
            "max_abs_diff": float(diff.max()), "rel_l2": rel_l2,
            "max_abs_logit": float(ref.abs().max()),
            "atol": LM_ATOL, "rtol": LM_RTOL,
            "argmax_equal": (dec.argmax(-1) == full[:, -1].argmax(-1))
            .tolist()}
        del full, cache

    # (c) the Engine: 8 requests on 4 slots
    kernels.reset_launch_counts()
    eng = Engine(api, params, n_slots=4, max_seq=256)
    req_rng = np.random.default_rng(1)
    for i in range(8):
        prompt = req_rng.integers(1, cfg.vocab, int(req_rng.integers(4, 17)))
        eng.submit(Request(rid=i, prompt=[int(t) for t in prompt],
                           max_new=16))
    done, ticks = [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.pool.pending():
        done += eng.tick()
        ticks += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_tok = sum(len(r.out) for r in done)
    out["engine"] = {"slots": 4, "max_seq": 256, "requests": 8,
                     "completed": len(done), "ticks": ticks,
                     "tokens": n_tok, "wall_s": wall,
                     "tokens_per_s": n_tok / wall,
                     "ms_per_tick": wall / ticks * 1e3,
                     "launches": kernels.launch_counts()}
    emit(out)
    if not (within and rel_l2 <= LM_RTOL):
        raise AssertionError(f"prefill + decode differ from the forward: "
                             f"{out['prefill_decode']}")
    if len(done) != 8 or any(len(r.out) != 16 for r in done):
        raise AssertionError(f"engine completed {len(done)} of 8 requests")
    return routes


def lm_parity(dev):
    """The forward at tinyllama widths, 2 layers, fp32: card vs CPU."""
    from repro_torch import kernels
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import get_model

    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=2,
                              dtype=torch.float32, use_flash_kernel=True)
    api = get_model(cfg)
    on_cpu = api.init(0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 256)))
    with torch.inference_mode():
        want = api.forward(on_cpu, {"tokens": toks})
        kernels.reset_launch_counts()
        got = api.forward(move(on_cpu, dev), {"tokens": toks.to(dev)}).cpu()
    launches = kernels.launch_counts()["flash_attention"]
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, atol=PARITY_TOL, rtol=PARITY_TOL))
    emit({"phase": "lm_parity", "arch": cfg.name, "n_layers": 2, "seq": 256,
          "dtype": "float32", "flash_launches_on_card": launches,
          "max_abs_err": err, "max_abs_logit": float(want.abs().max()),
          "tol": PARITY_TOL, "ok": ok})
    if not ok or launches != 2:
        raise AssertionError(f"card forward differs from the CPU's by {err}"
                             f" (flash launches {launches})")


# ---- the other model families (phase 11b) ----------------------------------

def family_config(arch, n_layers=None, **kw):
    """The arch's published config in bf16 with the flash kernel on,
    except where a logit softcap needs the chunked route (grok-1);
    ``n_layers`` cuts the depth (whisper: both stacks)."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(arch)
    cut = {}
    if n_layers is not None:
        cut["n_layers"] = n_layers
        if cfg.n_encoder_layers:
            cut["n_encoder_layers"] = n_layers
    return dataclasses.replace(
        cfg, use_flash_kernel=cfg.attn_logit_softcap == 0, **cut, **kw)


def family_flash_routes(cfg):
    """Flash launches a forward takes, by route: one per attention layer
    where the flash kernel is on; bf16 at D 64, 80 (zamba2) and 128 on
    the Hopper route, fp32 on the CUDA-core one."""
    from repro_torch.kernels.flash_attention.ops import SM90_HEAD_DIMS

    if not cfg.use_flash_kernel:
        n = 0
    elif cfg.family == "hybrid":
        n = cfg.n_layers // cfg.attn_every
    elif cfg.family == "audio":
        n = cfg.n_encoder_layers + 2 * cfg.n_layers
    elif cfg.family in ("vlm", "moe"):
        n = cfg.n_layers
    else:
        n = 0
    hopper = cfg.dtype == torch.bfloat16 and cfg.head_dim in SM90_HEAD_DIMS
    return {"sm90_bf16": n if hopper else 0,
            "cuda_core": 0 if hopper else n}


def family_params(api, cfg, dev):
    params = api.init(0, device=dev)
    if cfg.family == "vlm":
        # open the tanh gates (0 at init: the identity) so that the
        # cross blocks count in every check
        params["cross"]["gate_attn"].fill_(FAMILY_GATE)
        params["cross"]["gate_mlp"].fill_(FAMILY_GATE)
    return params


def family_batch(api, cfg, b, s, dev, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (b, s))).to(dev)}
    if api.needs_ctx:
        batch["ctx"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.n_ctx_tokens, cfg.d_model)).astype(np.float32)).to(dev)
    return batch


def decode_vs_forward(cfg, params, batch, dev):
    """moe: prefill S-1 tokens and decode the last, at the capacity that
    drops no token (see `family_decode_check`); the others: decode the
    last FAMILY_DECODE tokens step by step from a fresh state (after
    `fill_ctx`), against a forward over the same tokens.  Returns the
    decoded logits and the forward's at the same positions, (B, steps,
    V) in fp32, and what was run."""
    import functools

    from repro_torch.models import moe
    from repro_torch.models.registry import get_model
    from repro_torch.models.transformer import prefill

    toks = batch["tokens"]
    if cfg.family == "moe":
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k)
        api = get_model(cfg)
        full = api.forward(params, batch)
        s = toks.shape[1]
        _, cache = prefill(cfg, params, toks[:, :-1], s + 16,
                           mlp_fn=functools.partial(moe.moe_mlp_y, cfg))
        dec, _ = api.decode(params, cache, toks[:, -1])
        decs, ref = [dec], full[:, -1:]
        what = (f"prefill {s - 1} + decode 1, capacity factor "
                f"{cfg.capacity_factor}")
    else:
        api = get_model(cfg)
        last = toks[:, -FAMILY_DECODE:]
        ref = api.forward(params, dict(batch, tokens=last))
        cache = api.init_cache(toks.shape[0], 2 * FAMILY_DECODE, device=dev)
        if api.needs_ctx:
            cache = api.fill_ctx(params, cache, batch["ctx"])
        decs = []
        for t in range(FAMILY_DECODE):
            dec, cache = api.decode(params, cache, last[:, t])
            decs.append(dec)
        what = f"decode {FAMILY_DECODE} vs a forward over them"
    torch.cuda.synchronize()
    return torch.stack(decs, 1).float(), ref.float(), what


def rel_l2(a, b):
    return float((a - b).norm() / b.norm())


def decode_gap(dec, fwd):
    """Decode against the forward: the largest difference, its ratio to
    LM_ATOL + LM_RTOL|x|, whether it is within FAMILY_FP32_TOL (1 + |x|),
    the worst step's relative L2 error and the argmax agreement."""
    diff = (dec - fwd).abs()
    ratio = float((diff / (LM_ATOL + LM_RTOL * fwd.abs())).max())
    agree = dec.argmax(-1) == fwd.argmax(-1)
    return {"max_abs_diff": float(diff.max()), "ratio_to_lm_bound": ratio,
            "within_lm_bound": ratio <= 1,
            "within_fp32_tol": bool((diff <= FAMILY_FP32_TOL
                                     * (1 + fwd.abs())).all()),
            "max_rel_l2": max(rel_l2(dec[:, t], fwd[:, t])
                              for t in range(dec.shape[1])),
            "argmax_equal": f"{int(agree.sum())}/{agree.numel()}"}


@contextlib.contextmanager
def checked_flash(checks):
    """For the duration, the models' ``flash_attention`` launches the
    kernel and then holds its output against ``mha_plain`` on the same
    inputs (FLASH_TOL at their dtype); ``checks`` gathers per shape the
    calls, the route, the largest error and whether every call held."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     mha_plain, route)
    from repro_torch.models import common

    def call(q, k, v, *, causal=False, scale=None):
        o = flash_attention(q, k, v, causal=causal, scale=scale)
        want = mha_plain(q, k, v, causal=causal, scale=scale).float()
        got, tol = o.float(), FLASH_TOL[q.dtype]
        (b, hq, sq, d), (hkv, sk) = q.shape, k.shape[1:3]
        c = checks.setdefault(
            f"B{b} Hq{hq} Hkv{hkv} Sq{sq} Sk{sk} D{d} "
            f"{'causal' if causal else 'full'} {str(q.dtype)[6:]}",
            {"calls": 0, "route": route(q, k, v), "max_abs_err": 0.0,
             "tol": tol, "ok": True})
        c["calls"] += 1
        c["max_abs_err"] = max(c["max_abs_err"],
                               float((got - want).abs().max()))
        c["ok"] &= bool(torch.allclose(got, want, atol=tol, rtol=tol))
        return o

    common.flash_attention = call
    try:
        yield checks
    finally:
        common.flash_attention = flash_attention


def family_decode_check(cfg, api, params, batch, flash_checks):
    """Decode against the forward, in fp32 and in bf16 on the same
    weights.  fp32: within FAMILY_FP32_TOL (1 + |x|), the reference's
    decode == forward invariant (on the chunked route, whose forward
    rounds probabilities to bf16, a relative L2 error within
    CHUNKED_REL_L2).  bf16: the two part by a few bf16 steps, more with
    depth, as the reference's do (the gap is printed beside LM_ATOL +
    LM_RTOL|x|); the bf16 decode's relative L2 distance from the fp32
    forward must be within BF16_DECODE_MULT times the bf16 forward's
    own distance from it, or within LM_RTOL, so that a fault of the
    bf16 decode still fails.  The bf16 run's flash calls go through
    `checked_flash`.  A decode step routes one MoE token a group
    (C = k): it never drops one, while the forward's group of S tokens
    drops those past an expert's capacity, and at random weights the
    routing crowds a few experts; so the moe check runs at the capacity
    that drops none (C = G), and the timed forward's drops are
    counted."""
    dev = batch["tokens"].device
    out = {"atol": LM_ATOL, "rtol": LM_RTOL, "fp32_tol": FAMILY_FP32_TOL}
    if cfg.family == "moe":
        out["forward_dropped_slots_by_layer"] = moe_drops(api, params,
                                                          batch)
    dec32, fwd32, out["what"] = decode_vs_forward(
        dataclasses.replace(cfg, dtype=torch.float32), params, batch, dev)
    with (checked_flash(flash_checks) if cfg.use_flash_kernel
          else contextlib.nullcontext()):
        dec16, fwd16, _ = decode_vs_forward(
            dataclasses.replace(cfg, dtype=torch.bfloat16), params, batch,
            dev)
    out["float32"], out["bfloat16"] = (decode_gap(dec32, fwd32),
                                       decode_gap(dec16, fwd16))
    e_fwd, e_dec = rel_l2(fwd16, fwd32), rel_l2(dec16, fwd32)
    limit = max(BF16_DECODE_MULT * e_fwd, LM_RTOL)
    out["bf16_from_fp32_forward"] = {
        "forward_rel_l2": e_fwd, "decode_rel_l2": e_dec,
        "decode_over_forward": e_dec / e_fwd, "limit": limit,
        "ok": e_dec <= limit}
    fp32 = out["float32"]
    out["ok"] = out["bf16_from_fp32_forward"]["ok"] and (
        fp32["within_fp32_tol"] if cfg.use_flash_kernel
        else fp32["max_rel_l2"] <= CHUNKED_REL_L2)
    return out


def moe_drops(api, params, batch):
    """Token slots one forward's routing drops past capacity, by layer."""
    _, routes = captured_routes(lambda: api.forward(params, batch))
    return [g.shape[:-1].numel() * api.cfg.top_k
            - int(d.sum(dtype=torch.float32)) for g, d, _ in routes]


def family_engine(cfg, api, params, dev):
    """The greedy Engine: 8 requests of 4-16 prompt tokens, 16 new each,
    on 4 slots (a per-slot ctx for the ctx families)."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.serve.engine import Engine, Request

    rng = np.random.default_rng(1)
    ctx = None
    if api.needs_ctx:
        ctx = torch.from_numpy(rng.standard_normal(
            (4, cfg.n_ctx_tokens, cfg.d_model)).astype(np.float32)).to(dev)
    eng = Engine(api, params, n_slots=4, max_seq=256, ctx=ctx, device=dev)
    for i in range(8):
        prompt = rng.integers(1, cfg.vocab, int(rng.integers(4, 17)))
        eng.submit(Request(rid=i, prompt=[int(t) for t in prompt],
                           max_new=16))
    kernels.reset_launch_counts()
    done, ticks = [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.pool.pending():
        done += eng.tick()
        ticks += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_tok = sum(len(r.out) for r in done)
    routes = dict(flash_attention.launches_by_route)
    out = {"slots": 4, "max_seq": 256, "requests": 8,
           "completed": len(done), "ticks": ticks, "tokens": n_tok,
           "wall_s": wall, "tokens_per_s": n_tok / wall,
           "ms_per_tick": wall / ticks * 1e3, "flash_routes": routes,
           "flash_per_tick": {r: n / ticks for r, n in routes.items()}}
    ok = len(done) == 8 and all(len(r.out) == 16 for r in done)
    return out, ok


def family_run(dev, arch, n_layers, b, s):
    """One family at full width (depth ``n_layers`` or the published
    one), bf16: (a) timed forwards, (b) the decode check, (c) the
    Engine.  Returns the line and the forward's flash routes."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.registry import count_params, get_model

    cfg = family_config(arch, n_layers)
    api = get_model(cfg)
    params = family_params(api, cfg, dev)
    batch = family_batch(api, cfg, b, s, dev)
    expect = family_flash_routes(cfg)
    out = {"phase": "lm_families", "arch": arch, "family": cfg.family,
           "dtype": "bfloat16", "n_layers": cfg.n_layers,
           "published_layers": family_config(arch).n_layers,
           "params": count_params(params), "batch": b, "seq": s,
           "ctx_tokens": cfg.n_ctx_tokens if api.needs_ctx else 0,
           "attention": "flash" if cfg.use_flash_kernel else
           "chunked (logit softcap)"}
    with torch.inference_mode():
        api.forward(params, batch)                 # warm-up, not counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(FAMILY_FORWARDS):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            full = api.forward(params, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            routes = dict(flash_attention.launches_by_route)
            if routes != expect:
                raise AssertionError(f"{arch} forward launched flash "
                                     f"{routes}, expected {expect}")
        wall = float(np.median(walls))
        out["forward"] = {"wall_s": wall, "walls_s": walls,
                          "tokens_per_s": b * s / wall,
                          "flash_routes": routes,
                          "peak_mem_gb": torch.cuda.max_memory_allocated()
                          / 1e9}
        if full.shape != (b, s, cfg.vocab) or not bool(
                full.isfinite().all()):
            raise AssertionError(f"{arch} logits: shape {full.shape}, "
                                 f"finite {bool(full.isfinite().all())}")
        del full
        prof = profile_forward(api, params, batch, wall,
                               f"one warm {arch} forward ({cfg.n_layers} "
                               f"layers), {b} x {s} tokens, bf16")
        out["forward"]["idle_share_of_unprofiled_wall"] = prof.get(
            "idle_share_of_unprofiled_wall")
        # every flash call of one more forward and of the bf16 decode
        # check against the plain version on its inputs
        flash_checks = {}
        if cfg.use_flash_kernel:
            with checked_flash(flash_checks):
                api.forward(params, batch)
        out["decode"] = family_decode_check(cfg, api, params, batch,
                                            flash_checks)
        out["flash_in_model"] = flash_checks
    out["engine"], engine_ok = family_engine(cfg, api, params, dev)
    emit(out)
    bad = {k: c for k, c in flash_checks.items() if not c["ok"]}
    if bad or sum(c["calls"] for c in flash_checks.values()) < sum(
            expect.values()):
        raise AssertionError(f"{arch}: flash_attention in the model "
                             f"differs from its plain version: "
                             f"{bad or flash_checks}")
    if not out["decode"]["ok"]:
        raise AssertionError(f"{arch}: decode differs from the forward: "
                             f"{out['decode']}")
    if not engine_ok:
        raise AssertionError(f"{arch}: the engine completed "
                             f"{out['engine']['completed']} of 8 requests")
    return routes, out["engine"]["flash_routes"]


def captured_routes(fn):
    """fn() with `moe.route` wrapped: its result and each routing's
    gates, dispatch and combine, on the CPU."""
    from repro_torch.models import moe

    route, seen = moe.route, []

    def capturing(cfg, gates, c):
        dispatch, combine = route(cfg, gates, c)
        seen.append(tuple(x.cpu() for x in (gates, dispatch, combine)))
        return dispatch, combine

    moe.route = capturing
    try:
        return fn(), seen
    finally:
        moe.route = route


def moe_routing_vs_cpu(cfg, on_cpu, on_card, dev):
    """One MoE layer's routing, card against CPU, at the configured
    capacity (tokens past it dropped): the card's routing of the CPU's
    gates equal bit for bit; the tokens whose ordered top-k differs
    (a flip), each of them a near-tie (two of its gates closer than
    twice the largest difference between the two sides' gates for that
    token); kept slots per expert and dispatch (equal where no token
    flipped); combine's largest difference beside the gates'.  Also the
    tokens (B, S) that kept the same experts on both sides."""
    from repro_torch.models import moe

    (gc, dc, cc), (gd, dd, cd) = on_cpu, on_card
    k = cfg.top_k
    d2, c2 = moe.route(cfg, gc.to(dev), dc.shape[-1])
    order_c = gc.sort(dim=-1, descending=True, stable=True).indices[..., :k]
    order_d = gd.sort(dim=-1, descending=True, stable=True).indices[..., :k]
    flipped = (order_c != order_d).any(-1)
    top = gc.sort(-1, descending=True).values[..., :k + 1]
    margin = (top[..., :-1] - top[..., 1:]).min(-1).values
    near_tie = margin <= 2 * (gd - gc).abs().max(-1).values
    kept_c, kept_d = dc.float().sum(-1) > 0, dd.float().sum(-1) > 0
    same = (kept_c == kept_d).all(-1)
    slots_c, slots_d = dc.float().sum((2, 4)), dd.float().sum((2, 4))
    out = {"capacity": dc.shape[-1],
           "card_routing_of_cpu_gates_exact": torch.equal(d2.cpu(), dc)
           and torch.equal(c2.cpu(), cc),
           "max_gate_diff": float((gd - gc).abs().max()),
           "topk_flips": int(flipped.sum()),
           "flips_near_ties": int((flipped & near_tie).sum()),
           "tokens_kept_differently": int((~same).sum()),
           "dropped_slots": {"cpu": int(gc.shape[:-1].numel() * k
                                        - slots_c.sum()),
                             "card": int(gd.shape[:-1].numel() * k
                                         - slots_d.sum())},
           "kept_slots_per_expert_equal": torch.equal(slots_c, slots_d),
           "dispatch_equal": torch.equal(dc, dd),
           "combine_max_abs_diff": float((cd - cc).abs().max())}
    # with no flip the two sides keep the same slots; combine then
    # differs only as the gates do (their arithmetic is the exact check
    # above)
    out["ok"] = (out["card_routing_of_cpu_gates_exact"]
                 and out["flips_near_ties"] == out["topk_flips"]
                 and (out["topk_flips"] > 0 or (
                     out["dispatch_equal"]
                     and out["kept_slots_per_expert_equal"])))
    return out, same.reshape(same.shape[0], -1)


def family_parity(dev, arch):
    """The family at full width and the fewest layers its layout allows,
    fp32, on the card and on the CPU (plain version) from the same
    weights: logits within PARITY_TOL; the host RAM the CPU side held.
    grok-1 (the chunked route, its configured capacity factor, one MoE
    layer): the routing by `moe_routing_vs_cpu`, and the logits'
    relative L2 error over the tokens that kept the same experts on both
    sides within MOE_PARITY_REL_L2."""
    import resource

    from repro_torch.models.registry import count_params, get_model

    pub = family_config(arch)
    depth = {"moe": 1, "ssm": pub.slstm_every, "hybrid": pub.attn_every,
             "vlm": pub.cross_attn_every, "audio": 1}[pub.family]
    cfg = family_config(arch, depth, dtype=torch.float32)
    api = get_model(cfg)
    b = 1
    with torch.inference_mode():
        on_card = family_params(api, cfg, dev)
        on_cpu = move(on_card, "cpu")
        batch = family_batch(api, cfg, b, FAMILY_PARITY_S, "cpu", seed=2)
        t0 = time.perf_counter()
        want, cpu_routes = captured_routes(lambda: api.forward(on_cpu,
                                                               batch))
        cpu_s = time.perf_counter() - t0
        got, card_routes = captured_routes(
            lambda: api.forward(on_card, move(batch, dev)).cpu())
    err = float((got - want).abs().max())
    rel = rel_l2(got, want)
    out = {"phase": "lm_families_parity", "arch": arch, "n_layers":
           cfg.n_layers, "seq": FAMILY_PARITY_S, "batch": b,
           "ctx_tokens": cfg.n_ctx_tokens if api.needs_ctx else 0,
           "dtype": "float32", "params": count_params(on_cpu),
           "host_param_gb": count_params(on_cpu) * 4 / 1e9,   # fp32
           "host_max_rss_gb": resource.getrusage(
               resource.RUSAGE_SELF).ru_maxrss / 1e6,
           "cpu_forward_s": cpu_s, "max_abs_err": err, "rel_l2": rel,
           "max_abs_logit": float(want.abs().max())}
    if cfg.family == "moe":
        out["capacity_factor"] = cfg.capacity_factor
        out["routing"], same = moe_routing_vs_cpu(cfg, cpu_routes[0],
                                                  card_routes[0], dev)
        kept_rel = rel_l2(got[same], want[same])
        out.update(rel_l2_same_experts=kept_rel,
                   tol={"rel_l2_same_experts": MOE_PARITY_REL_L2},
                   ok=out["routing"]["ok"] and len(cpu_routes) == 1
                   and kept_rel <= MOE_PARITY_REL_L2)
    else:
        out.update(tol=PARITY_TOL, ok=bool(torch.allclose(
            got, want, atol=PARITY_TOL, rtol=PARITY_TOL)))
    emit(out)
    if not out["ok"]:
        raise AssertionError(f"{arch}: card forward differs from the CPU's: "
                             f"{out}")


def family_flash(dev):
    """flash_attention at the families' shapes, bf16, through the
    wrapper: against the plain version (FLASH_TOL), on the route the rule
    gives; device time, eager call, plain version, the bound (the larger
    of the visible pairs' FLOP at the bf16 peak and q/k/v/o's bytes at
    the HBM rate) and ``scaled_dot_product_attention`` on the same
    inputs."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     mha_plain, route)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(5)
    rows, failed = [], []
    for what, shape in FAMILY_FLASH:
        b, hq, hkv, sq, sk, d, causal = shape
        q, k, v = flash_inputs(gen, shape, torch.bfloat16, dev, True)
        qc, kc, vc = (x.contiguous() for x in (q, k, v))
        before = dict(flash_attention.launches_by_route)
        got = flash_attention(q, k, v, causal=causal).float()
        took = [r for r, n in flash_attention.launches_by_route.items()
                if n != before[r]]
        want = mha_plain(q, k, v, causal=causal).float()
        err = float((got - want).abs().max())
        tol = FLASH_TOL[torch.bfloat16]
        ok = bool(torch.allclose(got, want, atol=tol, rtol=tol)) and \
            took == [route(q, k, v)]
        pairs = (sum(min(sk, max(0, sk - sq + i + 1)) for i in range(sq))
                 if causal else sq * sk)
        flops = 4 * b * hq * pairs * d
        io_bytes = sum(x.numel() * x.element_size() for x in (q, k, v, q))
        by_ops = flops / BF16_FLOP_PER_S * 1e3
        by_bytes = io_bytes / MEM_BYTES_PER_S * 1e3
        rows.append(dict(
            what=what, shape=list(shape), route=took, max_abs_err=err,
            tol=tol, ok=ok,
            ms=device_ms(lambda: flash_attention(q, k, v, causal=causal),
                         20),
            call_ms=time_ms(lambda: flash_attention(q, k, v, causal=causal),
                            20),
            plain_ms=time_ms(lambda: mha_plain(q, k, v, causal=causal), 3),
            library_ms=device_ms(lambda: sdpa(qc, kc, vc, is_causal=causal,
                                              enable_gqa=True), 20),
            flops=flops, bytes=io_bytes, bound_ms=max(by_ops, by_bytes),
            bound_by="operations" if by_ops >= by_bytes else "bytes"))
        if not ok:
            failed.append(rows[-1])
    emit({"phase": "lm_families_flash", "kernel": "flash_attention",
          "shapes": rows})
    if failed:
        raise AssertionError(f"flash_attention at the families' shapes: "
                             f"{failed}")
    return rows


def lm_families(dev):
    """The five other families on the serving path (phase 11b): each at
    full width in bf16, then card vs CPU in fp32, then flash_attention
    at their shapes.  Returns the flash launches by route of the
    families' forwards and Engine runs (and of each family's forward),
    and the flash rows."""
    totals = {"forward": dict.fromkeys(("sm90_bf16", "cuda_core"), 0),
              "engine": dict.fromkeys(("sm90_bf16", "cuda_core"), 0),
              "forward_by_arch": {}}
    for arch, n_layers, b, s in FAMILY_RUNS:
        fwd, eng = family_run(dev, arch, n_layers, b, s)
        totals["forward_by_arch"][arch] = dict(fwd)
        for r in fwd:
            totals["forward"][r] += fwd[r]
            totals["engine"][r] += eng[r]
        torch.cuda.empty_cache()
    for arch, _, _, _ in FAMILY_RUNS:
        family_parity(dev, arch)
        torch.cuda.empty_cache()
    # bf16 at every head dim of the families (zamba2's 80 too) is on the
    # Hopper route; the CUDA-core route runs their fp32 parity forwards
    if not totals["forward"]["sm90_bf16"] or totals["forward"]["cuda_core"]:
        raise AssertionError(f"the families' bf16 forwards launched flash "
                             f"{totals['forward']}: expected the Hopper "
                             f"route only")
    return totals, family_flash(dev)


# ---- training (phase 11c) ----------------------------------------------------

def quiet(_):
    pass


def train_batches(cfg, n, b, s, seed=0):
    """The first ``n`` batches of the synthetic stream, made (numpy)
    before any step is timed."""
    from repro_torch.data.synthetic import DataConfig, batch_at

    data = DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b, seed=seed)
    return [batch_at(data, i) for i in range(n)]


def train_one(trainer, batch, walls, res):
    """One step through ``Trainer.fit``: its wall (synced), loss and
    pre-clip gradient norm appended."""
    trainer.tcfg.total_steps = trainer.step_idx + 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = trainer.fit(iter([batch]))
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
    res["losses"] += out["losses"]
    res["grad_norms"] += out["grad_norms"]


def profile_train_step(trainer, batch, step_wall_s):
    """One more step under torch.profiler: device time by kind (bf16
    products, fp32 products: the chunked attention's einsums, TF32 off;
    the optimizer: every kernel launched inside ``apply_updates``, by
    correlation id; copies and casts, reductions, the elementwise rest)
    and the device's idle share against the unprofiled step's wall.
    Emits a ``profile`` line and returns it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.train import optimizer as opt

    apply_updates = opt.apply_updates

    def marked(*a, **kw):
        with record_function("adamw"):
            return apply_updates(*a, **kw)

    opt.apply_updates = marked
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            train_one(trainer, batch, [], {"losses": [], "grad_norms": []})
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        opt.apply_updates = apply_updates
    cuda = torch.autograd.DeviceType.CUDA
    raw = list(prof.profiler.kineto_results.events())
    spans = [(e.start_ns(), e.end_ns()) for e in raw
             if e.device_type() != cuda and e.name() == "adamw"]
    opt_ids = {e.correlation_id() for e in raw
               if e.device_type() != cuda and e.correlation_id()
               and any(a <= e.start_ns() <= z for a, z in spans)}
    # the device-side span of the "adamw" range itself is no kernel
    dev_events = [e for e in device_events(prof) if e.name != "adamw"]
    out = {"phase": "profile", "what": f"one warm {TRAIN_ARCH} train step, "
           f"{TRAIN_B} x {TRAIN_S} tokens, fp32 params, bf16 compute",
           "wall_ms_profiled": wall_us / 1e3,
           "device_events": len(dev_events)}
    if not dev_events:
        out["note"] = "the profiler showed no device time on this machine"
        emit(out)
        return out
    ids = [e.correlation_id() for e in raw
           if e.device_type() == cuda and e.name() != "adamw"]
    busy, window = device_busy(dev_events)
    by_kind, by_name = {}, {}
    matmul = ("gemm", "nvjet", "xmma", "cutlass", "cublas")
    fp32 = ("f32f32_f32f32", "sgemm", "_sss_", "simt", "fp32_fp32")
    for e, cid in zip(dev_events, ids):
        us = e.time_range.end - e.time_range.start
        low = e.name.lower()
        if cid in opt_ids:
            kind = "optimizer (AdamW)"
        elif any(w in low for w in matmul):
            kind = ("fp32 matmul (attention einsums)"
                    if any(w in low for w in fp32) else "bf16 matmul")
        elif any(w in low for w in ("copy", "memcpy", "memset")):
            kind = "copy/cast"
        elif "reduce" in low:
            kind = "reduction"
        elif "elementwise" in low:
            kind = "elementwise"
        else:
            kind = "other"
        by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3
        n, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (n + us, c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    out.update(device_window_ms=window / 1e3, device_busy_ms=busy / 1e3,
               idle_share_of_wall=1 - busy / wall_us,
               idle_share_of_unprofiled_wall=1 - busy / (step_wall_s * 1e6),
               by_kind_ms=by_kind,
               optimizer_launches=sum(c in opt_ids for c in ids),
               top_kernels=[{"name": n[:100], "ms": us / 1e3, "count": c}
                            for n, (us, c) in top])
    emit(out)
    return out


def train_full_width(dev):
    """Part (a): tinyllama-1.1b at full width and depth through the
    Trainer on the card: one warm step, TRAIN_TIMED timed, one profiled,
    AdamW alone, then one timed step with the int8 round trip.  Not one
    launch of a hand-written kernel (training takes the chunked
    attention; no kernel has a backward)."""
    from repro_torch import kernels
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import count_params, get_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import leaves

    cfg = get_config(TRAIN_ARCH)
    if cfg.use_flash_kernel or cfg.dtype != torch.bfloat16:
        raise AssertionError(f"{cfg.name}: training runs bf16 on the "
                             f"chunked route, not {cfg.dtype} with flash "
                             f"{cfg.use_flash_kernel}")
    api = get_model(cfg)
    batches = train_batches(cfg, TRAIN_TIMED + 4, TRAIN_B, TRAIN_S)
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    trainer = Trainer(api, opt.AdamWConfig(**TRAIN_OPT),
                      TrainerConfig(total_steps=0, ckpt_every=0,
                                    log_every=10 ** 9),
                      seed=0, device=dev, log_fn=quiet)
    n_params = count_params(trainer.params)

    def probes(p):
        return {"embed.tok": p["embed"]["tok"][:4],
                "embed.head": p["embed"]["head"][:, :4],
                "layers.attn.wq[0]": p["layers"]["attn"]["wq"][0, :4],
                "layers.mlp.w_down[-1]": p["layers"]["mlp"]["w_down"][-1, :4],
                "layers.norm1": p["layers"]["norm1"]}

    before = {k: v.detach().clone() for k, v in probes(trainer.params).items()}
    walls, res = [], {"losses": [], "grad_norms": []}
    train_one(trainer, batches[0], walls, res)             # warm
    torch.cuda.reset_peak_memory_stats()
    for b in batches[1:1 + TRAIN_TIMED]:
        train_one(trainer, b, walls, res)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_s = float(np.median(walls[1:]))
    moved = {k: float((v.float() - before[k].float()).abs().max())
             for k, v in probes(trainer.params).items()}
    tokens = TRAIN_B * TRAIN_S
    flop_per_token = 6 * n_params + 12 * cfg.n_layers * TRAIN_S * cfg.d_model
    prof = profile_train_step(trainer, batches[1 + TRAIN_TIMED], step_s)

    # AdamW alone on the trainer's state (the moments stand in for the
    # gradients: the same work), by CUDA events
    ocfg = trainer.opt_cfg
    adamw_ms = time_ms(lambda: opt.apply_updates(
        ocfg, trainer.params, trainer.opt_state["m"], trainer.opt_state),
        3)
    # its floor: p, g, m, v read once and p, m, v written once
    adamw_bytes = sum(x.numel() * x.element_size() for t in (
        trainer.params, trainer.params, trainer.opt_state["m"],
        trainer.opt_state["v"]) for x in leaves(t)) * 7 / 4
    del trainer
    torch.cuda.empty_cache()

    # one timed step with the int8 round trip (a fresh Trainer)
    comp = Trainer(api, opt.AdamWConfig(**TRAIN_OPT),
                   TrainerConfig(total_steps=0, ckpt_every=0,
                                 compress_grads=True, log_every=10 ** 9),
                   seed=0, device=dev, log_fn=quiet)
    cwalls, cres = [], {"losses": [], "grad_norms": []}
    train_one(comp, batches[-2], cwalls, cres)             # warm
    train_one(comp, batches[-1], cwalls, cres)
    del comp
    torch.cuda.empty_cache()
    launches = kernels.launch_counts()

    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": n_params, "dtype": "bfloat16 compute, fp32 params",
           "attention": "chunked, every block recomputed",
           "batch": TRAIN_B, "seq": TRAIN_S, "tokens_per_step": tokens,
           "step_s": step_s, "walls_s": walls, "warm_step_s": walls[0],
           "tokens_per_s": tokens / step_s, "losses": res["losses"],
           "grad_norms": res["grad_norms"], "peak_mem_gb": peak_gb,
           "params_moved": moved,
           "model_flop_per_token": flop_per_token,
           "model_flop_share": tokens / step_s * flop_per_token
           / BF16_FLOP_PER_S,
           "model_flop_share_formula":
               "tokens/s x (6 N + 12 L S d) / 989e12 (N all parameters; "
               "the chunked route computes every key)",
           "profile": {k: prof.get(k) for k in (
               "by_kind_ms", "device_busy_ms", "idle_share_of_wall",
               "idle_share_of_unprofiled_wall", "optimizer_launches",
               "device_events")},
           "adamw_alone_ms": adamw_ms,
           "adamw_bytes": adamw_bytes,
           "adamw_bound_ms": adamw_bytes / MEM_BYTES_PER_S * 1e3,
           "compressed": {"step_s": cwalls[1], "warm_step_s": cwalls[0],
                          "losses": cres["losses"],
                          "grad_norms": cres["grad_norms"]},
           "launches": launches}
    finite = all(np.isfinite(res["losses"] + res["grad_norms"]
                             + cres["losses"] + cres["grad_norms"]))
    if not finite:
        raise AssertionError(f"train: non-finite loss or norm: {out}")
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"train: params did not move: {moved}")
    if any(launches.values()):
        raise AssertionError(f"train: hand-written kernels launched in a "
                             f"train step: {launches}")
    return out


def _flat(tree, prefix=""):
    """A tree's leaves by dotted key."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _flat_cpu(tree):
    """A tree of tensors as {key: fp32 numpy}."""
    return {k: v.detach().float().cpu().numpy()
            for k, v in _flat(tree).items()}


def train_step_card_vs_cpu(cfg, batch, dev):
    """One accum-2 step of ``cfg`` (fp32) on the card and on the CPU from
    the same weights (``params_from_numpy``) and batch: the loss, the
    pre-clip norm, every gradient leaf and the new params under the
    tests' rule.  Returns the comparison; raises where it fails."""
    from repro_torch.models.registry import get_model, params_from_numpy
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import build_train_step
    from repro_torch.tree import map_tree

    api = get_model(cfg)
    tree = map_tree(lambda t: t.numpy(), api.init(0, device="cpu"))
    ocfg = opt.AdamWConfig(lr=TRAIN_LR, warmup_steps=0)
    got = {}
    for where in ("cpu", dev):
        params = params_from_numpy(cfg, tree, device=where)
        seen = []
        step = build_train_step(api, ocfg, accum=2,
                                compress_grads=lambda g: seen.append(g) or g)
        t0 = time.perf_counter()
        new, _, met = step(params, opt.init_state(ocfg, params),
                           {k: torch.from_numpy(v).to(where)
                            for k, v in batch.items()})
        loss = float(met["loss"])
        got[str(where)] = dict(loss=loss, norm=float(met["grad_norm"]),
                               grads=_flat_cpu(seen[0]),
                               params=_flat_cpu(new),
                               wall_s=time.perf_counter() - t0)
    cpu, card = got["cpu"], got[str(dev)]
    worst_grad, worst_sure, worst_param, n_uncertain = 0.0, 0.0, 0.0, 0
    for k, g in cpu["grads"].items():
        bound = (TRAIN_GRAD_RTOL * np.abs(g) + TRAIN_GRAD_ATOL
                 + TRAIN_FLIP_SCALE * np.abs(g).max())
        worst_grad = max(worst_grad,
                         float((np.abs(card["grads"][k] - g) / bound).max()))
        sure = np.abs(g) > np.maximum(TRAIN_GRAD_SMALL, bound)
        diff = np.abs(card["params"][k] - cpu["params"][k])
        n_uncertain += int((~sure).sum())
        worst_param = max(worst_param, float(diff.max()))
        if sure.any():
            worst_sure = max(worst_sure, float(diff[sure].max()))
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    norm_rel = abs(card["norm"] - cpu["norm"]) / abs(cpu["norm"])
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "batch": list(batch["tokens"].shape),
           "loss": cpu["loss"], "loss_rel_err": loss_rel,
           "grad_norm_rel_err": norm_rel,
           "worst_grad_err_over_bound": worst_grad,
           "worst_param_err_sure_sign": worst_sure,
           "worst_param_err": worst_param,
           "uncertain_sign_elements": n_uncertain,
           "cpu_s": cpu["wall_s"], "card_s": card["wall_s"]}
    if not (loss_rel <= TRAIN_LOSS_RTOL and norm_rel <= TRAIN_NORM_RTOL
            and worst_grad <= 1 and worst_sure <= TRAIN_PARAM_ATOL
            and worst_param <= 2 * TRAIN_LR):
        raise AssertionError(f"train step card vs CPU: {out}")
    return out


def train_card_vs_cpu(dev):
    """Part (b): one accum-2 fp32 step, card against CPU, at tinyllama
    widths (2 layers, 2 x 256 tokens), then at each family's small
    config."""
    from repro_torch.configs.registry import get_config, get_smoke

    def batch_for(cfg, b, s):
        rng = np.random.default_rng(3)
        out = {"tokens": rng.integers(0, cfg.vocab, (b, s)),
               "labels": rng.integers(0, cfg.vocab, (b, s))}
        if cfg.family in ("vlm", "audio"):
            out["ctx"] = rng.standard_normal(
                (b, cfg.n_ctx_tokens, cfg.d_model)).astype(np.float32)
        return out

    wide = dataclasses.replace(get_config(TRAIN_ARCH),
                               n_layers=TRAIN_PARITY_LAYERS,
                               dtype=torch.float32)
    rows = [train_step_card_vs_cpu(
        wide, batch_for(wide, TRAIN_PARITY_B, TRAIN_PARITY_S), dev)]
    for arch in TRAIN_FAMILY_ARCHS:
        cfg = dataclasses.replace(get_smoke(arch), dtype=torch.float32)
        rows.append(train_step_card_vs_cpu(
            cfg, batch_for(cfg, TRAIN_FAMILY_B, TRAIN_FAMILY_S), dev))
    return rows


def train_checkpoints(dev):
    """Part (c): at the smoke width, a Trainer fits TRAIN_CKPT_STEPS steps
    on the card with a checkpoint every TRAIN_CKPT_EVERY (TRAIN_CKPT_KEEP
    kept), a fresh Trainer (another seed) resumes: every leaf of its state
    bit-equal, on the card, in its dtype; then prune to 1."""
    import os
    import tempfile

    from repro_torch.configs.registry import get_smoke
    from repro_torch.data.synthetic import DataConfig, Stream
    from repro_torch.models.registry import get_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_smoke(TRAIN_ARCH)
    api = get_model(cfg)
    ocfg = opt.AdamWConfig(lr=TRAIN_LR, warmup_steps=2)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        first = Trainer(api, ocfg, TrainerConfig(
            total_steps=TRAIN_CKPT_STEPS, ckpt_every=TRAIN_CKPT_EVERY,
            ckpt_dir=d, ckpt_keep=TRAIN_CKPT_KEEP, log_every=10 ** 9),
            seed=0, device=dev, log_fn=quiet)
        res = first.fit(Stream(DataConfig(vocab=cfg.vocab, seq_len=64,
                                          global_batch=8)))
        fit_s = time.perf_counter() - t0
        kept = sorted(n for n in os.listdir(d) if n.startswith("step_"))
        second = Trainer(api, ocfg, TrainerConfig(ckpt_dir=d), seed=1,
                         device=dev, log_fn=quiet)
        resumed = second.maybe_resume()
        want, got = _flat(first.state()), _flat(second.state())
        unequal = [k for k, a in want.items() if k not in got or not (
            a.dtype == got[k].dtype and a.device == got[k].device
            and torch.equal(a, got[k]))]
        leaves = len(want)
        ckpt.prune(d, keep=1)
        after_prune = sorted(n for n in os.listdir(d)
                             if n.startswith("step_"))
    want_kept = [f"step_{s:08d}" for s in range(
        TRAIN_CKPT_STEPS - (TRAIN_CKPT_KEEP - 1) * TRAIN_CKPT_EVERY,
        TRAIN_CKPT_STEPS + 1, TRAIN_CKPT_EVERY)]
    out = {"arch": cfg.name, "dtype": str(cfg.dtype).replace("torch.", ""),
           "steps": res["final_step"], "fit_s": fit_s,
           "losses_first_last": [res["losses"][0], res["losses"][-1]],
           "kept": kept, "resumed": resumed, "resumed_step": second.step_idx,
           "leaves": leaves, "unequal_leaves": unequal,
           "after_prune_keep_1": after_prune,
           "full_width": "skipped: 17.6 GB of fp32 params and moments to "
                         "the machine's disk"}
    if not (resumed and second.step_idx == TRAIN_CKPT_STEPS and not unequal
            and set(got) == set(want)
            and kept == want_kept and after_prune == want_kept[-1:]
            and res["losses"][-1] < res["losses"][0]):
        raise AssertionError(f"train checkpoints: {out}")
    return out


def train_phase(dev):
    """Phase 11c: the training path on the card (parts a-c), one ``train``
    line.  Returns the hand-written kernels' launches in part (a)."""
    full = train_full_width(dev)
    parity = train_card_vs_cpu(dev)
    ckpts = train_checkpoints(dev)
    emit({"phase": "train", "full_width": full, "card_vs_cpu": parity,
          "checkpoints": ckpts})
    return full["launches"]


# ---- serving, figures and the weave bench (phases 12-14) -----------------

# integer fields of a serving cell, held exactly; floats within RTOL
SERVE_EXACT = ("model", "preset", "arrival", "rate", "n_requests", "n_slots",
               "steps", "accesses", "shard", "bytes_modeled")
SERVE_REL = ("runtime_ms", "gbps", "req_p50_ms", "req_p95_ms", "req_p99_ms",
             "if_p50_ns", "if_p95_ns", "if_p99_ns")
# the reference's serving golden grid (tests/test_serving.py): (stage,
# preset, smoke model, arrival, sockets); its scenario and window knobs
SERVE_GOLDEN = [
    ("10-delay-buffer", "ddr4_2666", "tinyllama-1.1b", "poisson", 1),
    ("04-model-correct", "ddr5_4800", "xlstm-1.3b", "uniform", 1),
    ("01-baseline", "hbm2e", "arctic-480b", "burst", 2),
    ("10-delay-buffer", "ddr5_4800", "zamba2-2.7b", "poisson", 2)]
SERVE_GOLDEN_SCENARIO = dict(rate=0.5, n_requests=10, n_slots=3)
SERVE_GOLDEN_WINDOWS = dict(windows=6, warmup=2)
SERVE_PROFILED_PRESET = "ddr4_2666"
# the FULL serving batch (12 scenarios) on ddr4_2666, card vs CPU, in a
# few windows: the telemetry instance and window_inject_trace (its Skylake
# decode) at the FULL shapes
SERVE_CPU_PRESET, SERVE_CPU_KNOBS = "ddr4_2666", dict(windows=2, warmup=1)
# the figures' card-vs-CPU grid: stage 10 on the presets whose sweeps had
# never run on the card, one and two sockets
FIG_CPU_STAGE, FIG_CPU_PRESETS = "10-delay-buffer", ("ddr5_4800", "hbm2e")
FIG_CPU_KNOBS, FIG_CPU_PACES, FIG_CPU_MIXES = (dict(windows=6, warmup=2),
                                               (1, 24), (0,))
# ... and the FULL 70-point grid in a few windows at the stage whose
# window_inject runs the Skylake decode, on 6 and 16 channels
FIG_FULL_CPU_STAGE, FIG_FULL_CPU_PRESETS = "07-prefetch", ("ddr4_2666",
                                                           "hbm2e")
FIG_FULL_CPU_KNOBS = dict(windows=2, warmup=1)
SWEEP_VIEWS = ("sim_bw", "sim_lat", "if_bw", "if_lat", "app_bw", "app_lat",
               "chase_lat")


def check_serve_launches(cells, windows):
    """Each preset's replay: one telemetry `weave_window` launch and one
    `window_inject_trace` launch per window (no dense re-run), no
    `decode_packed`, no `window_inject`."""
    for c in cells:
        n = c["launches"]
        if (n["weave_window.telemetry"] != windows
                or n["weave_window"] != windows
                or n["window_inject_trace"] != windows
                or n["decode_packed"] or n["window_inject"]
                or n["frfcfs_select"]):
            raise AssertionError(f"serving {c['preset']}: launches {n}, "
                                 f"expected {windows} telemetry weave_window"
                                 f" and window_inject_trace, no "
                                 f"decode_packed")


def serving_card_vs_cpu(dev):
    """(d) of the serving phase: the FULL batch (12 scenarios) on one
    preset in a few windows, the card against the CPU's plain route, bit
    for bit in every view, count and ``tele_*`` plane.  Returns the card's
    launches."""
    from repro_torch import kernels
    from repro_torch.bench import serving
    from repro_torch.traces import replay_suite, stack_traces, to

    _, lowered = serving.lower_grid(serving.FULL_MODELS, serving.FULL_RATES,
                                    n_requests=24)
    batch = stack_traces([tr for tr, _, _ in lowered])
    cfg = dataclasses.replace(
        serving._stage_cfg(SERVE_CPU_PRESET,
                           windows=SERVE_CPU_KNOBS["windows"]),
        warmup=SERVE_CPU_KNOBS["warmup"])
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    card = replay_suite(cfg, to(batch, dev), device=dev)
    card_s = time.perf_counter() - t0
    launches = serving.kernel_launches()
    t0 = time.perf_counter()
    cpu = replay_suite(cfg, batch, device="cpu")
    cpu_s = time.perf_counter() - t0
    rel = compare_replay(card, cpu)
    differ = sorted(set(card) ^ set(cpu)) + [
        k for k in cpu if not np.array_equal(
            card[k], cpu[k], equal_nan=cpu[k].dtype.kind == "f")]
    tele = sorted(k for k in cpu if k.startswith("tele_"))
    emit({"phase": "serving", "part": "full_card_vs_cpu",
          "preset": SERVE_CPU_PRESET, **SERVE_CPU_KNOBS,
          "rows": len(lowered), "keys": len(cpu), "tele_planes": tele,
          "max_rel_err": rel, "differ": differ, "card_s": card_s,
          "cpu_s": cpu_s, "launches": launches})
    if differ or not tele:
        raise AssertionError(f"serving FULL {SERVE_CPU_PRESET}: card != CPU "
                             f"in {differ} (tele planes {tele})")
    check_serve_launches([{"preset": SERVE_CPU_PRESET,
                           "launches": launches}],
                         SERVE_CPU_KNOBS["windows"])
    return launches


def serving_phase(dev):
    """LLM-serving traffic on the card: (a) the SMOKE grid through the
    port's `bench.serving.main` against the reference's tracked
    ``reports/benchmarks/BENCH_serve.json``; (b) the reference's golden
    grid, dense == covering-budget event on the card; (c) the FULL grid,
    its walls and launches, and one preset's replay profiled.  Returns
    the launches of (a), (b), (c) and (d)."""
    import tempfile

    from repro_torch import kernels
    from repro_torch.bench import serving
    from repro_torch.configs.registry import get_smoke
    from repro_torch.core import get_stage, run_frontend
    from repro_torch.traces import (ServeScenario, TraceFrontend,
                                    lower_scenario, to)

    want = json.loads((ROOT / "reports" / "benchmarks"
                       / "BENCH_serve.json").read_text())
    with tempfile.TemporaryDirectory() as tmp:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        cells = serving.main(full=False, device=dev, out_dir=tmp)
        wall = time.perf_counter() - t0
        got = json.loads((pathlib.Path(tmp) / "BENCH_serve.json").read_text())
    smoke_launches = serving.kernel_launches()
    bad, worst_rel, worst_abs = [], 0.0, 0.0
    for k in ("schema", "stage", "models", "presets", "rates"):
        if got[k] != want[k]:
            bad.append((k, got[k], want[k]))
    if len(got["cells"]) != len(want["cells"]):
        bad.append(("cells", len(got["cells"]), len(want["cells"])))
    for g, w in zip(got["cells"], want["cells"]):
        if set(w) - set(g):
            bad.append(("keys", sorted(set(w) - set(g))))
        for k in SERVE_EXACT:
            if g[k] != w[k]:
                bad.append((w["model"], w["preset"], w["rate"], k, g[k], w[k]))
        for k in SERVE_REL:
            rel = abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
            worst_rel = max(worst_rel, rel)
            worst_abs = max(worst_abs, abs(g[k] - w[k]))
            if not rel <= RTOL:
                bad.append((w["model"], w["preset"], w["rate"], k, g[k], w[k]))
    emit({"phase": "serving", "part": "smoke", "wall_s": wall,
          "cells": [{k: c[k] for k in SERVE_EXACT + SERVE_REL
                     + ("wall_s_cell", "replay_wall_s")} for c in cells],
          "max_rel_diff_vs_reference_file": worst_rel,
          "max_abs_diff_vs_reference_file": worst_abs, "rtol": RTOL,
          "launches": smoke_launches})
    if bad:
        raise AssertionError(f"serving SMOKE differs from the reference's "
                             f"BENCH_serve.json: {bad[:10]}")
    check_serve_launches(cells, 6)

    # (b) the golden grid: dense == event under a covering budget
    kernels.reset_launch_counts()
    rows = []
    for stage, preset, model, arrival, sockets in SERVE_GOLDEN:
        trace, _, info = lower_scenario(ServeScenario(
            model=get_smoke(model), arrival=arrival, **SERVE_GOLDEN_SCENARIO))
        batch = to(type(trace)(*(x[None] for x in trace)), dev)
        out = {}
        for weave in ("dense", "event"):
            cfg = get_stage(stage, preset=preset, n_sockets=sockets,
                            weave=weave, **SERVE_GOLDEN_WINDOWS)
            if weave == "event":
                cfg = dataclasses.replace(
                    cfg, weave_events=cfg.clock().ticks_per_window_static)
            out[weave] = run_frontend(
                cfg, TraceFrontend(batch, cfg.workload_config()), batch=1,
                device=dev)
        (vd, od), (ve, oe) = out["dense"], out["event"]
        differ = [f for f, a, b in zip(od._fields, od, oe)
                  if not torch.equal(a, b)]
        differ += [k for k in vd if k not in ("weave_events", "weave_sat")
                   and not torch.equal(vd[k], ve[k])]
        sat = int(ve["weave_sat"].sum())
        rows.append({"stage": stage, "preset": preset, "model": model,
                     "arrival": arrival, "sockets": sockets,
                     "accesses": info["accesses"], "differ": differ,
                     "weave_sat": sat,
                     "n_rd": int(vd["n_rd"].sum()),
                     "events": int(ve["weave_events"].sum())})
        if differ or sat:
            raise AssertionError(f"serving golden cell dense != event on "
                                 f"the card: {rows[-1]}")
    golden_launches = serving.kernel_launches()
    emit({"phase": "serving", "part": "golden", **SERVE_GOLDEN_WINDOWS,
          "scenario": SERVE_GOLDEN_SCENARIO, "cells": rows,
          "launches": golden_launches})
    if golden_launches["weave_window.plain"] != (
            2 * len(SERVE_GOLDEN) * SERVE_GOLDEN_WINDOWS["windows"]):
        raise AssertionError(f"serving golden launches {golden_launches}")

    # (c) the FULL grid
    with tempfile.TemporaryDirectory() as tmp:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        full = serving.main(full=True, device=dev, out_dir=tmp)
        full_wall = time.perf_counter() - t0
    full_launches = serving.kernel_launches()
    per_preset = {}
    for c in full:
        per_preset.setdefault(c["preset"], {
            "replay_wall_s": c["replay_wall_s"], "launches": c["launches"],
            "cells": []})["cells"].append(
            {k: c[k] for k in ("model", "rate", "steps", "accesses",
                               "runtime_ms", "gbps", "req_p50_ms",
                               "req_p99_ms", "if_p50_ns", "if_p99_ns",
                               "wall_s_cell")})
        for k in SERVE_REL:
            if not (np.isfinite(c[k]) and c[k] > 0):
                raise AssertionError(f"serving FULL {c['model']} "
                                     f"{c['preset']}: {k} = {c[k]}")
    emit({"phase": "serving", "part": "full", "wall_s": full_wall,
          "models": list(serving.FULL_MODELS),
          "rates": list(serving.FULL_RATES), "n_requests": 24,
          "windows": 12, "presets": per_preset, "launches": full_launches})
    check_serve_launches(full, 12)

    vs_cpu_launches = serving_card_vs_cpu(dev)

    # one preset's replay (lowering included), timed, then profiled
    grid = (serving.FULL_MODELS, (SERVE_PROFILED_PRESET,),
            serving.FULL_RATES)
    kw = dict(n_requests=24, windows=12, device=dev)
    t0 = time.perf_counter()
    serving.serve_grid(*grid, **kw)
    unprofiled = time.perf_counter() - t0
    prof = profile_run({"phase": "serving", "part": "profile",
                        "preset": SERVE_PROFILED_PRESET,
                        "unprofiled_wall_s": unprofiled},
                       lambda: serving.serve_grid(*grid, **kw), unprofiled,
                       {"weave": "weave_window",
                        "inject": "window_inject_kernel"})
    return {"smoke": smoke_launches, "golden": golden_launches,
            "full": full_launches, "full_wall_s": full_wall,
            "profile": prof, "full_card_vs_cpu": vs_cpu_launches}


def sweep_results(results):
    """The `SweepResult`s of a figure script's first return value."""
    if isinstance(results, dict):
        return list(results.values())
    return list(results) if isinstance(results, tuple) else [results]


def sweep_card_vs_cpu(cfg, preset, paces, mixes, dev):
    """One sweep on the card and on the CPU's plain route; the case's row.
    Raises unless every view is equal bit for bit and the card's sweep ran
    `window_inject` and `weave_window` once a window per engine batch."""
    from repro_torch import kernels
    from repro_torch.core import sweep

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    card = sweep(cfg, paces=paces, write_mixes=mixes, device=dev)
    card_s = time.perf_counter() - t0
    n = kernels.launch_counts()
    t0 = time.perf_counter()
    cpu = sweep(cfg, paces=paces, write_mixes=mixes, device="cpu")
    cpu_s = time.perf_counter() - t0
    rel = max(float((np.abs(getattr(card, f) - getattr(cpu, f))
                     / np.maximum(np.abs(getattr(cpu, f)), 1e-30)).max())
              for f in SWEEP_VIEWS)
    exact = all(np.array_equal(getattr(card, f), getattr(cpu, f))
                for f in SWEEP_VIEWS)
    row = {"stage": cfg.name, "preset": preset, "sockets": cfg.n_sockets,
           "points": len(paces) * len(mixes),
           "channels": cfg.platform.dram.n_channels,
           "max_rel_err": rel, "bit_equal": exact,
           "card_s": card_s, "cpu_s": cpu_s,
           "launches": {k: n[k] for k in ("window_inject", "weave_window",
                                          "decode_packed")}}
    if not exact:
        raise AssertionError(f"figures card vs CPU: {row}")
    if (n["weave_window"] != n["window_inject"]
            or n["weave_window"] % cfg.windows or not n["weave_window"]
            or n["decode_packed"]):
        raise AssertionError(f"figures card vs CPU launches: {row}")
    return row


def figures_phase(dev):
    """Every figure script of the port at FULL on the card (Fig. 2 on all
    three presets, Figs. 3/4, 5, 6, 7), each derived number beside the
    paper's value, each figure's wall and launches (each sweep's wall on
    its ``sweep.`` line); then the card against the CPU, bit for bit, on
    a tiny stage-10 grid on ddr5_4800 and hbm2e at one and two sockets,
    and on stage 07's FULL grid in two windows on ddr4_2666 and hbm2e.
    Returns the launches of the FULL figures."""
    import tempfile

    from repro_torch import kernels
    from repro_torch.bench import (fig2_baseline, fig3_fig4_clocking,
                                   fig5_model_correct, fig6_enhancements,
                                   fig7_portability)
    from repro_torch.core import get_stage, mess
    from repro_torch.core.presets import PRESET_ORDER

    shape = (len(mess.WRITE_MIXES), len(mess.DEFAULT_PACES))
    runs = [("fig2", fig2_baseline.main, {"preset": p}) for p in PRESET_ORDER]
    runs += [("fig3_fig4", fig3_fig4_clocking.main, {}),
             ("fig5", fig5_model_correct.main, {}),
             ("fig6", fig6_enhancements.main, {}),
             ("fig7", fig7_portability.main, {})]
    rows, total = [], dict.fromkeys(("window_inject", "weave_window",
                                     "decode_packed", "frfcfs_select",
                                     "weave_window_recording"), 0)
    with tempfile.TemporaryDirectory() as tmp:
        t_all = time.perf_counter()
        for name, fn, kw in runs:
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            results, emitted = fn(full=True, device=dev, out_dir=tmp, **kw)
            wall = time.perf_counter() - t0
            n = kernels.launch_counts()
            for k in total:
                total[k] += n[k]
            sweeps = sweep_results(results)
            rows.append({"figure": name, **kw, "wall_s": wall,
                         "derived": dict(emitted),
                         "launches": {k: n[k] for k in total}})
            for res in sweeps:
                for f in SWEEP_VIEWS:
                    arr = getattr(res, f)
                    if (arr.shape != shape or not np.isfinite(arr).all()
                            or (arr <= 0).any()):
                        raise AssertionError(f"{name} {res.stage} {f}: "
                                             f"{arr.shape} {arr}")
            if (n["weave_window"] != n["window_inject"]
                    or n["weave_window"] < 96 * len(sweeps)
                    or n["decode_packed"] or n["frfcfs_select"]
                    or n["weave_window_recording"]):
                raise AssertionError(f"{name}: launches {n}")
        all_wall = time.perf_counter() - t_all
        csvs = sorted(p.name for p in pathlib.Path(tmp).glob("*.csv"))
    emit({"phase": "figures", "part": "full", "wall_s": all_wall,
          "figures": rows, "csvs": csvs, "launches": total})

    cases = [sweep_card_vs_cpu(
        get_stage(FIG_CPU_STAGE, preset=preset, n_sockets=sockets,
                  **FIG_CPU_KNOBS), preset, FIG_CPU_PACES, FIG_CPU_MIXES,
        dev)
        for preset in FIG_CPU_PRESETS for sockets in (1, 2)]
    emit({"phase": "figures", "part": "card_vs_cpu", "stage": FIG_CPU_STAGE,
          **FIG_CPU_KNOBS, "paces": list(FIG_CPU_PACES),
          "write_mixes": list(FIG_CPU_MIXES), "cases": cases})
    cases = [sweep_card_vs_cpu(
        get_stage(FIG_FULL_CPU_STAGE, preset=preset, **FIG_FULL_CPU_KNOBS),
        preset, mess.DEFAULT_PACES, mess.WRITE_MIXES, dev)
        for preset in FIG_FULL_CPU_PRESETS]
    emit({"phase": "figures", "part": "full_card_vs_cpu",
          "stage": FIG_FULL_CPU_STAGE, **FIG_FULL_CPU_KNOBS,
          "paces": list(mess.DEFAULT_PACES),
          "write_mixes": list(mess.WRITE_MIXES), "cases": cases})
    return dict(total, wall_s=all_wall)


def weave_bench_phase(dev):
    """The port's weave bench at FULL on the card: each preset's step
    reduction equal to `weave_budgets`' picosecond model, the dense and
    event walls and the event-rate fit beside the calibration report's
    fit.  Returns its launches."""
    import tempfile

    from repro_torch import kernels
    from repro_torch.bench import weave_bench
    from repro_torch.core.mess import CALIBRATION_REPORT
    from repro_torch.core.presets import weave_budgets

    with tempfile.TemporaryDirectory() as tmp:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        report = weave_bench.main(full=True, device=dev, out_dir=tmp)
        wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    # the per-preset fits that `mess.load_event_calibration` registers
    calibration = json.loads(CALIBRATION_REPORT.read_text())["presets"]
    rows, bad = {}, []
    for preset, row in report["presets"].items():
        ticks, events = weave_budgets(preset)["picosecond"]
        cal = calibration.get(preset, {}).get("event_rate_fit")
        rows[preset] = dict(
            {k: row[k] for k in ("dense_wall_s", "event_wall_s", "speedup",
                                 "us_per_window", "ticks_per_window",
                                 "event_budget", "step_reduction",
                                 "event_rate_fit", "paces")},
            weave_budgets_picosecond=[ticks, events],
            calibration_loaded=cal)
        if row["step_reduction"] != round(ticks / events, 2):
            bad.append((preset, row["step_reduction"], ticks, events))
    emit({"phase": "weave_bench", "mode": report["mode"],
          "device": report["device"], "windows": report["windows"],
          "paces": report["paces"], "write_mixes": report["write_mixes"],
          "wall_s": wall, "presets": rows, "launches": launches,
          "table": weave_bench.readme_table(report)})
    if bad:
        raise AssertionError(f"weave bench step reduction differs from "
                             f"weave_budgets: {bad}")
    if report["device"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"weave bench device {report['device']}")
    return dict(launches, wall_s=wall)


def replay_equal(got, want):
    """Keys whose arrays differ between two replay dicts (bit for bit;
    NaN equal to NaN)."""
    return sorted(k for k, v in want.items()
                  if k not in got or not np.array_equal(
                      got[k], v, equal_nan=v.dtype.kind == "f"))


def placement_sweep(cfg, devices, grid):
    """The FAST sweep's engine (`mess._run_points` over ``grid``, the
    body of `sweep`) on ``devices``: ``(out, wall_s, launches)``."""
    from repro_torch import kernels
    from repro_torch.core import mess

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = mess._run_points(cfg, *grid, devices)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, kernels.launch_counts()


def placement_cli(tmp):
    """``python -m repro_torch.bench.run`` in a process of its own:
    ``--list``, ``--only kernels`` and ``--only fig5`` into ``tmp``.
    Returns the listed names, the kernels' rows and fig5's CSV."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def run(*args):
        proc = subprocess.run([sys.executable, "-m", "repro_torch.bench.run",
                               *args], capture_output=True, text=True,
                              env=env, cwd=ROOT, timeout=600)
        if proc.returncode:
            raise AssertionError(f"bench.run {' '.join(args)} exited "
                                 f"{proc.returncode}: {proc.stderr[-3000:]}")
        return proc.stdout.splitlines()

    listed = [ln.split()[0] for ln in run("--list")]
    rows = []
    for ln in run("--only", "kernels", "--out-dir", str(tmp / "kernels")):
        if ln.startswith("kernel."):
            name, us, derived = ln.split(",", 2)
            rows.append({"name": name, "device_us": float(us),
                         "derived": derived})
    run("--only", "fig5", "--out-dir", str(tmp / "cli"))
    return listed, rows, (tmp / "cli" / "fig5_model_correct.csv").read_text()


def placement_phase(dev):
    """15. The batch axis split into chunks (`core.shard`): (a) the main
    path's FAST sweep on ``[dev] * k``, k = 1-4, every key equal to
    k = 1 and to the main path's views, launches k per window and engine
    batch, and over every card when there is more than one; (b) the
    stage-10 FULL replay of the six apps on ``[dev] * 4`` equal to one
    device, at the stage's own budget and at one that sends every row to
    the dense re-run; (c) the benchmark CLI in its own processes.
    Returns the launches by k and the kernels bench's rows."""
    import tempfile

    from repro_torch import kernels
    from repro_torch.bench import app_validation as av
    from repro_torch.bench import fig5_model_correct, registry
    from repro_torch.core import get_stage, mess
    from repro_torch.traces import make_suite, replay_suite, stack_traces, to

    cfg = get_stage("07-prefetch", windows=48, warmup=16)
    grid = ([p for _ in FAST_MIXES for p in FAST_PACES],
            [wr for wr in FAST_MIXES for _ in FAST_PACES])
    n_event = sum(mess.event_covers(cfg, p) for p in grid[0])
    batches = [n for n in (n_event, len(grid[0]) - n_event) if n]
    runs, bad = {}, []
    whole = None
    for k in PLACEMENT_SPLITS:
        out, wall, n = placement_sweep(cfg, [dev] * k, grid)
        whole = out if whole is None else whole
        want = cfg.windows * sum(min(k, b) for b in batches)
        runs[k] = {"wall_s": wall, "launches": n,
                   "expected_launches": want,
                   "differs": replay_equal(out, whole)}
        if (runs[k]["differs"] or n["window_inject"] != want
                or n["weave_window"] != want or n["decode_packed"]
                or n["frfcfs_select"]):
            bad.append((k, runs[k]))
    main_views = mess.sweep(cfg, paces=FAST_PACES, write_mixes=FAST_MIXES)
    for f, key in (("sim_bw", "sim_bw_gbs"), ("app_lat", "app_lat_ns"),
                   ("chase_lat", "chase_lat_ns")):
        if not np.array_equal(getattr(main_views, f).reshape(-1),
                              whole[key]):
            bad.append(("device=None vs one card", f))
    n_cards = torch.cuda.device_count()
    cards = [torch.device("cuda", i) for i in range(n_cards)]
    every = None
    if n_cards > 1:
        out, wall, n = placement_sweep(cfg, cards, grid)
        every = {"cards": n_cards, "wall_s": wall, "launches": n,
                 "differs": replay_equal(out, whole)}
        if every["differs"]:
            bad.append(("every card", every))
    emit({"phase": "placement", "part": "sweep", "stage": cfg.name,
          "preset": "ddr4_2666", "points": len(grid[0]),
          "engine_batches": batches, "splits": runs, "every_card": every})
    if every is None:
        emit({"phase": "placement", "part": "every_card",
              "note": "only one card was present: the sweep over every "
                      "card is the k = 1 run"})

    rcfg = get_stage(PLACEMENT_REPLAY_STAGE, windows=av.FULL["windows"],
                     warmup=av.FULL["warmup"], telemetry=True)
    batch = to(stack_traces(make_suite(n=av.FULL["n"])[1]), dev)
    replays = {}
    for budget in (None, PLACEMENT_RERUN_BUDGET):
        c = rcfg if budget is None else dataclasses.replace(
            rcfg, weave_events=budget)
        cases = [("one", [dev]), ("four", [dev] * 4)]
        if n_cards > 1:
            cases.append(("every_card", cards))
        row, outs = {}, {}
        for name, devices in cases:
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            outs[name] = replay_suite(c, batch, device=devices)
            row[name] = {"wall_s": time.perf_counter() - t0,
                         "launches": kernels.launch_counts()}
        reruns = int((outs["one"]["weave_sat"] > 0).sum())
        for name in outs:
            row[name]["differs"] = replay_equal(outs[name], outs["one"])
            if row[name]["differs"]:
                bad.append(("replay", budget, name, row[name]["differs"]))
        if budget is not None and reruns != len(outs["one"]["weave_sat"]):
            bad.append(("replay", budget, "dense re-runs", reruns))
        replays[str(budget or c.event_budget())] = dict(row,
                                                        dense_reruns=reruns)
    emit({"phase": "placement", "part": "replay", "stage": rcfg.name,
          "knobs": av.FULL, "by_event_budget": replays})

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        listed, bench_rows, fig5_cli = placement_cli(tmp)
        cli_wall = time.perf_counter() - t0
        fig5_model_correct.main(out_dir=tmp / "direct")
        fig5_direct = (tmp / "direct" / "fig5_model_correct.csv").read_text()
    names = list(registry.BENCHMARKS)
    if listed != names:
        bad.append(("--list", listed))
    mismatched = [r["name"] for r in bench_rows if "match=True" not in
                  r["derived"]]
    if mismatched or len(bench_rows) != PLACEMENT_BENCH_ROWS:
        bad.append(("kernels bench", mismatched, len(bench_rows)))
    if fig5_cli != fig5_direct:
        bad.append(("fig5 CSV through the CLI differs from a direct run",))
    emit({"phase": "placement", "part": "cli", "listed": listed,
          "kernels_bench": bench_rows, "fig5_csv_equal":
          fig5_cli == fig5_direct, "fig5_rows": len(fig5_cli.splitlines()),
          "wall_s": cli_wall})
    if bad:
        raise AssertionError(f"placement: {bad}")
    return {k: r["launches"] for k, r in runs.items()}, bench_rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import kernels
    from repro_torch.core import get_stage, mess, run_point, sweep
    from repro_torch.kernels import _build
    from repro_torch.kernels.addr_decode import (decode_packed,
                                                 decode_packed_plain)
    from repro_torch.kernels.bank_timing import frfcfs_select, select_plain
    from repro_torch.kernels.weave_window import weave_window

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    # plain versions compare in full fp32: no TF32 in products or convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. build ------------------------------------------------------
    lib = _build.build()
    log = _build.build_info["log"]
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    # the Hopper flash kernel's own report: entry, spills, registers
    sm90 = log.split("== flash_attention_sm90.cu\n")[-1].split("\n== ")[0]
    weave_log = log.split("== weave_window.cu\n")[-1].split("\n== ")[0]
    inject_log = log.split("== window_inject.cu\n")[-1].split("\n== ")[0]
    smem = _build.function("flash_attention_sm90_smem_bytes", [ctypes.c_int])

    def report(text):
        return [ln.strip() for ln in text.splitlines()
                if "entry" in ln or "spill" in ln or "registers" in ln] \
            if log else "not rebuilt in this run"

    emit({"phase": "build", "library": str(lib.relative_to(ROOT)),
          "built": _build.build_info["built"],
          "seconds": _build.build_info["seconds"], "ptxas": regs,
          "flash_sm90_ptxas": report(sm90),
          "weave_window_ptxas": report(weave_log),
          "window_inject_ptxas": report(inject_log),
          "flash_sm90_smem_bytes": {d: smem(d) for d in (64, 80, 128)}})

    # ---- 2. kernels vs their plain versions ----------------------------
    cfg = get_stage("07-prefetch", windows=48, warmup=16)
    mess._ensure_calibration()
    n_dense = len(FAST_MIXES) * sum(not mess.event_covers(cfg, p)
                                    for p in FAST_PACES)
    max_err = {"frfcfs_select": 0, "decode_packed": 0}
    mismatches = {"frfcfs_select": 0, "decode_packed": 0}
    checked = {"frfcfs_select": 0, "decode_packed": 0}
    for C in (6, 12, 16):
        for Q in (256, 512):
            for cap in (0, 4):
                planes, scal = select_inputs(rng, n_dense * C, Q, dev,
                                             idle_rows=C)
                got = frfcfs_select(*planes, scal, row_hit_cap=cap)
                want = select_plain(*planes, scal, row_hit_cap=cap)
                for g, w in zip(got, want):
                    diff = (g.long() - w.long()).abs()
                    max_err["frfcfs_select"] = max(
                        max_err["frfcfs_select"], int(diff.max()))
                    mismatches["frfcfs_select"] += int((diff != 0).sum())
                checked["frfcfs_select"] += n_dense * C
    n_main = n_dense * cfg.workload_config().n_cores * 80
    # the trace route's decode: six apps x 24 cores x 80 candidates
    n_replay = 6 * cfg.workload_config().n_cores * 80
    for n in (1, 100, 4097, n_replay, n_main, 1 << 20):
        lines = chase_lines(rng, n, dev)
        diff = (decode_packed(lines).long()
                - decode_packed_plain(lines).long()).abs()
        max_err["decode_packed"] = max(max_err["decode_packed"],
                                       int(diff.max()))
        mismatches["decode_packed"] += int((diff != 0).sum())
        checked["decode_packed"] += n
    torch.cuda.synchronize()

    # timing: frfcfs_select at the main path's dense batch (B points x 6
    # channels x 256), decode_packed at the trace route's window batch
    rows, Q = n_dense * cfg.platform.dram.n_channels, 256
    planes, scal = select_inputs(rng, rows, Q, dev)

    def decode_kernel(n):
        """The kernel's C entry point on ``n`` prepared lines."""
        return decode_launch(chase_lines(rng, n, dev))

    lines = chase_lines(rng, n_replay, dev)

    # ms: device time per launch; call_ms: one wrapper call in the eager
    # loop; plain_ms: the plain version on the same card and inputs
    timing = {
        "frfcfs_select": dict(
            ms=device_ms(lambda: frfcfs_select(*planes, scal), 200),
            call_ms=time_ms(lambda: frfcfs_select(*planes, scal), 500),
            plain_ms=time_ms(lambda: select_plain(*planes, scal), 50),
            bytes=rows * (11 * Q * 4 + 8 * 4) + rows * 2 * 4,
            shape=f"{rows}x{Q}"),
        "decode_packed": dict(
            ms=device_ms(decode_kernel(n_replay), 200),
            call_ms=time_ms(lambda: decode_packed(lines), 500),
            plain_ms=time_ms(lambda: decode_packed_plain(lines), 50),
            bytes=n_replay * 4 * 2, shape=f"{n_replay}",
            ms_at_sweep_batch=device_ms(decode_kernel(n_main), 200),
            sweep_batch_shape=f"{n_main}"),
    }
    emit({"phase": "kernels", "checked": checked, "mismatches": mismatches,
          "max_abs_err": max_err, "timing": timing})
    if any(mismatches.values()):
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{mismatches}")
    max_err["flash_attention"], timing["flash_attention"] = check_flash(dev)

    # ---- 3. the interface routes against each other ----------------------
    max_err["window_inject"], decode_launches = inject_phase(dev)
    max_err["window_inject_trace"], trace_decode_launches = \
        trace_inject_phase(dev)

    # ---- 4. the weave routes against each other --------------------------
    max_err["weave_window"], select_launches = weave_phase(dev)

    # ---- 5. the main path -----------------------------------------------
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = sweep(cfg, paces=FAST_PACES, write_mixes=FAST_MIXES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    weave_steps = weave_window.steps
    per_mix = []
    for i, wr in enumerate(res.write_mixes):
        per_mix.append({"wr_num": wr, **{
            f"{v}_peak_bw_gbs": float(np.max(res.view(v)[0][i]))
            for v in ("app", "if", "sim")}, **{
            f"{v}_unloaded_lat_ns": float(res.view(v)[1][i, 0])
            for v in ("app", "if", "sim")}})
    emit({"phase": "main_path", "stage": cfg.name, "preset": "ddr4_2666",
          "paces": list(FAST_PACES), "write_mixes": list(FAST_MIXES),
          "windows": cfg.windows, "warmup": cfg.warmup, "wall_s": wall,
          "weave_steps": weave_steps, "launches": launches,
          "per_mix": per_mix,
          "views": {f: getattr(res, f).tolist() for f in (
              "sim_bw", "sim_lat", "if_bw", "if_lat", "app_bw", "app_lat",
              "chase_lat")}})
    if (launches["weave_window"] != MAIN_WEAVE_LAUNCHES
            or launches["window_inject"] != MAIN_INJECT_LAUNCHES
            or launches["frfcfs_select"] != 0
            or launches["decode_packed"] != 0
            or weave_steps != MAIN_WEAVE_STEPS):
        raise AssertionError(
            f"main path: weave_window x {launches['weave_window']} "
            f"(expected {MAIN_WEAVE_LAUNCHES}), window_inject x "
            f"{launches['window_inject']} (expected "
            f"{MAIN_INJECT_LAUNCHES}), frfcfs_select x "
            f"{launches['frfcfs_select']} and decode_packed x "
            f"{launches['decode_packed']} (expected 0), {weave_steps} "
            f"weave steps (expected {MAIN_WEAVE_STEPS})")
    peak = cfg.platform.dram.peak_gbs
    for f in ("sim_bw", "sim_lat", "if_bw", "if_lat", "app_bw", "app_lat",
              "chase_lat"):
        arr = getattr(res, f)
        if arr.shape != (len(FAST_MIXES), len(FAST_PACES)):
            raise AssertionError(f"{f} has shape {arr.shape}")
        if not np.isfinite(arr).all() or (arr <= 0).any():
            raise AssertionError(f"{f} is not finite and positive: {arr}")
    if (res.sim_bw > peak).any():
        raise AssertionError(f"simulated bandwidth above the device peak "
                             f"{peak} GB/s: {res.sim_bw}")

    # the weave phase's device time (one more sweep, profiled) and the
    # kernel at the main path's two batches
    prof = profile_sweep(cfg, wall)
    timing["weave_window"] = weave_timing(dev)
    timing["window_inject"] = inject_timing(dev)
    timing["window_inject_trace"] = trace_inject_timing(dev)
    weave_dev_s = prof.get("weave_device_s")
    idle_share = prof.get("idle_share_of_unprofiled_wall")
    emit({"phase": "main_path_weave", "wall_s": wall,
          "weave_launches": launches["weave_window"],
          "weave_steps": weave_steps,
          "steps_per_launch": weave_steps / launches["weave_window"],
          "weave_device_s": weave_dev_s,
          "weave_device_s_from_timing": cfg.windows * sum(
              t["ms"] for t in timing["weave_window"].values()) / 1e3,
          "us_per_step": (weave_dev_s * 1e6 / weave_steps
                          if weave_dev_s else None),
          "inject_launches": launches["window_inject"],
          "inject_device_s": prof.get("inject_device_s"),
          "inject_device_s_from_timing": cfg.windows * sum(
              t["ms"] for t in timing["window_inject"].values()) / 1e3,
          "host_ms_per_window_batch": wall * 1e3 / MAIN_INJECT_LAUNCHES,
          "idle_share_of_wall": idle_share})

    # ---- 6. parity: the card against the CPU through the same port -----
    small = get_stage("07-prefetch", windows=8, warmup=2)
    on_card = run_point(small, [4, 48], 16)
    on_cpu = run_point(small, [4, 48], 16, device="cpu")
    worst = 0.0
    for k, ref in on_cpu.items():
        got = on_card[k].cpu()
        if got.is_floating_point():
            rel = ((got - ref).abs() / ref.abs().clamp(min=1e-30)).max()
            worst = max(worst, float(rel))
        elif not torch.equal(got, ref):
            raise AssertionError(f"{k}: card {got.tolist()} != "
                                 f"cpu {ref.tolist()}")
    emit({"phase": "parity", "stage": small.name, "windows": small.windows,
          "paces": [4, 48], "ints_equal": True, "max_rel_err": worst})
    if not worst <= RTOL:
        raise AssertionError(f"float views differ by {worst} > {RTOL}")

    # ---- the recording instances against the stepwise route (after the
    # main path, whose host timing it would otherwise perturb) -----------
    max_err["weave_window_recording"] = telemetry_phase(dev)

    # ---- 7. the application perspective on the trace route --------------
    replay_rel = replay_parity(dev)
    ladder_launches, replay_prof = ladder(dev)

    # ---- 8-9. the simulator perspective's recorders ----------------------
    persp_launches, persp_wall = perspectives_phase(dev)
    oracle_launches = cmd_oracle_phase(dev)
    persp_cfg, persp_state = perspectives_state(dev)
    timing["weave_window_recording"] = record_timing(dev, persp_cfg,
                                                     persp_state)

    # ---- 10-11. the dense LM serving path, and its card-vs-CPU parity ----
    flash_routes = lm_path(dev)
    launches["flash_attention"] = sum(flash_routes.values())
    lm_parity(dev)

    # ---- 11b. the five other families on the serving path ----------------
    family_launches, family_flash_rows = lm_families(dev)

    # ---- 11c. the training path ------------------------------------------
    train_launches = train_phase(dev)

    # ---- 12-14. LLM-serving traffic, the paper's figures, the weave bench
    serve = serving_phase(dev)
    figs = figures_phase(dev)
    wbench = weave_bench_phase(dev)

    # ---- 15. the batch axis in chunks, and the benchmark CLI --------------
    placement_launches, bench_rows = placement_phase(dev)

    # ---- the kernel table, the card, the result ---------------------------
    # launches: weave_window / window_inject from the main path's sweep
    # (weave_window's ladder launches beside them), window_inject_trace
    # and decode_packed from the replay ladder (the trace route's path; 0
    # decode_packed there since the trace instance), frfcfs_select from
    # the weave phase's stepwise route (0 on the main path),
    # flash_attention from the LM path's forward (its row carries the
    # route the forward takes, sm90_bf16, and both routes under
    # "routes"), its D 80 instance from zamba2's bf16 forward
    launches["frfcfs_select"] = select_launches
    launches["decode_packed"] = ladder_launches["decode_packed"]
    launches["window_inject_trace"] = ladder_launches["window_inject_trace"]
    launches["flash_attention_d80"] = family_launches["forward_by_arch"][
        "zamba2-2.7b"]["sm90_bf16"]
    # the recording instances' path: the perspectives SMOKE ladder
    launches["weave_window_recording"] = persp_launches[
        "weave_window_recording"]
    flash_src = {"sm90_bf16": "src/repro_torch/csrc/flash_attention_sm90.cu",
                 "cuda_core": "src/repro_torch/csrc/flash_attention.cu"}
    weave_t = timing["weave_window"]
    timing["weave_window"] = dict(
        weave_t["dense"], ms_event=weave_t["event"]["ms"],
        us_per_step_event=weave_t["event"]["us_per_step"],
        call_ms_event=weave_t["event"]["call_ms"],
        plain_ms_event=weave_t["event"]["plain_ms"],
        bound_ms_event=weave_t["event"]["bound_ms"],
        shape_event=weave_t["event"]["shape"])
    rec_t = timing["weave_window_recording"]
    timing["weave_window_recording"] = dict(
        rec_t["dense"], ms_event=rec_t["event"]["ms"],
        call_ms_event=rec_t["event"]["call_ms"],
        bound_ms_event=rec_t["event"]["bound_ms"],
        ms_perspectives=rec_t["perspectives"]["ms"],
        bound_ms_perspectives=rec_t["perspectives"]["bound_ms"],
        instance_ms={e: {n: rec_t[e][n]["ms"] for n in rec_t[e]
                         if isinstance(rec_t[e][n], dict)}
                     for e in ("dense", "event", "perspectives")},
        shape=f"{rec_t['dense']['rows']} rows x {rec_t['dense']['steps']} "
              f"dense steps, telemetry + command record",
        shape_event=f"{rec_t['event']['rows']} rows x "
                    f"{rec_t['event']['steps']} event steps",
        shape_perspectives=f"{rec_t['perspectives']['rows']} rows x "
                           f"{rec_t['perspectives']['steps']} event steps "
                           f"({rec_t['perspectives']['stage']}, window "
                           f"{rec_t['perspectives']['window']})")
    flash_d80 = timing["flash_attention"].pop("sm90_bf16_d80")
    timing["flash_attention_d80"] = flash_d80
    max_err["flash_attention_d80"] = max_err["flash_attention"].pop(
        "sm90_bf16_d80/bfloat16")
    inject_t = timing["window_inject"]
    timing["window_inject"] = dict(
        inject_t["dense"], ms_event=inject_t["event"]["ms"],
        call_ms_event=inject_t["event"]["call_ms"],
        plain_ms_event=inject_t["event"]["plain_ms"],
        bound_ms_event=inject_t["event"]["bound_ms"],
        window_step_ms_event=inject_t["event"]["window_step_ms"],
        shape_event=inject_t["event"]["shape"])
    sources = {"weave_window": (
                   "src/repro_torch/csrc/weave_window.cu",
                   "src/repro/kernels/bank_timing/kernel.py:97 + the weave "
                   "scans src/repro/core/platform.py:198-239"),
               "weave_window_recording": (
                   "src/repro_torch/csrc/weave_window.cu",
                   "src/repro/kernels/bank_timing/kernel.py:97 + the weave "
                   "scans src/repro/core/platform.py:159-305 + the "
                   "recorders src/repro/core/dram.py:574-642"),
               "window_inject": (
                   "src/repro_torch/csrc/window_inject.cu",
                   "src/repro/kernels/addr_decode/kernel.py:57 + "
                   "workload.generate / inject_queue / MessFrontend.update "
                   "src/repro/core/workload.py:210-395"),
               "window_inject_trace": (
                   "src/repro_torch/csrc/window_inject.cu",
                   "src/repro/kernels/addr_decode/kernel.py:57 + "
                   "TraceFrontend.bound / update "
                   "src/repro/traces/frontend.py:124-228 + chase_probe / "
                   "inject_queue src/repro/core/workload.py:184-352"),
               "frfcfs_select": ("src/repro_torch/csrc/bank_timing.cu",
                                 "src/repro/kernels/bank_timing/kernel.py:97"),
               "decode_packed": ("src/repro_torch/csrc/addr_decode.cu",
                                 "src/repro/kernels/addr_decode/kernel.py:57"),
               "flash_attention": (
                   flash_src["sm90_bf16"],
                   "src/repro/kernels/flash_attention/kernel.py:89"),
               "flash_attention_d80": (
                   flash_src["sm90_bf16"],
                   "src/repro/kernels/flash_attention/kernel.py:89")}
    flash_timing, flash_err = timing["flash_attention"], max_err[
        "flash_attention"]
    timing["flash_attention"] = flash_timing["sm90_bf16"]
    max_err["flash_attention"] = flash_err["sm90_bf16/bfloat16"]
    table = []
    # the kernels bench's rows (device µs per launch, in the CLI's run)
    bench_us = {r["name"].split(".")[-1]: r["device_us"] for r in bench_rows}
    bench_us["flash_attention"] = bench_us.pop("sm90_bf16")
    for name, (src, replaces) in sources.items():
        t = timing[name]
        by_flops = "flops" in t
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": replaces, "launches": launches[name],
                      "train_step_launches": train_launches.get(
                          name.replace("_d80", ""), 0),
                      "max_abs_err": max_err[name], "ms": t["ms"],
                      "plain_ms": t["plain_ms"], "call_ms": t["call_ms"],
                      "bound_ms": t["bound_ms"] if by_flops
                      else t["bytes"] / MEM_BYTES_PER_S * 1e3,
                      "bound_by": "operations" if by_flops else "bytes",
                      "library_ms": t.get("library_ms"),
                      "shape": t["shape"]})
        if name in bench_us:
            table[-1]["kernels_bench_device_us"] = bench_us[name]
        if name in ("weave_window", "window_inject"):
            table[-1]["placement_sweep_launches"] = {
                k: n[name] for k, n in placement_launches.items()}
        if name == "weave_window":
            table[-1].update({k: t[k] for k in (
                "us_per_step", "ms_event", "us_per_step_event",
                "call_ms_event", "plain_ms_event", "bound_ms_event",
                "shape_event")},
                replay_launches=ladder_launches["weave_window"],
                serving_golden_launches=serve["golden"][
                    "weave_window.plain"],
                figures_full_launches=figs["weave_window"],
                weave_bench_launches=wbench["weave_window"])
        if name == "weave_window_recording":
            table[-1].update(
                {k: t[k] for k in ("ms_event", "call_ms_event",
                                   "bound_ms_event", "ms_perspectives",
                                   "bound_ms_perspectives", "shape_event",
                                   "shape_perspectives", "instance_ms")},
                path="perspectives SMOKE ladder (telemetry instance)",
                plain_instance_ms=timing["weave_window"]["ms"],
                plain_instance_ms_event=timing["weave_window"]["ms_event"],
                cmd_oracle_launches=oracle_launches[
                    "weave_window_recording"],
                ladder_launches=ladder_launches["weave_window_recording"],
                perspectives_smoke_wall_s=persp_wall,
                serving_smoke_launches=serve["smoke"][
                    "weave_window_recording"],
                serving_full_launches=serve["full"][
                    "weave_window_recording"],
                serving_full_wall_s=serve["full_wall_s"])
        if name == "window_inject":
            table[-1].update({k: t[k] for k in (
                "ms_event", "call_ms_event", "plain_ms_event",
                "bound_ms_event", "window_step_ms", "window_step_ms_event",
                "shape_event")}, idle_share_of_sweep=idle_share,
                figures_full_launches=figs["window_inject"],
                figures_full_wall_s=figs["wall_s"],
                weave_bench_launches=wbench["window_inject"])
        if name == "frfcfs_select":
            table[-1].update(path="weave phase, stepwise route",
                             main_path_launches=0)
        if name == "window_inject_trace":
            table[-1].update(
                {k: t[k] for k in ("window_step_ms", "trace_entries_read")},
                path="replay ladder (trace route)",
                replay_profile_device_s=replay_prof.get("inject_device_s"),
                replay_profile_launches=replay_prof.get("inject_launches"),
                replay_card_vs_cpu_max_rel_err=replay_rel,
                inject_phase_launches=2 * len(TRACE_INJECT_CASES)
                * INJECT_WINDOWS,
                perspectives_smoke_launches=persp_launches[
                    "window_inject_trace"],
                serving_smoke_launches=serve["smoke"]["window_inject_trace"],
                serving_full_launches=serve["full"]["window_inject_trace"],
                serving_profile_device_s=serve["profile"].get(
                    "inject_device_s"))
        if name == "decode_packed":
            table[-1].update(
                path="none (the eager route, the plain version of "
                     "window_inject, on card tensors)", sweep_launches=0,
                inject_phase_launches=decode_launches,
                trace_inject_phase_launches=trace_decode_launches,
                ms_at_sweep_batch=t["ms_at_sweep_batch"],
                sweep_batch_shape=t["sweep_batch_shape"],
                perspectives_smoke_launches=persp_launches["decode_packed"],
                serving_full_launches=serve["full"]["decode_packed"])
        if name == "flash_attention":
            table[-1]["lm_families_launches"] = family_launches
            table[-1]["family_shapes"] = family_flash_rows
            table[-1]["routes"] = [
                {"route": r, "source": flash_src[r],
                 "launches": flash_routes[r],
                 "max_abs_err": {k: e for k, e in flash_err.items()
                                 if k.startswith(r)}, "ms": t["ms"],
                 "call_ms": t["call_ms"], "plain_ms": t["plain_ms"],
                 "bound_ms": t["bound_ms"], "bound_by": "operations",
                 "library_ms": t["library_ms"], "shape": t["shape"],
                 **({"cuda_core_same_inputs_ms":
                     t["cuda_core_same_inputs_ms"]}
                    if "cuda_core_same_inputs_ms" in t else {})}
                for r, t in flash_timing.items()]
        if name == "flash_attention_d80":
            table[-1].update(
                path="zamba2-2.7b bf16 forward (its shared block)",
                flash_route="sm90_bf16",
                cuda_core_same_inputs_ms=t["cuda_core_same_inputs_ms"],
                zamba2_forward_routes=family_launches["forward_by_arch"][
                    "zamba2-2.7b"])
    emit({"kernels": table})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
