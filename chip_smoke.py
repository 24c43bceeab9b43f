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
   window batch (and at the sweep's); ``flash_attention`` at the shapes of ``tests/test_kernels.py``
   plus a decode (Sq = 1) and a ragged query tile at D = 128 and 64, in
   fp32 (within 2e-6) and bf16 (within 2e-2), each check on the route
   that ``route`` gives it (bf16 at D 64 or 128: the Hopper kernel; the
   rest: the CUDA-core kernel), at a causal shape with Sq > Sk (rows that
   see no key must be exactly 0) and at the LM path's shape, where both
   routes are timed beside ``scaled_dot_product_attention`` as a
   yardstick (the Hopper route in bf16, the CUDA-core route in fp32 and
   on the same bf16 inputs).
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
   two sockets).
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
   routes on the same state (``weave_timing``, ``inject_timing``), and a
   ``main_path_weave`` line: the sweep's wall, the weave phase's device
   time, µs per step.
6. **parity** — one stage-07 ``run_point`` on the card (the fused
   route) and on the CPU (the stepwise route) through the same port:
   equal integers, float views within 1e-6.
7. **replay** — the application perspective on the trace route (the
   eager bound phase and injection on card tensors, whose Skylake decode
   is one ``decode_packed`` launch, and one ``weave_window`` launch per
   window batch): the six apps (``n=2048``, 4 windows) at stages 01, 07
   and 10 and the three mixes of ``app_validation.MIXES`` on two sockets
   at stage 10, card against CPU (counts, cursors and runtimes equal,
   float views within 1e-6); then the validation ladder at its full
   setting (``app_validation.run_preset("ddr4_2666", full=True)``: 6
   apps x 8192 accesses, 96 windows, five stages) with each stage's
   wall, host ms per window batch, runtimes, MAPE, dense re-runs and
   launches (``weave_window`` >= 96 and ``window_inject`` 0 at every
   stage, ``decode_packed`` >= 96 at 07 and 10 and 0 at 01, 03, 04),
   the multiprogrammed ladder (``run_mixes``, FAST), and stage 10 once
   more under ``torch.profiler`` (device time by kernel, idle share).
   The ladder runs with telemetry, as the reference's does (the
   telemetry instance of ``weave_window``, the ``if_p50/95/99`` per app).
   The ladder's launches give ``decode_packed``'s row.
8. **perspectives** — the port's ``bench.perspectives`` ladder (stages
   01-10, one STREAM + GUPS mix, telemetry on) at ``SMOKE`` on the card,
   every ladder value held within 1e-9 of the reference's
   ``reports/benchmarks/perspectives.json`` (read, never written) and its
   summaries equal; 240 telemetry launches, and no other weave instance;
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
   windows): wall per preset and per cell, 12 telemetry launches a
   preset, ``decode_packed`` x 12 on ddr4_2666 and 0 elsewhere; (d) the
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

Then the kernel table (``{"kernels": [...]}``), the card's name and
power limit as nvidia-smi reports them, and the result line.  Any
failure raises: the script then exits non-zero and prints no result.
Without a card, or without the repository beside it, it exits non-zero.
"""
import ctypes
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

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
# stages of the ladder whose decode is Skylake XOR on ddr4_2666
LADDER_XOR_STAGES = ("07-prefetch", "10-delay-buffer")
LADDER_PROFILED_STAGE = "10-delay-buffer"


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters):
    """Mean ms per call over ``iters`` eager calls, by CUDA events, warmed
    up: what a call costs the eager loop, host launch included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, iters):
    """Mean device ms per launch: ``iters`` launches captured in one CUDA
    graph and replayed, by CUDA events, so host launch cost drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                               # warm up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (5 * iters)


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
    version, bound and the library's fused attention."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     mha_plain, route)

    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(s, dt) for s in FLASH_SHAPES + [FLASH_EMPTY_ROWS]
             for dt in (torch.float32, torch.bfloat16)]
    cases.append((FLASH_SLICE, torch.bfloat16))
    checked, failed = [], []
    worst = {}                              # per route and dtype
    for shape, dt in cases:
        q, k, v = flash_inputs(gen, shape, dt, dev,
                               model_layout=shape == FLASH_SLICE)
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
        for r in took:
            key = f"{r}/{str(dt)[6:]}"
            worst[key] = max(worst.get(key, 0.0), err)
        if not ok:
            failed.append(checked[-1])

    b, hq, _, s, _, d, _ = FLASH_SLICE
    flops = 4 * b * hq * s * s * d / 2      # QK^T and PV, causal half
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timing = {}
    for name, dt, peak in (("sm90_bf16", torch.bfloat16, BF16_FLOP_PER_S),
                           ("cuda_core", torch.float32, FP32_FLOP_PER_S)):
        q, k, v = flash_inputs(gen, FLASH_SLICE, dt, dev, True)
        qc, kc, vc = (x.contiguous() for x in (q, k, v))
        io_bytes = sum(x.numel() * x.element_size() for x in (q, k, v, q))
        timing[name] = dict(
            ms=device_ms(lambda: flash_attention(q, k, v, causal=True), 20),
            call_ms=time_ms(lambda: flash_attention(q, k, v, causal=True),
                            20),
            plain_ms=time_ms(lambda: mha_plain(q, k, v, causal=True), 3),
            library_ms=device_ms(lambda: sdpa(qc, kc, vc, is_causal=True,
                                              enable_gqa=True), 20),
            flops=flops, bound_formula=f"4*B*Hq*S^2*D/2 FLOP / {peak:.3g} "
                                       f"FLOP/s",
            bound_ms=flops / peak * 1e3,
            bytes_bound_ms=io_bytes / MEM_BYTES_PER_S * 1e3,
            shape=f"B=2 Hq=32 Hkv=4 S=2048 D=64 {str(dt)[6:]} causal")
        if name == "sm90_bf16":
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


def profile_forward(api, params, toks, forward_wall_s):
    """One warm forward under torch.profiler: device time by kernel name
    and by kind, and the device's idle share, over the profiled forward
    and over ``forward_wall_s``, the same forward's wall-clock without
    the profiler (whose own host cost varies between machines)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        api.forward(params, {"tokens": toks})
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {"phase": "profile", "what": f"one warm {LM_ARCH} forward, "
           f"{LM_B} x {LM_S} tokens, bf16", "wall_ms_profiled":
           wall_us / 1e3, "device_events": len(dev_events)}
    if not dev_events:
        out["note"] = "the profiler showed no device time on this machine"
        emit(out)
        return
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


def record_timing(cfg, dev, persp_cfg, persp_state, w=8):
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
            cfg_e, clock, kw, queue, banks = weave_batch(cfg, dev, engine, w)
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
            or launches["window_inject"] or launches["frfcfs_select"]):
        raise AssertionError(f"perspectives launches {launches}: expected "
                             f"{n_batches} telemetry weave_window")

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
    for r in full["ladder"]:
        if not all(np.isfinite(r[k]) for k in ("rho_sim_app",
                                                "sim_lat_ns_mean")):
            raise AssertionError(f"perspectives FULL: {r}")
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


def main_batch(cfg, dev, engine, w):
    """The main path's batch of one engine (its points, as the knee
    routing gives them) at the start of window ``w``: ``(cfg, clock,
    wcfg, frontend, carry)``."""
    from repro_torch.core import mess, platform, workload

    pts = [(p, wr) for wr in FAST_MIXES for p in FAST_PACES
           if mess.event_covers(cfg, p) == (engine == "event")]
    cfg = dataclasses.replace(cfg, weave=engine)
    paces = torch.tensor([p for p, _ in pts], dtype=torch.int32, device=dev)
    wrs = torch.tensor([wr for _, wr in pts], dtype=torch.int32, device=dev)
    frontend = workload.MessFrontend(paces, wrs, cfg.workload_config())
    carry = platform._init_carry(cfg, frontend, len(pts), dev)
    clock, wcfg = cfg.clock(), cfg.workload_config()
    for i in range(w):
        carry, _ = platform._window_step(cfg, clock, wcfg, frontend, carry,
                                         i)
    return cfg, clock, wcfg, frontend, carry


def weave_batch(cfg, dev, engine, w):
    """The main path's batch of one engine after window ``w``'s bound
    phase and injection."""
    from repro_torch.core import platform

    cfg, clock, wcfg, frontend, carry = main_batch(cfg, dev, engine, w)
    queue = platform._bound_inject(cfg, clock, wcfg, frontend, carry, w)[0]
    return cfg, clock, platform._tick_kw(cfg, clock, dev), queue, carry[1]


def inject_timing(cfg, dev, w=8):
    """`window_inject` at the main path's two batches (window ``w`` of the
    FAST sweep): the kernel's device time (its C entry point on prepared
    arguments, in a CUDA graph), one call of the card's route
    (`_bound_inject_fused`, checks and allocation included), the eager
    route on the same state (its plain version), one whole
    `_window_step` on the card's routes, their agreement, and the bytes
    bound (every input read once, every output written once)."""
    from repro_torch.core import addrmap, platform
    from repro_torch.kernels.window_inject import ops as iops

    out = {}
    with torch.inference_mode():
        for engine in ("dense", "event"):
            cfg_e, clock, wcfg, frontend, carry = main_batch(cfg, dev,
                                                             engine, w)
            args = (cfg_e, clock, wcfg, frontend, carry, w)
            want = platform._bound_inject_eager(*args)
            got = platform._bound_inject_fused(*args)
            diff, same = max_diff(got, want)
            queue, _, fstate, l_ir, lat_est = carry[:5]
            cpu = cfg_e.platform.cpu
            c_args, res = iops.prepare(
                queue, fstate, frontend.pace, frontend.wr_num, l_ir,
                lat_est, w=w, wcfg=wcfg, clock=clock,
                mapping=addrmap.decode_route(wcfg.mapping, wcfg.dram),
                window_cycles=cpu.window_cycles,
                window_ps=cpu.window_cycles * cpu.cpu_ps_per_clk)
            ms = device_ms(lambda: iops.launch(
                c_args, torch.cuda.current_stream().cuda_stream), 20)
            io_bytes = sum(x.numel() * x.element_size()
                           for x in list(res["inputs"])
                           + [res["queue"], res["core"], res["point"]])
            B, C, Q = queue.valid.shape
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


def weave_timing(cfg, dev, w=8):
    """`weave_window` at the main path's two batches (window ``w`` of the
    FAST sweep): the kernel's device time (its C entry point on packed
    inputs, in a CUDA graph), one wrapper call (`_weave_fused`, packing
    included), the stepwise route on the same state (its plain version,
    ~170 eager ops + one `frfcfs_select` per step), their agreement, and
    the bytes bound (state in and out once)."""
    from repro_torch.core import platform
    from repro_torch.kernels import _build
    from repro_torch.kernels.weave_window import ops as wops

    out = {}
    with torch.inference_mode():
        for engine in ("dense", "event"):
            cfg_e, clock, kw, queue, banks = weave_batch(cfg, dev, engine, w)
            args = (cfg_e, clock, kw, queue, banks, w)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = platform._weave_stepwise(*args)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            got = platform._weave_fused(*args)
            diff, same = max_diff(got, want)

            B, C, Q = queue.valid.shape
            d = cfg_e.platform.dram
            start, end = clock.window_start_tick(w), clock.window_end_tick(w)
            n_steps = (cfg_e.event_budget() if engine == "event"
                       else clock.ticks_per_window_static)
            inp, res = wops.pack_inputs(queue, banks)
            params = wops.pack_params(d, cfg_e.policy, **{
                k: kw[k] for k in ("tick2cpu_num", "tick2cpu_den",
                                   "cpu_ps_per_clk")})
            c_params = (ctypes.c_int * len(params))(*params)
            fn = _build.function("weave_window_launch", wops._ARGTYPES)
            ptrs = [x.data_ptr() for x in inp.values()] + [
                x.data_ptr() for x in res.values()]

            def launch():
                err = fn(*ptrs, ctypes.addressof(c_params), len(params),
                         B * C, Q, d.banks_per_channel, d.ranks_per_channel,
                         start, end, start + clock.ticks_per_window_static,
                         n_steps, int(engine == "event"),
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"weave_window launch: error {err}")

            ms = device_ms(launch, 5)
            io_bytes = sum(x.numel() * x.element_size()
                           for x in list(inp.values()) + list(res.values()))
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
    """The trace route on the card against the CPU's eager route: the six
    apps at three stages, then the three mixes on two sockets."""
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
        xor = cfg.mapping == "skylake_xor"
        if (launches["weave_window"] != batches
                or launches["window_inject"] != 0
                or launches["decode_packed"] != (batches if xor else 0)):
            raise AssertionError(f"replay {stage}: launches {launches}, "
                                 f"expected {batches} weave_window, "
                                 f"{batches if xor else 0} decode_packed, "
                                 f"0 window_inject")
    emit({"phase": "replay", "part": "card_vs_cpu", "apps": list(names),
          "n": REPLAY_N, **knobs, "cases": rows, "max_rel_err": worst,
          "rtol": RTOL})
    if not worst <= RTOL:
        raise AssertionError(f"replay float views differ by {worst} > "
                             f"{RTOL}")
    return worst


def profile_replay(cfg, batch, unprofiled_wall_s):
    """One stage of the ladder once more under torch.profiler (the weave
    kernel and the trace route's decode)."""
    from repro_torch.traces import replay_suite

    return profile_run(
        {"phase": "replay", "part": "profile", "stage": cfg.name},
        lambda: replay_suite(cfg, batch), unprofiled_wall_s,
        {"weave": "weave_window", "decode": "decode_packed"})


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
        xor = stage in LADDER_XOR_STAGES
        if (n["weave_window"] < av.FULL["windows"] or n["window_inject"]
                or (n["decode_packed"] < av.FULL["windows"] if xor
                    else n["decode_packed"])):
            bad.append((stage, n))
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
          "wall_s": wall, "stages": stages, "launches": launches})
    if bad:
        raise AssertionError(f"ladder: launches or results out of rule: "
                             f"{bad} (expected weave_window >= 96, "
                             f"window_inject 0, decode_packed >= 96 at "
                             f"{LADDER_XOR_STAGES} and 0 elsewhere)")

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

        profile_forward(api, params, toks, wall)

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

    def to(tree, where):
        return {k: to(v, where) if isinstance(v, dict) else v.to(where)
                for k, v in tree.items()}

    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 256)))
    with torch.inference_mode():
        want = api.forward(on_cpu, {"tokens": toks})
        kernels.reset_launch_counts()
        got = api.forward(to(on_cpu, dev), {"tokens": toks.to(dev)}).cpu()
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
# few windows: the telemetry instance and decode_packed at the FULL shapes
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
    """Each preset's replay: one telemetry `weave_window` launch per window
    (no dense re-run), `decode_packed` once a window on ddr4_2666 (the
    trace route's Skylake decode) and never elsewhere, no `window_inject`."""
    for c in cells:
        n = c["launches"]
        xor = c["preset"] == "ddr4_2666"
        if (n["weave_window.telemetry"] != windows
                or n["weave_window"] != windows
                or n["decode_packed"] != (windows if xor else 0)
                or n["window_inject"] or n["frfcfs_select"]):
            raise AssertionError(f"serving {c['preset']}: launches {n}, "
                                 f"expected {windows} telemetry weave_window"
                                 f" and {windows if xor else 0} "
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
                       {"weave": "weave_window", "decode": "decode_packed"})
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import kernels
    from repro_torch.core import get_stage, mess, run_point, sweep
    from repro_torch.kernels import _build
    from repro_torch.kernels.addr_decode import (decode_packed,
                                                 decode_packed_plain)
    from repro_torch.kernels.addr_decode import ops as decode_ops
    from repro_torch.kernels.addr_decode.ref import to_int32_bits
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
          "flash_sm90_smem_bytes": {d: smem(d) for d in (64, 128)}})

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
    launch = _build.function("decode_packed_launch", decode_ops._ARGTYPES)

    def decode_kernel(n):
        """The kernel's C entry point on ``n`` prepared lines."""
        bits = to_int32_bits(chase_lines(rng, n, dev)
                             & 0xFFFFFFFF).contiguous()
        out = torch.empty_like(bits)

        def run():
            err = launch(bits.data_ptr(), out.data_ptr(), n,
                         torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"decode_packed launch: CUDA error {err}")
        return run

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
    timing["weave_window"] = weave_timing(cfg, dev)
    timing["window_inject"] = inject_timing(cfg, dev)
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
    timing["weave_window_recording"] = record_timing(cfg, dev, persp_cfg,
                                                     persp_state)

    # ---- 10-11. the dense LM serving path, and its card-vs-CPU parity ----
    flash_routes = lm_path(dev)
    launches["flash_attention"] = sum(flash_routes.values())
    lm_parity(dev)

    # ---- 12-14. LLM-serving traffic, the paper's figures, the weave bench
    serve = serving_phase(dev)
    figs = figures_phase(dev)
    wbench = weave_bench_phase(dev)

    # ---- the kernel table, the card, the result ---------------------------
    # launches: weave_window / window_inject from the main path's sweep
    # (weave_window's ladder launches beside them), frfcfs_select from the
    # weave phase's stepwise route (0 on the main path), decode_packed from
    # the replay ladder's trace route (its path since the Mess sweep takes
    # window_inject), flash_attention from the LM path's forward; its row
    # carries the route the forward takes (sm90_bf16), and both routes
    # under "routes"
    launches["frfcfs_select"] = select_launches
    launches["decode_packed"] = ladder_launches["decode_packed"]
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
               "frfcfs_select": ("src/repro_torch/csrc/bank_timing.cu",
                                 "src/repro/kernels/bank_timing/kernel.py:97"),
               "decode_packed": ("src/repro_torch/csrc/addr_decode.cu",
                                 "src/repro/kernels/addr_decode/kernel.py:57"),
               "flash_attention": (
                   flash_src["sm90_bf16"],
                   "src/repro/kernels/flash_attention/kernel.py:89")}
    flash_timing, flash_err = timing["flash_attention"], max_err[
        "flash_attention"]
    timing["flash_attention"] = flash_timing["sm90_bf16"]
    max_err["flash_attention"] = flash_err["sm90_bf16/bfloat16"]
    table = []
    for name, (src, replaces) in sources.items():
        t = timing[name]
        by_flops = "flops" in t
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": replaces, "launches": launches[name],
                      "max_abs_err": max_err[name], "ms": t["ms"],
                      "plain_ms": t["plain_ms"], "call_ms": t["call_ms"],
                      "bound_ms": t["bound_ms"] if by_flops
                      else t["bytes"] / MEM_BYTES_PER_S * 1e3,
                      "bound_by": "operations" if by_flops else "bytes",
                      "library_ms": t.get("library_ms"),
                      "shape": t["shape"]})
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
        if name == "decode_packed":
            table[-1].update(
                path="replay, trace route", sweep_launches=0,
                inject_phase_launches=decode_launches,
                ms_at_sweep_batch=t["ms_at_sweep_batch"],
                sweep_batch_shape=t["sweep_batch_shape"],
                replay_profile_device_s=replay_prof.get("decode_device_s"),
                replay_profile_launches=replay_prof.get("decode_launches"),
                replay_card_vs_cpu_max_rel_err=replay_rel,
                serving_full_launches=serve["full"]["decode_packed"],
                serving_profile_device_s=serve["profile"].get(
                    "decode_device_s"))
    table[-1]["routes"] = [
        {"route": r, "source": flash_src[r], "launches": flash_routes[r],
         "max_abs_err": {k: e for k, e in flash_err.items()
                         if k.startswith(r)}, "ms": t["ms"],
         "call_ms": t["call_ms"], "plain_ms": t["plain_ms"],
         "bound_ms": t["bound_ms"], "bound_by": "operations",
         "library_ms": t["library_ms"], "shape": t["shape"],
         **({"cuda_core_same_inputs_ms": t["cuda_core_same_inputs_ms"]}
            if "cuda_core_same_inputs_ms" in t else {})}
        for r, t in flash_timing.items()]
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
