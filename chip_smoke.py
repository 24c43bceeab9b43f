#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

Run from a checkout of the repository, on a machine with a CUDA card::

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. **build** — nvcc builds the kernels' shared library from
   ``src/repro_torch/csrc`` (or finds a fresh build); the Hopper flash
   kernel's ptxas report (registers, spills) and shared memory.
2. **kernels** — each CUDA kernel against its plain PyTorch version on
   the card: the Mess kernels bit for bit over the main path's shapes,
   then both timed at the main path's batch; ``flash_attention`` at the
   shapes of ``tests/test_kernels.py`` plus a decode (Sq = 1) and a
   ragged query tile at D = 128 and 64, in fp32 (within 2e-6) and bf16
   (within 2e-2), each check on the route that ``route`` gives it
   (bf16 at D 64 or 128: the Hopper kernel; the rest: the CUDA-core
   kernel), at a causal shape with Sq > Sk (rows that see no key must be
   exactly 0) and at the LM path's shape, where both routes are timed
   beside ``scaled_dot_product_attention`` as a yardstick (the Hopper
   route in bf16, the CUDA-core route in fp32 and on the same bf16
   inputs).
3. **main_path** — the repository's default benchmark run of the full
   paper stack: ``sweep(get_stage("07-prefetch", windows=48,
   warmup=16), paces=(1, 4, 12, 24, 48, 64), write_mixes=(0, 16, 32))``
   on ``ddr4_2666``, with every kernel's launch count read just after.
4. **parity** — one stage-07 ``run_point`` on the card and on the CPU
   through the same port: equal integers, float views within 1e-6.
5. **lm_path** — the dense LM serving path at the full width and depth
   of tinyllama-1.1b (bf16, weights from a seed, flash kernel on): five
   forwards over 2 x 2048 tokens (each 22 launches of the Hopper route,
   none of the CUDA-core one; the median wall gives tokens/s), one more
   forward under ``torch.profiler``
   (device time by kernel and the device's idle share, a ``profile``
   line), prefill of the first 2047 tokens (22 Hopper launches) + one
   decode step agreeing with the forward's last position, and the
   greedy Engine answering 8 requests on 4 slots.
6. **lm_parity** — the port's forward at tinyllama widths, 2 layers,
   256 tokens, fp32 (the CUDA-core route), on the card and on the CPU
   (plain version), from the same weights, within 1e-4.

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
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in dev_events)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for a, z in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, z
        else:
            cur_e = max(cur_e, z)
    busy += cur_e - cur_s
    window = max(z for _, z in spans) - spans[0][0]
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
    smem = _build.function("flash_attention_sm90_smem_bytes", [ctypes.c_int])
    emit({"phase": "build", "library": str(lib.relative_to(ROOT)),
          "built": _build.build_info["built"],
          "seconds": _build.build_info["seconds"], "ptxas": regs,
          "flash_sm90_ptxas": [ln.strip() for ln in sm90.splitlines()
                               if "entry" in ln or "spill" in ln
                               or "registers" in ln] if log else
          "not rebuilt in this run",
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
    for n in (1, 100, 4097, n_main, 1 << 20):
        lines = chase_lines(rng, n, dev)
        diff = (decode_packed(lines).long()
                - decode_packed_plain(lines).long()).abs()
        max_err["decode_packed"] = max(max_err["decode_packed"],
                                       int(diff.max()))
        mismatches["decode_packed"] += int((diff != 0).sum())
        checked["decode_packed"] += n
    torch.cuda.synchronize()

    # timing at the main path's dense batch: B points x 6 channels x 256
    rows, Q = n_dense * cfg.platform.dram.n_channels, 256
    planes, scal = select_inputs(rng, rows, Q, dev)
    lines = chase_lines(rng, n_main, dev)
    bits = to_int32_bits(lines & 0xFFFFFFFF).contiguous()
    out = torch.empty_like(bits)
    launch = _build.function("decode_packed_launch", decode_ops._ARGTYPES)

    def decode_kernel():
        err = launch(bits.data_ptr(), out.data_ptr(), n_main,
                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"decode_packed launch: CUDA error {err}")

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
            ms=device_ms(decode_kernel, 200),
            call_ms=time_ms(lambda: decode_packed(lines), 500),
            plain_ms=time_ms(lambda: decode_packed_plain(lines), 50),
            bytes=n_main * 4 * 2, shape=f"{n_main}"),
    }
    emit({"phase": "kernels", "checked": checked, "mismatches": mismatches,
          "max_abs_err": max_err, "timing": timing})
    if any(mismatches.values()):
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{mismatches}")
    max_err["flash_attention"], timing["flash_attention"] = check_flash(dev)

    # ---- 3. the main path -----------------------------------------------
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = sweep(cfg, paces=FAST_PACES, write_mixes=FAST_MIXES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
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
          "weave_steps": launches["frfcfs_select"], "launches": launches,
          "per_mix": per_mix,
          "views": {f: getattr(res, f).tolist() for f in (
              "sim_bw", "sim_lat", "if_bw", "if_lat", "app_bw", "app_lat",
              "chase_lat")}})
    for name in ("frfcfs_select", "decode_packed"):
        if launches[name] <= 0:
            raise AssertionError(f"the main path never launched {name}")
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

    # ---- 4. parity: the card against the CPU through the same port -----
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

    # ---- 5-6. the dense LM serving path, and its card-vs-CPU parity ------
    flash_routes = lm_path(dev)
    launches["flash_attention"] = sum(flash_routes.values())
    lm_parity(dev)

    # ---- the kernel table, the card, the result ---------------------------
    # launches: frfcfs_select / decode_packed from the main path's sweep,
    # flash_attention from the LM path's forward; its row carries the
    # route the forward takes (sm90_bf16), and both routes under "routes"
    flash_src = {"sm90_bf16": "src/repro_torch/csrc/flash_attention_sm90.cu",
                 "cuda_core": "src/repro_torch/csrc/flash_attention.cu"}
    sources = {"frfcfs_select": ("src/repro_torch/csrc/bank_timing.cu",
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
