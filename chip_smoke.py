#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

Run from a checkout of the repository, on a machine with a CUDA card::

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. **build** — nvcc builds the kernels' shared library from
   ``src/repro_torch/csrc`` (or finds a fresh build).
2. **kernels** — each CUDA kernel against its plain PyTorch version on
   the card, bit for bit, over the main path's shapes; then both timed
   at the main path's batch.
3. **main_path** — the repository's default benchmark run of the full
   paper stack: ``sweep(get_stage("07-prefetch", windows=48,
   warmup=16), paces=(1, 4, 12, 24, 48, 64), write_mixes=(0, 16, 32))``
   on ``ddr4_2666``, with every kernel's launch count read just after.
4. **parity** — one stage-07 ``run_point`` on the card and on the CPU
   through the same port: equal integers, float views within 1e-6.

Then the kernel table (``{"kernels": [...]}``), the card's name and
power limit as nvidia-smi reports them, and the result line.  Any
failure raises: the script then exits non-zero and prints no result.
Without a card, or without the repository beside it, it exits non-zero.
"""
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
FAST_PACES = (1, 4, 12, 24, 48, 64)
FAST_MIXES = (0, 16, 32)
RTOL = 1e-6


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

    # ---- 1. build ------------------------------------------------------
    lib = _build.build()
    regs = [ln.strip() for ln in _build.build_info["log"].splitlines()
            if "registers" in ln]
    emit({"phase": "build", "library": str(lib.relative_to(ROOT)),
          "built": _build.build_info["built"],
          "seconds": _build.build_info["seconds"], "ptxas": regs})

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
    for name, n in launches.items():
        if n <= 0:
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

    # ---- the kernel table, the card, the result ---------------------------
    sources = {"frfcfs_select": ("src/repro_torch/csrc/bank_timing.cu",
                                 "src/repro/kernels/bank_timing/kernel.py:97"),
               "decode_packed": ("src/repro_torch/csrc/addr_decode.cu",
                                 "src/repro/kernels/addr_decode/kernel.py:57")}
    table = []
    for name, (src, replaces) in sources.items():
        t = timing[name]
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": replaces, "launches": launches[name],
                      "max_abs_err": max_err[name], "ms": t["ms"],
                      "plain_ms": t["plain_ms"], "call_ms": t["call_ms"],
                      "bound_ms": t["bytes"] / MEM_BYTES_PER_S * 1e3,
                      "bound_by": "bytes", "library_ms": None,
                      "shape": t["shape"]})
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
