"""Kernel micro-benchmarks of the port's hand-written CUDA kernels.

The counterpart of the JAX package's ``benchmarks/kernels_bench.py``,
on the card.  Each case calls the kernel's wrapper on tensors on the
card, checks it against its plain PyTorch version on the same inputs,
and prints one ``name,us_per_call,derived`` row: ``us_per_call`` is the
device time of one kernel launch (launches captured in one CUDA graph
and replayed, timed by CUDA events): of the wrapper's call for flash
and ``frfcfs_select``, which launch the kernel and nothing else, and of
the kernel's C entry point on inputs prepared once for the decode,
``weave_window`` and ``window_inject``, whose wrappers also mask, cast
or pack on the card.  ``derived`` holds the wrapper call's eager µs
(CUDA events over calls, host launch and preparation included) and the
match.

Cases: the reference's three (flash attention at B 1, Hq 8, Hkv 2, S 512,
D 64, causal, in bf16 on the Hopper route and in fp32 on the CUDA-core
route; ``frfcfs_select`` at C 6 x Q 256 on random planes from seed 1;
the Skylake decode of 65,536 lines from seed 2), and the Mess sweep's
two window kernels at its dense batch (stage 07 on ddr4_2666, the FAST
grid's points that the knee routing sends to the dense engine, window
8): ``weave_window`` against the stepwise weave and ``window_inject``
against the eager bound phase, on the same state.  Flash matches
within 2e-6 (fp32) / 2e-2 (bf16); the rest bit for bit.

Without a card it raises: it never times a plain version in a
kernel's place.  Usage (on the card)::

    python -m repro_torch.bench.kernels_bench
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.bench.util import FAST_MIXES, FAST_PACES, emit

#: flash attention: the reference's case (b, hq, hkv, s, d), causal
FLASH_CASE = (1, 8, 2, 512, 64)
FLASH_TOL = {torch.float32: 2e-6, torch.bfloat16: 2e-2}
#: frfcfs_select: the reference's channels x queue slots
SELECT_CASE = (6, 256)
#: Skylake decode: the reference's lines per call
DECODE_LINES = 1 << 16
#: the Mess sweep's window kernels: stage, windows / warm-up, window
SWEEP_STAGE, SWEEP_WINDOWS, SWEEP_WARMUP, SWEEP_WINDOW = (
    "07-prefetch", 48, 16, 8)


def time_ms(fn, iters: int) -> float:
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


def device_ms(fn, iters: int) -> float:
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


def bit_equal(a, b) -> bool:
    """Whether two trees of tensors (tuples, NamedTuples, dicts, None
    leaves) are equal bit for bit."""
    if isinstance(a, torch.Tensor):
        return bool(torch.equal(a.cpu(), b.cpu()))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(bit_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(bit_equal, a, b))
    return a == b


def select_inputs(dev, seed: int = 1):
    """The reference's `frfcfs_select` case: eleven (C, Q) int32 planes
    and the (C, 8) scalar plane, from ``default_rng(seed)``."""
    C, Q = SELECT_CASE
    rng = np.random.default_rng(seed)

    def r(hi, shape=(C, Q)):
        return torch.from_numpy(
            rng.integers(0, hi, size=shape, dtype=np.int32)).to(dev)

    planes = [r(2), r(2), r(8), r(8) - 1, r(100), r(100), r(100), r(100),
              r(2), r(2), r(1000)]
    cols = [torch.full((C,), 50, dtype=torch.int32, device=dev),
            r(100, (C,)), r(100, (C,)), r(100, (C,)), r(2, (C,)),
            r(8, (C,))]
    cols += [torch.zeros((C,), dtype=torch.int32, device=dev)] * 2
    return planes, torch.stack(cols, dim=1).contiguous()


def decode_inputs(dev, seed: int = 2):
    """The reference's decode case: 65,536 uint32 lines from
    ``default_rng(seed)``, as int64 line indices."""
    rng = np.random.default_rng(seed)
    lines = rng.integers(0, 2 ** 32, DECODE_LINES, dtype=np.uint32)
    return torch.from_numpy(lines.astype(np.int64)).to(dev)


def sweep_state(dev, engine: str = "dense", w: int = SWEEP_WINDOW):
    """The Mess sweep's batch of one engine (the FAST grid's points that
    the knee routing sends to it, stage 07 on ddr4_2666) at the start of
    window ``w``, run there on ``dev``'s routes: ``(cfg, clock, wcfg,
    frontend, carry)``."""
    from repro_torch.core import get_stage, mess, platform, workload

    cfg = get_stage(SWEEP_STAGE, windows=SWEEP_WINDOWS, warmup=SWEEP_WARMUP)
    mess._ensure_calibration()
    pts = [(p, wr) for wr in FAST_MIXES for p in FAST_PACES
           if mess.event_covers(cfg, p) == (engine == "event")]
    cfg = dataclasses.replace(cfg, weave=engine)
    paces = torch.tensor([p for p, _ in pts], dtype=torch.int32, device=dev)
    wrs = torch.tensor([wr for _, wr in pts], dtype=torch.int32, device=dev)
    frontend = workload.MessFrontend(paces, wrs, cfg.workload_config())
    clock, wcfg = cfg.clock(), cfg.workload_config()
    with torch.inference_mode():
        carry = platform._init_carry(cfg, frontend, len(pts), dev)
        for i in range(w):
            carry, _ = platform._window_step(cfg, clock, wcfg, frontend,
                                             carry, i)
    return cfg, clock, wcfg, frontend, carry


def weave_state(dev, engine: str = "dense", w: int = SWEEP_WINDOW):
    """`sweep_state` after window ``w``'s bound phase and injection: the
    weave's arguments ``(cfg, clock, tick_kw, queue, banks)``."""
    from repro_torch.core import platform

    cfg, clock, wcfg, frontend, carry = sweep_state(dev, engine, w)
    with torch.inference_mode():
        queue = platform._bound_inject(cfg, clock, wcfg, frontend, carry,
                                       w)[0]
    return cfg, clock, platform._tick_kw(cfg, clock, dev), queue, carry[1]


def weave_launch(cfg, clock, kw, queue, banks, w: int):
    """`weave_window`'s C entry point (the plain instance) on ``queue`` and
    ``banks`` packed once, for window ``w`` on ``cfg.weave``'s engine:
    ``(launch, bytes, steps)``; ``bytes`` is the state in and out once."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.weave_window import ops as wops

    B, C, Q = queue.valid.shape
    d = cfg.platform.dram
    start = clock.window_start_tick(w)
    n_steps = (cfg.event_budget() if cfg.weave == "event"
               else clock.ticks_per_window_static)
    inp, res = wops.pack_inputs(queue, banks)
    params = wops.pack_params(d, cfg.policy, **{
        k: kw[k] for k in ("tick2cpu_num", "tick2cpu_den",
                           "cpu_ps_per_clk")})
    c_params = (ctypes.c_int * len(params))(*params)
    fn = _build.function("weave_window_launch", wops._ARGTYPES)
    ptrs = [x.data_ptr() for x in inp.values()] + [
        x.data_ptr() for x in res.values()]

    def launch():
        err = fn(*ptrs, ctypes.addressof(c_params), len(params), B * C, Q,
                 d.banks_per_channel, d.ranks_per_channel, start,
                 clock.window_end_tick(w),
                 start + clock.ticks_per_window_static, n_steps,
                 int(cfg.weave == "event"),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"weave_window launch: CUDA error {err}")

    io_bytes = sum(x.numel() * x.element_size()
                   for x in list(inp.values()) + list(res.values()))
    return launch, io_bytes, n_steps


def inject_launch(cfg, clock, wcfg, frontend, carry, w: int):
    """`window_inject`'s C entry point (the Mess instance) on arguments
    prepared once from ``carry`` for window ``w``: ``(launch, bytes)``;
    ``bytes`` is every input read once and every output written once."""
    from repro_torch.core import addrmap
    from repro_torch.kernels.window_inject import ops as iops

    queue, _, fstate, l_ir, lat_est = carry[:5]
    cpu = cfg.platform.cpu
    c_args, res = iops.prepare(
        queue, fstate, frontend.pace, frontend.wr_num, l_ir, lat_est, w=w,
        wcfg=wcfg, clock=clock,
        mapping=addrmap.decode_route(wcfg.mapping, wcfg.dram),
        window_cycles=cpu.window_cycles,
        window_ps=cpu.window_cycles * cpu.cpu_ps_per_clk)
    io_bytes = sum(x.numel() * x.element_size()
                   for x in list(res["inputs"])
                   + [res["queue"], res["core"], res["point"]])
    return (lambda: iops.launch(c_args,
                                torch.cuda.current_stream().cuda_stream),
            io_bytes)


def decode_launch(lines):
    """`decode_packed`'s C entry point on ``lines`` (int64 on the card)
    masked and cast once, as the wrapper does: ``launch``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.addr_decode import ops as dops

    bits = dops.to_int32_bits(lines.reshape(-1) & 0xFFFFFFFF).contiguous()
    out = torch.empty_like(bits)
    fn = _build.function("decode_packed_launch", dops._ARGTYPES)

    def launch():
        err = fn(bits.data_ptr(), out.data_ptr(), bits.numel(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"decode_packed launch: CUDA error {err}")

    return launch


def _row(name: str, ms: float, call_ms: float, match: bool, detail: str):
    # ``derived`` holds no comma: it is the CSV row's last field
    emit(f"kernel.{name}", ms * 1e3,
         f"eager_us={call_ms * 1e3:.2f}; match={match}; {detail}")
    return dict(name=name, device_us=ms * 1e3, eager_us=call_ms * 1e3,
                match=match, detail=detail)


def bench_flash(dev) -> list[dict]:
    """Flash attention at the reference's case on both routes."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     mha_plain, route)

    b, hq, hkv, s, d = FLASH_CASE
    rng = np.random.default_rng(0)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, d)))
                   .to(dev, dtype) for h in (hq, hkv, hkv))
        which = route(q, k, v)

        def call():
            return flash_attention(q, k, v, causal=True)

        got = call().float()
        want = mha_plain(q, k, v, causal=True).float()
        err = float((got - want).abs().max())
        tol = FLASH_TOL[dtype]
        ok = bool(torch.allclose(got, want, atol=tol, rtol=tol))
        rows.append(_row(
            f"flash_attention.{which}", device_ms(call, 20),
            time_ms(call, 20), ok,
            f"maxerr={err:.1e} (tol {tol:g}); B={b} Hq={hq} Hkv={hkv} "
            f"S={s} D={d} {str(dtype)[6:]} causal; "
            f"{4 * b * hq * s * s * d / 2 / 1e9:.2f} GFLOP"))
    return rows


def bench_select(dev) -> dict:
    from repro_torch.kernels.bank_timing import frfcfs_select, select_plain

    planes, scal = select_inputs(dev)
    ok = bit_equal(frfcfs_select(*planes, scal), select_plain(*planes, scal))
    C, Q = SELECT_CASE

    def call():
        return frfcfs_select(*planes, scal)

    return _row("bank_timing.frfcfs_select", device_ms(call, 200),
                time_ms(call, 200), ok,
                f"{C}x{Q} eligibility plane per DRAM tick")


def bench_decode(dev) -> dict:
    """The Skylake decode: its C entry point on lines masked and cast
    once, in a graph; the wrapper's call (mask, cast, launch) eager."""
    from repro_torch.kernels.addr_decode import (decode_packed,
                                                 decode_packed_plain)

    lines = decode_inputs(dev)
    ok = bit_equal(decode_packed(lines), decode_packed_plain(lines))
    return _row("addr_decode.decode_packed",
                device_ms(decode_launch(lines), 200),
                time_ms(lambda: decode_packed(lines), 200), ok,
                f"{DECODE_LINES} lines/call, 4 B/line packed output")


def bench_weave(dev) -> dict:
    """`weave_window` at the sweep's dense batch: the C entry point on
    packed inputs in a graph, the wrapper's route eager, the stepwise
    route (its plain version) on the same state."""
    from repro_torch.core import platform

    w = SWEEP_WINDOW
    cfg, clock, kw, queue, banks = weave_state(dev, "dense", w)
    args = (cfg, clock, kw, queue, banks, w)
    with torch.inference_mode():
        ok = bit_equal(platform._weave_fused(*args),
                       platform._weave_stepwise(*args))
        launch, _, n_steps = weave_launch(*args)
        B, C, Q = queue.valid.shape
        return _row("weave_window", device_ms(launch, 5),
                    time_ms(lambda: platform._weave_fused(*args), 5), ok,
                    f"{B * C} rows x {Q} slots x {n_steps} dense steps "
                    f"({cfg.name} ddr4_2666 window {w})")


def bench_inject(dev) -> dict:
    """`window_inject` at the sweep's dense batch: the C entry point on
    prepared arguments in a graph, the wrapper's route eager, the eager
    bound phase (its plain version) on the same state."""
    from repro_torch.core import platform

    w = SWEEP_WINDOW
    cfg, clock, wcfg, frontend, carry = sweep_state(dev, "dense", w)
    args = (cfg, clock, wcfg, frontend, carry, w)
    with torch.inference_mode():
        ok = bit_equal(platform._bound_inject_fused(*args),
                       platform._bound_inject_eager(*args))
        launch, _ = inject_launch(*args)
        B, C, Q = carry[0].valid.shape
        return _row(
            "window_inject", device_ms(launch, 20),
            time_ms(lambda: platform._bound_inject_fused(*args), 50), ok,
            f"B={B} points x {wcfg.n_cores * 80} candidates; {C} channels "
            f"x {Q} slots ({cfg.name} ddr4_2666 window {w})")


def main(full: bool = False, device=None) -> list[dict]:
    """Every case on ``device`` (``None``: the current card); one row
    each.  Raises without a card, and when a kernel disagrees with its
    plain version (after printing every row)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"the kernels bench times the hand-written CUDA "
                           f"kernels on a card, and {dev} is none: it never "
                           f"times a plain version in a kernel's place")
    with torch.cuda.device(dev):
        rows = bench_flash(dev) + [bench_select(dev), bench_decode(dev),
                                   bench_weave(dev), bench_inject(dev)]
    bad = [r["name"] for r in rows if not r["match"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")
    return rows


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="CUDA device (default: the current card)")
    main(device=ap.parse_args().device)
