"""The trace instance of the interface-window kernel
(`kernels.window_inject.window_inject_trace`) and its route.

On the CPU: the route rule (CPU state takes the eager route, a
`TraceFrontend` on the card the trace instance, by type), the wrapper's
refusals, the C entry point's argument order, and a numpy emulation of
the instance's algorithm for each point -- the scalars, each core's 64
accesses at its clamped cursor scanned two a lane over one warp (the
cost finish times and the int32-wrapped line sums), the take, the phase
hash and floor remainder within the footprint, the candidates' 64-bit
keys through the bitonic network, the free slots ranked by 32-slot
chunk masks, every slot written once, and `TraceFrontend.update` --
held bit for bit against the port's eager route (`bound` ->
`inject_queue` -> `update`) on the CPU, window by window, with slots
freed at random between windows.  The cases cover a `Trace` batch and a
`TraceMix` batch, one and two sockets, the three presets (and the
simple, Skylake XOR and XOR-fold decodes), cursors near the end of a
trace and past the ``n_slots - 64`` clamp, and running line sums that
wrap negative.  Four broken emulations (an inclusive start cycle, the
line sum without the int32 wrap, C's ``%`` for the floor remainder, a
take that skips what does not fit and goes on) must fail it.

On the card (``gpu``): the instance against the eager route, window by
window.  ``python -m pytest -m gpu tests/test_torch_trace_inject.py``
runs it on a machine with a card.
"""
import pathlib
import re
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import addrmap, dram, platform, workload
from repro_torch.core.stages import get_stage
from repro_torch.kernels.window_inject import (PARAM_NAMES, pack_params,
                                              window_inject_trace)
from repro_torch.kernels.window_inject import ops as inject_ops
from repro_torch.traces import (Trace, TraceFrontend, TraceMix, TraceState,
                                make_suite, stack_traces)
from test_torch_window_inject import _bitonic, _chase_line, _decode, _w32

torch.set_num_threads(1)

CSRC = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "csrc" / "window_inject.cu")
CASES = [
    # stage, preset, sockets, channel ownership, container
    ("07-prefetch", "ddr4_2666", 1, "interleaved", "trace"),  # skylake_xor
    ("01-baseline", "ddr4_2666", 2, "interleaved", "mix"),    # simple
    ("10-delay-buffer", "ddr4_2666", 2, "partitioned", "mix"),
    ("07-prefetch", "ddr5_4800", 1, "interleaved", "mix"),    # xor_fold
    ("01-baseline", "ddr5_4800", 2, "interleaved", "trace"),  # simple
    ("10-delay-buffer", "hbm2e", 2, "partitioned", "trace"),  # xor_fold
    ("07-prefetch", "hbm2e", 1, "interleaved", "mix"),
]
B = 3              # points (apps or mixes) a batch
L = 300            # accesses of the longest stream
WINDOWS = 4
U32 = 0xFFFFFFFF


def _ids(case):
    return "-".join(map(str, case))


# ---- the inputs -----------------------------------------------------------

def _streams(rng, shape):
    """delta / is_write / dep arrays: short strides and pointer jumps
    with every few an int32-range delta (the sums wrap), a third of the
    accesses dependent (the costs mix)."""
    small = rng.integers(-9, 70, shape)
    huge = rng.integers(-2 ** 31, 2 ** 31, shape)
    delta = np.where(rng.random(shape) < 0.1, huge, small)
    return (delta.astype(np.int32), rng.integers(0, 2, shape, np.int32),
            (rng.random(shape) < 0.35).astype(np.int32))


def _container(kind, rng, n_cores):
    """A `Trace` batch (B, L + 64) or a `TraceMix` batch (B, N, L + 64)
    of CPU tensors, with footprints that are not powers of two."""
    n_slots = L + 64
    feet = np.array([1_000_003, 77_777, 4093], np.int32)
    if kind == "trace":
        delta, wr, dep = _streams(rng, (B, n_slots))
        t = lambda x: torch.from_numpy(np.asarray(x, np.int32))  # noqa: E731
        return Trace(delta=t(delta), is_write=t(wr), dep=t(dep),
                     length=t([L, L - 37, 100]), footprint_lines=t(feet))
    delta, wr, dep = _streams(rng, (B, n_cores, n_slots))
    length = rng.integers(60, L + 1, (B, n_cores))
    length[:, n_cores - 1] = 0                      # the chase core
    length[:, 3] = 0                                # an idle core
    foot = rng.choice(feet, (B, n_cores))
    region = np.full(B, int(feet.max()) + 17)
    t = lambda x: torch.from_numpy(np.asarray(x, np.int32))  # noqa: E731
    app = np.where(length > 0, np.arange(n_cores) % 3, -1)
    return TraceMix(delta=t(delta), is_write=t(wr), dep=t(dep),
                    length=t(length), footprint_lines=t(foot),
                    pos0=t(np.zeros((B, n_cores))),
                    line_cum0=t(np.zeros((B, n_cores))), app_id=t(app),
                    region_lines=t(region))


def _state(rng, n_cores, n_slots):
    """Cursors at 0, mid-stream, near the end and past the clamp; line
    sums near both ends of int32 (the first window's sums wrap)."""
    pos = rng.integers(0, L, (B, n_cores))
    pos[:, 0] = 0
    pos[:, 1] = L - 10                     # near the end of the longest
    pos[:, 2] = n_slots - 64               # at the clamp
    pos[:, 4] = n_slots - 64 + 9           # past it: clamped
    cum = rng.integers(-2 ** 31, 2 ** 31, (B, n_cores))
    cum[:, 0] = 2 ** 31 - 5                # wraps to negative at once
    cum[:, 5] = -2 ** 31 + 3               # negative, wraps on negatives
    cum[:, 6] = -40                        # small negative sums
    t = lambda x: torch.from_numpy(np.asarray(x, np.int32))  # noqa: E731
    return TraceState(pos=t(pos), line_cum=t(cum),
                      carry=t(rng.integers(0, 1001, (B, n_cores))),
                      chase_seq=t(rng.integers(-2 ** 31, 2 ** 31, B)),
                      chase_carry=t(rng.integers(0, 300, B)))


def _queue(rng, cfg):
    """A batch of queues about half full, every field drawn at random."""
    q = dram.init_queue(cfg.platform.dram, cfg.policy,
                        n_sockets=cfg.n_sockets, batch=B)
    shape = q.valid.shape
    fields = {k: torch.from_numpy(rng.integers(0, 1 << 20, shape,
                                               dtype=np.int32))
              for k in q._fields}
    fields["valid"] = torch.from_numpy(
        (rng.random(shape) < 0.5).astype(np.int32))
    return q._make(fields[k].to(v.dtype) for k, v in q._asdict().items())


# ---- the instance's algorithm, emulated in numpy -------------------------

def emulate_trace_point(q, st, tr, l_ir, lat_est, p, budget_num, n_slots,
                        broken=None):
    """One block of ``window_inject.cu``'s trace instance (one point).

    ``q``: dict of the seven (C, Q) planes; ``st``: the point's
    `TraceState` fields ((N,) arrays, then two ints); ``tr``: delta,
    is_write, dep as (N, n_slots) rows, target, foot (N,) and region;
    ``l_ir``, ``lat_est``, ``budget_num`` float32.  ``broken``:
    ``"inclusive_start"`` (issue at the access's finish time),
    ``"cum_unwrapped"`` (the line sum in int64), ``"c_remainder"`` (C's
    ``%``, the sign of the dividend) or ``"take_skips"`` (an access that
    does not fit is skipped and the next ones still tried), for the
    tests that must fail.  Returns ``(queue', pos', line_cum', carry',
    chase_seq', chase_carry', injected, l_ir_cycles)``.
    """
    N, C, Q = p["n_cores"], p["n_channels"], p["q"]
    wc = p["window_cycles"]
    n = N * 80
    n_sort = 2
    while n_sort < n:
        n_sort <<= 1
    # the point's scalars (as the Mess instance's)
    l_ir_cycles = max(int(np.rint(np.float32(l_ir))), 1)
    lat = np.float32(lat_est)
    lat = np.float32(1.0) if lat < 1 else lat
    per = np.float32(budget_num) / lat
    budget = int(np.float32(1.0) if per < 1 else per)
    noc_rt = p["noc_req_cycles"] + p["noc_resp_cycles"]
    iter_cycles = max(int(_w32(p["cache_path_cycles"] + noc_rt
                               + l_ir_cycles)), 1)
    chase_budget = int(_w32(wc + st["chase_carry"]))
    chase_iters = min(chase_budget // iter_cycles, 80)
    ind_cycles = max(wc // max(budget, 1), 1)

    # each core's 64 accesses at its clamped cursor, one warp a core
    pos = np.minimum(st["pos"], n_slots - 64)
    j = np.arange(64)
    at = pos[:, None] + j
    d = np.take_along_axis(tr["delta"], at, 1).astype(np.int64)
    wr = np.take_along_axis(tr["is_write"], at, 1)
    cost = np.where(np.take_along_axis(tr["dep"], at, 1) == 1, iter_cycles,
                    ind_cycles).astype(np.int64)

    def lane_scan(x):
        """Inclusive scan of (N, 64) two a lane, mod 2^32: pair sums, a
        scan over the 32 lanes, each pair's first = the lane's exclusive
        prefix + its first."""
        pair = x.reshape(N, 32, 2)
        incl = np.cumsum(pair.sum(2), 1) % (1 << 32)
        first = (incl - pair.sum(2) + pair[..., 0]) % (1 << 32)
        return _w32(np.stack([first, incl], 2).reshape(N, 64))

    fin = lane_scan(cost)
    avail = _w32(wc + st["carry"])
    in_range = _w32(pos[:, None] + j) < tr["target"][:, None]
    take = in_range & (fin <= avail[:, None])
    if broken == "take_skips":
        take = np.zeros_like(in_range)
        for c in range(N):
            used = 0
            for k in range(64):
                if in_range[c, k] and used + cost[c, k] <= avail[c]:
                    take[c, k] = True
                    used += cost[c, k]
    n_take = take.sum(1)
    used = _w32(np.where(take, cost, 0).sum(1))
    new_carry = np.clip(np.where(in_range.any(1), _w32(avail - used), 0),
                        0, wc)
    if broken == "cum_unwrapped":
        cum = st["line_cum"][:, None] + np.cumsum(d, 1)
    else:
        cum = _w32(st["line_cum"][:, None] + lane_scan(d & U32))
    core = np.arange(N, dtype=np.int64)
    foot = np.maximum(tr["foot"], 1).astype(np.int64)
    phase = ((core * 2654435761) & U32) % foot
    v = cum + phase[:, None]
    if broken != "cum_unwrapped":
        v = _w32(v)
    idx = (np.fmod(v, foot[:, None]) if broken == "c_remainder"
           else v % foot[:, None])
    base = (core * int(tr["region"])) & U32
    t_line = (base[:, None] + idx) & U32
    start = fin if broken == "inclusive_start" else _w32(fin - cost)
    t_issue = np.minimum(start, wc - 1)
    traffic = core < p["n_traffic"]

    # the (N, 80) candidates: a traffic core's first 64 slots, the
    # chase core's 80
    def pad(x, fill=0):
        return np.concatenate([x, np.full((N, 16), fill, x.dtype)], 1)

    jj = np.arange(80)
    chase = ((core == N - 1)[:, None] & (jj < chase_iters)) & \
        ~traffic[:, None]
    cd = dict(
        valid=np.where(traffic[:, None], pad(take), chase),
        line=np.where(traffic[:, None], pad(t_line),
                      _chase_line(_w32(st["chase_seq"] + jj))[None, :]
                      .astype(np.int64)),
        is_write=traffic[:, None] & pad(wr == 1, False),
        issue=np.where(traffic[:, None], pad(t_issue),
                       _w32(jj * iter_cycles)[None, :]),
        chase=chase)
    cd = {k: v.reshape(-1) for k, v in cd.items()}
    f = np.arange(n)
    owner = f // 80
    ch, rank, bank, row = _decode(cd["line"].astype(np.uint64), owner, p)
    adm = _w32(_w32(ch * (1 << 26)) + _w32(
        _w32(np.where(cd["chase"], 0, 1) << 24) + _w32(cd["issue"] * 64))
        + owner)
    key = np.full(n_sort, np.uint64(2 ** 64 - 1))
    key[:n] = np.where(
        cd["valid"],
        ((adm.astype(np.uint64) & np.uint64(U32)) ^ np.uint64(1 << 31))
        << np.uint64(32),
        np.uint64(U32) << np.uint64(32)) | f.astype(np.uint64)
    cnt = np.bincount(ch[cd["valid"]], minlength=C)
    start_c = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    key = _bitonic(key)

    # every free slot, the fr-th of its channel (chunk masks and their
    # prefix, as the kernel ranks them), takes the channel's fr-th
    free = (q["valid"] == 0).reshape(-1)
    out = {k: v.reshape(-1).copy() for k, v in q.items()}
    s = np.flatnonzero(free)
    c = s // Q
    chunk_before = np.concatenate([[0], np.cumsum(
        free.reshape(-1, 32).sum(1))])
    row_start = chunk_before[(s // Q) * (Q // 32)]
    fr = chunk_before[s >> 5] - row_start + np.array(
        [int(free[x - (x & 31):x].sum()) for x in s], dtype=np.int64)
    ok = fr < cnt[c]
    s, c, fr = s[ok], c[ok], fr[ok]
    fi = (key[start_c[c] + fr] & np.uint64(U32)).astype(np.int64)
    cycle = _w32(p["w_cycles"] + cd["issue"][fi])
    arr = _w32(cycle + p["cache_path_cycles"] + p["noc_req_cycles"])
    out["valid"][s] = 1
    out["is_write"][s] = cd["is_write"][fi]
    out["arrival"][s] = _w32(_w32(arr * p["c2t_num"]) + p["c2t_round"]) \
        // p["c2t_den"]
    out["issue_cycle"][s] = cycle
    out["fbank"][s] = _w32(rank[fi] * p["banks_per_rank"] + bank[fi])
    out["row"][s] = row[fi]
    out["is_chase"][s] = cd["chase"][fi]

    # TraceFrontend.update
    return ({k: v.reshape(C, Q) for k, v in out.items()},
            _w32(st["pos"] + n_take),
            _w32(st["line_cum"] + np.where(take, d, 0).sum(1)),
            new_carry, int(_w32(st["chase_seq"] + chase_iters)),
            int(_w32(chase_budget - chase_iters * iter_cycles)),
            int(ok.sum()), l_ir_cycles)


def _point_inputs(trace, state, b, n_cores, n_traffic):
    """Point ``b``'s state and trace rows as numpy, per core."""
    st = {k: (np.asarray(v[b], np.int64) if v.dim() == 2 else int(v[b]))
          for k, v in state._asdict().items()}
    rows = {k: np.asarray(getattr(trace, k)[b], np.int64)
            for k in ("delta", "is_write", "dep")}
    if isinstance(trace, TraceMix):
        tr = dict(rows, target=np.asarray(trace.length[b], np.int64),
                  foot=np.asarray(trace.footprint_lines[b], np.int64),
                  region=int(trace.region_lines[b]))
    else:
        tr = {k: np.broadcast_to(v, (n_cores, v.shape[-1]))
              for k, v in rows.items()}
        tr.update(target=np.where(np.arange(n_cores) < n_traffic,
                                  int(trace.length[b]), 0),
                  foot=np.full(n_cores, int(trace.footprint_lines[b])),
                  region=int(trace.footprint_lines[b]))
    return st, tr


def _run_against_eager(case, broken=None):
    """Emulation vs the eager route over WINDOWS windows; returns the
    first mismatch as a string, or None."""
    stage, preset, sockets, owner, kind = case
    cfg = get_stage(stage, preset=preset, n_sockets=sockets,
                    socket_channels=owner)
    wcfg, clock, cpu = cfg.workload_config(), cfg.clock(), cfg.platform.cpu
    rng = np.random.default_rng(sockets * 7 + len(stage) + len(preset)
                                + len(kind))
    trace = _container(kind, rng, wcfg.n_cores)
    frontend = TraceFrontend(trace, wcfg)
    n_slots = trace.n_slots
    state = _state(rng, wcfg.n_cores, n_slots)
    queue = _queue(rng, cfg)
    budget_num = np.float32(workload.MSHR_CAP * cpu.window_cycles
                            * cpu.cpu_ps_per_clk)
    mapping = addrmap.decode_route(wcfg.mapping, wcfg.dram)
    accepted = 0
    for w in range(WINDOWS):
        p = dict(zip(PARAM_NAMES, pack_params(
            wcfg, clock, mapping=mapping, w=w,
            window_cycles=cpu.window_cycles, q=queue.valid.shape[-1])))
        l_ir = rng.uniform(0.5, 300.0, B).astype(np.float32)
        l_ir[w % B] = 2.5 + w                          # halves: to even
        lat_est = rng.uniform(6e4, 1.2e6, B).astype(np.float32)
        carry = (queue, None, state, torch.from_numpy(l_ir),
                 torch.from_numpy(lat_est))
        q_ref, s_ref, inj_ref, lir_ref = platform._bound_inject_eager(
            cfg, clock, wcfg, frontend, carry, w)
        for b in range(B):
            st, tr = _point_inputs(trace, state, b, wcfg.n_cores,
                                   wcfg.n_traffic)
            qn = {k: np.asarray(v[b], np.int64)
                  for k, v in queue._asdict().items()}
            got = emulate_trace_point(qn, st, tr, l_ir[b], lat_est[b], p,
                                      budget_num, n_slots, broken)
            want = ({k: np.asarray(v[b]) for k, v in q_ref._asdict().items()},
                    *(np.asarray(x[b]) for x in s_ref), int(inj_ref[b]),
                    int(lir_ref[b]))
            names = ("queue",) + TraceState._fields + ("injected",
                                                       "l_ir_cycles")
            for name, g, r in zip(names, got, want):
                if isinstance(g, dict):
                    for k in g:
                        if not np.array_equal(g[k], r[k]):
                            return f"window {w} point {b} queue.{k}"
                elif not np.array_equal(np.asarray(g), np.asarray(r)):
                    return f"window {w} point {b} {name}: {g} != {r}"
        accepted += int(inj_ref.sum())
        state = s_ref
        # free a random part of each queue, as the weave phase would
        valid = q_ref.valid * torch.from_numpy(
            (rng.random(tuple(q_ref.valid.shape)) < 0.6).astype(np.int32))
        queue = q_ref._replace(valid=valid.to(q_ref.valid.dtype))
    assert accepted > 0
    return None


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_trace_emulation_matches_eager_route(case):
    assert _run_against_eager(case) is None


@pytest.mark.parametrize("broken", ["inclusive_start", "cum_unwrapped",
                                    "c_remainder", "take_skips"])
def test_broken_trace_emulation_fails(broken):
    assert _run_against_eager(CASES[1], broken) is not None


# ---- the route, the wrapper, the entry point -----------------------------

def _on_card():
    return types.SimpleNamespace(
        valid=types.SimpleNamespace(device=torch.device("cuda")))


def _suite_frontend(cfg, n=128):
    _, traces = make_suite(n=n, names=("stream", "gups"))
    return TraceFrontend(stack_traces(traces), cfg.workload_config())


def test_route_rule_trace_frontend_by_type():
    cfg = get_stage("07-prefetch", windows=2, warmup=0)
    fe = _suite_frontend(cfg)
    on_cpu = dram.init_queue(cfg.platform.dram, cfg.policy)
    assert platform._inject_route(on_cpu, fe) is platform._bound_inject_eager
    assert platform._inject_route(_on_card(), fe) \
        is platform._bound_inject_fused_trace
    pace = torch.tensor([4, 4], dtype=torch.int32)
    mess = workload.MessFrontend(pace, pace, cfg.workload_config())
    carry = platform._init_carry(cfg, mess, 2, "cpu")
    with pytest.raises(NotImplementedError,
                       match="MessFrontend on the card: only the trace"):
        platform._bound_inject_fused_trace(
            cfg, cfg.clock(), cfg.workload_config(), mess, carry, 0)


def _call(cfg, frontend, device="cpu", **replace):
    """The wrapper on ``frontend``'s initial state, its fields moved to
    ``device`` (and any field of the trace replaced)."""
    wcfg, cpu = cfg.workload_config(), cfg.platform.cpu
    batch = frontend.batch
    q, _, state, l_ir, lat, _ = platform._init_carry(cfg, frontend, batch,
                                                    "cpu")
    trace = frontend.trace._replace(**replace)
    move = (lambda t: t.to(device))
    return window_inject_trace(
        q._make(move(x) for x in q), state._make(move(x) for x in state),
        trace._make(move(x) for x in trace), move(l_ir), move(lat), w=0,
        wcfg=wcfg, clock=cfg.clock(),
        mapping=addrmap.decode_route(wcfg.mapping, wcfg.dram),
        window_cycles=cpu.window_cycles,
        window_ps=cpu.window_cycles * cpu.cpu_ps_per_clk)


def test_trace_wrapper_refuses_cpu_dtype_and_shapes():
    cfg = get_stage("07-prefetch")
    fe = _suite_frontend(cfg)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="card only"):
        _call(cfg, fe)                                   # CPU tensors
    with pytest.raises(ValueError, match="runs on cuda"):
        _call(cfg, fe, device="meta")
    with pytest.raises(TypeError, match="trace.dep must be torch.int32"):
        _call(cfg, fe, dep=fe.trace.dep.long())
    with pytest.raises(ValueError, match="at least 64 slots"):
        _call(cfg, fe, **{k: getattr(fe.trace, k)[:, :63]
                          for k in ("delta", "is_write", "dep")})
    with pytest.raises(ValueError, match="trace.length has shape"):
        _call(cfg, fe, length=fe.trace.length[:1])
    assert window_inject_trace.launches == 0


def test_trace_entry_point_reads_fields_in_container_order():
    """The C entry point's pointer tables follow `TraceState`'s field
    order and the wrapper's trace order; its argument count is the
    ctypes signature's."""
    src = CSRC.read_text()
    body = src.split('extern "C" int window_inject_trace_launch(')[1]
    sig = body.split(")")[0]
    assert len(sig.split(",")) == len(inject_ops._TRACE_ARGTYPES)
    state = re.findall(r"io\.(\w+) = s\[(\d)\];", body)
    assert [n for n, _ in sorted(state, key=lambda x: x[1])] == \
        list(TraceState._fields)
    trace = re.findall(r"io\.(\w+) = t\[(\d)\];", body)
    assert [n for n, _ in sorted(trace, key=lambda x: x[1])] == [
        "delta", "is_write", "dep", "length", "footprint", "region"]
    assert "return launch<TraceGen>(io," in src
    assert "return launch<MessGen>(io," in src


# ---- on the card ---------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_trace_kernel_matches_eager_route_on_card(cuda, case):
    stage, preset, sockets, owner, kind = case
    cfg = get_stage(stage, preset=preset, n_sockets=sockets,
                    socket_channels=owner, windows=4, warmup=0)
    rng = np.random.default_rng(len(stage) + sockets)
    wcfg, clock = cfg.workload_config(), cfg.clock()
    trace = _container(kind, rng, wcfg.n_cores)
    frontend = TraceFrontend(type(trace)(*(x.to(cuda) for x in trace)),
                             wcfg)
    carry = platform._init_carry(cfg, frontend, B, cuda)
    state = _state(rng, wcfg.n_cores, trace.n_slots)
    carry = (carry[0], carry[1], state._make(x.to(cuda) for x in state),
             *carry[3:])
    kernels.reset_launch_counts()
    with torch.inference_mode():
        for w in range(cfg.windows):
            fused = platform._bound_inject_fused_trace(cfg, clock, wcfg,
                                                       frontend, carry, w)
            eager = platform._bound_inject_eager(cfg, clock, wcfg, frontend,
                                                 carry, w)
            torch.cuda.synchronize()
            for got, want in zip(fused, eager):
                for g, r in (zip(got, want) if isinstance(got, tuple)
                             else [(got, want)]):
                    assert torch.equal(g, r), f"window {w}"
            carry, _ = platform._window_step(cfg, clock, wcfg, frontend,
                                             carry, w)
    counts = kernels.launch_counts()
    assert counts["window_inject_trace"] == 2 * cfg.windows
    assert counts["window_inject"] == 0
