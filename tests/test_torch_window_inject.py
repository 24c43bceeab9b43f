"""The interface-window kernel (`kernels.window_inject`) and its route.

On the CPU: the route rule (CPU state takes the eager route; a frontend
other than the Mess one raises on the card), the wrapper's refusals, its
parameter vector in the order the kernel reads it, and a numpy emulation
of the kernel's algorithm for each point -- the scalars, the candidates
generated and decoded from their flat index, the 64-bit keys through the
bitonic network, the per-channel counts, the free slots ranked by 32-slot
chunk masks and their prefix, every slot written once with its new or
its old value, and the demand counts -- held exactly against the JAX
reference's ``generate`` / ``inject_queue`` / ``update`` window by
window, with slots freed at random between windows.  Two deliberately
broken emulations (ties to the higher flat index; free slots taken
highest first) must fail that comparison.

On the card (``gpu``): the kernel route against the eager route, window
by window.  ``python -m pytest -m gpu tests/test_torch_window_inject.py``
runs it on a machine with a card (JAX and the reference are imported
only by the CPU tests that use them).
"""
import dataclasses
import functools
import pathlib
import re
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import addrmap, dram, platform, workload
from repro_torch.core.stages import get_stage
from repro_torch.kernels.window_inject import (MAPPINGS, MAX_Q, PARAM_NAMES,
                                              pack_params, window_inject)

torch.set_num_threads(1)

CSRC = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "csrc" / "window_inject.cu")
CASES = [
    # stage, preset, sockets, channel ownership: test_torch_workload.py's
    # four, and the simple mapping on a non-DDR4 geometry
    ("07-prefetch", "ddr4_2666", 1, "interleaved"),   # prefetch, skylake_xor
    ("04-model-correct", "ddr4_2666", 2, "interleaved"),
    ("07-prefetch", "ddr4_2666", 2, "partitioned"),
    ("07-prefetch", "hbm2e", 2, "partitioned"),       # xor_fold
    ("01-baseline", "ddr5_4800", 1, "interleaved"),   # simple
]
POINTS = ((1, 0), (12, 16), (64, 32))                 # (pace, wr_num)
WINDOWS = 4
U32 = 0xFFFFFFFF


def _w32(x):
    """int64 (array or int) -> int32 value with wrap-around, as int64."""
    return ((np.asarray(x, dtype=np.int64) + (1 << 31)) % (1 << 32)) \
        - (1 << 31)


# ---- the route and the wrapper -------------------------------------------

class _OtherFrontend(workload.MessFrontend):
    """Any frontend but the Mess one (a subclass counts as another)."""


def test_route_rule_cpu_takes_eager_route():
    cfg = get_stage("07-prefetch", windows=2, warmup=0)
    q = dram.init_queue(cfg.platform.dram, cfg.policy)
    pace = torch.tensor([4], dtype=torch.int32)
    fe = workload.MessFrontend(pace, pace, cfg.workload_config())
    assert platform._inject_route(q, fe) is platform._bound_inject_eager
    on_card = types.SimpleNamespace(
        valid=types.SimpleNamespace(device=torch.device("cuda")))
    assert platform._inject_route(on_card, fe) is platform._bound_inject_fused
    kernels.reset_launch_counts()
    out = platform.run_point(cfg, [4], 16, device="cpu")
    assert kernels.launch_counts()["window_inject"] == 0
    assert int(out["injected"][0]) > 0


def test_other_frontend_on_card_raises():
    cfg = get_stage("07-prefetch", windows=2, warmup=0)
    pace = torch.tensor([4], dtype=torch.int32)
    fe = _OtherFrontend(pace, pace, cfg.workload_config())
    carry = platform._init_carry(cfg, fe, 1, "cpu")
    on_card = types.SimpleNamespace(
        valid=types.SimpleNamespace(device=torch.device("cuda")))
    with pytest.raises(NotImplementedError,
                       match="_OtherFrontend on the card: the card's bound "
                             "phase has a route for MessFrontend"):
        platform._bound_inject(cfg, cfg.clock(), cfg.workload_config(), fe,
                               (on_card,) + tuple(carry[1:]), 0)
    with pytest.raises(NotImplementedError, match="_OtherFrontend"):
        platform._bound_inject_fused(cfg, cfg.clock(), cfg.workload_config(),
                                     fe, carry, 0)


def _call(cfg, *, batch=2, depth=None, device="cpu", dtype=None):
    """The wrapper on ``cfg``'s initial state (optionally another queue
    depth, device, or the seq plane in another dtype)."""
    if depth is not None:
        cfg = dataclasses.replace(
            cfg, policy=dataclasses.replace(cfg.policy, queue_depth=depth))
    wcfg, cpu = cfg.workload_config(), cfg.platform.cpu
    pace = torch.full((batch,), 12, dtype=torch.int32)
    fe = workload.MessFrontend(pace, pace, wcfg)
    q, _, cores, l_ir, lat, _ = platform._init_carry(cfg, fe, batch, "cpu")
    if dtype is not None:
        cores = cores._replace(seq=cores.seq.to(dtype))
    move = (lambda t: t.to(device))
    return window_inject(
        q._make(move(x) for x in q), cores._make(move(x) for x in cores),
        move(pace), move(pace), move(l_ir), move(lat), w=0, wcfg=wcfg,
        clock=cfg.clock(),
        mapping=addrmap.decode_route(wcfg.mapping, wcfg.dram),
        window_cycles=cpu.window_cycles,
        window_ps=cpu.window_cycles * cpu.cpu_ps_per_clk)


def test_wrapper_refuses_cpu_dtype_and_unsized_shapes():
    cfg = get_stage("07-prefetch")
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="card only"):
        _call(cfg)                                          # CPU tensors
    with pytest.raises(ValueError, match="card only"):
        _call(cfg, depth=256 * 2)                           # Q = 512 sized
    with pytest.raises(TypeError, match="cores.seq must be torch.int32"):
        _call(cfg, dtype=torch.int64)
    for depth in (MAX_Q + 32, 2 * MAX_Q, 100):              # > 512, not 32k
        with pytest.raises(ValueError, match="queue slots"):
            _call(cfg, depth=depth)
    with pytest.raises(ValueError, match="candidates a point"):
        _call(get_stage("07-prefetch", n_sockets=3), depth=128)  # 72 cores
    with pytest.raises(ValueError, match="runs on cuda"):
        _call(cfg, device="meta")
    assert window_inject.launches == 0


def _with_channels(cfg, n):
    """``cfg`` on a geometry of ``n`` channels (the simple mapping)."""
    dram = dataclasses.replace(cfg.platform.dram, n_channels=n)
    return dataclasses.replace(
        cfg, platform=dataclasses.replace(cfg.platform, dram=dram))


def test_32_channels_refused_on_both_routes():
    """The int32 admission key ``ch * 2^26 + key`` gives invalid entries
    ``ch = C``, which wraps negative at 32 channels: both routes refuse
    C >= 32 (the kernel's check on CPU tensors, before any launch), and
    31 channels pass the kernel's check."""
    from repro_torch.kernels.window_inject import ops

    base = get_stage("01-baseline", preset="ddr5_4800", windows=1, warmup=0)
    kernels.reset_launch_counts()
    for n, refused in ((32, True), (33, True), (31, False)):
        cfg = _with_channels(base, n)
        wcfg = cfg.workload_config()
        pace = torch.full((2,), 12, dtype=torch.int32)
        fe = workload.MessFrontend(pace, pace, wcfg)
        q, _, cores, l_ir, lat, _ = platform._init_carry(cfg, fe, 2, "cpu")
        assert q.valid.shape[1] == n
        if refused:
            with pytest.raises(ValueError, match="int32 admission key"):
                ops._check_queue(q, wcfg)
            with pytest.raises(ValueError, match="int32 admission key"):
                _call(cfg)
            cand, _ = workload.generate(cores, pace, pace, l_ir, wcfg)
            with pytest.raises(ValueError, match="int32 admission key"):
                workload.inject_queue(q, cand, cfg.clock(), 0, wcfg)
        else:
            fields = ops._check_queue(q, wcfg)
            assert fields[0][2] == (2, n, q.valid.shape[2])
    assert window_inject.launches == 0


def test_param_vector_matches_fields_and_kernel_order():
    src = CSRC.read_text()
    block = src.split("Packed parameter vector")[1].split("#include")[0]
    names = re.findall(r"[A-Za-z_][A-Za-z0-9_]*", block.split(":", 1)[1])
    assert tuple(names) == PARAM_NAMES
    struct = src.split("struct Params {")[1].split("};")[0]
    assert tuple(re.findall(r"([A-Za-z_][A-Za-z0-9_]*)[,;]", struct)) \
        == PARAM_NAMES
    assert f"kNParams = {len(PARAM_NAMES)}" in src
    for stage, preset, sockets, owner in CASES:
        cfg = get_stage(stage, preset=preset, n_sockets=sockets,
                        socket_channels=owner)
        wcfg, clock, d = cfg.workload_config(), cfg.clock(), cfg.platform.dram
        route = addrmap.decode_route(wcfg.mapping, d)
        got = dict(zip(PARAM_NAMES, pack_params(
            wcfg, clock, mapping=route, w=7, window_cycles=1000,
            q=256 * sockets)))
        assert got == dict(
            n_cores=24 * sockets, n_traffic=24 * sockets - 1,
            n_channels=d.n_channels, q=256 * sockets,
            ranks=d.ranks_per_channel, banks_per_rank=d.banks_per_rank,
            lines_per_row=d.lines_per_row, row_mask=d.rows_per_bank - 1,
            mapping=MAPPINGS.index(route),
            channels_per_socket=(d.n_channels // sockets
                                 if owner == "partitioned" else 0),
            window_cycles=1000, w_cycles=7000,
            cache_path_cycles=wcfg.cache_path_cycles,
            noc_req_cycles=wcfg.noc_req_cycles,
            noc_resp_cycles=wcfg.noc_resp_cycles,
            prefetch=int(wcfg.prefetch), pf_shift=wcfg.pf_shift,
            c2t_num=clock.c2t_num, c2t_den=clock.c2t_den,
            c2t_round=clock.c2t_round)
    presets = {n: get_stage("01-baseline", preset=n).platform.dram
               for n in ("ddr4_2666", "ddr5_4800", "hbm2e")}
    assert [addrmap.decode_route(m, presets[n]) for n in presets
            for m in ("simple", "skylake_xor")] == [
        "simple", "skylake_xor", "simple", "xor_fold", "simple", "xor_fold"]
    with pytest.raises(ValueError, match="unknown mapping"):
        addrmap.decode_route("banked", presets["ddr4_2666"])
    with pytest.raises(ValueError, match="6 channels"):
        cfg = get_stage("07-prefetch", preset="hbm2e")
        pack_params(cfg.workload_config(), cfg.clock(), mapping="skylake_xor",
                    w=0, window_cycles=1000, q=256)


# ---- the kernel's algorithm, emulated in numpy ---------------------------

def _lcg(x):
    return (x * np.uint64(2654435761) + np.uint64(0x9E3779B9)) \
        & np.uint64(U32)


def _segment_line(core, k):
    seg = (k >> 6).astype(np.uint64) & np.uint64(U32)   # int32 >> 6, as u32
    c = core.astype(np.uint64)
    h = _lcg((seg * np.uint64(31) + c * np.uint64(97)) & np.uint64(U32))
    return ((c << np.uint64(22)) | ((h & np.uint64(0xFFFF)) << np.uint64(6))
            | (k.astype(np.uint64) & np.uint64(63))) & np.uint64(U32)


def _chase_line(k):
    h = _lcg(_lcg(k.astype(np.uint64) & np.uint64(U32)))
    return np.uint64(1 << 31) | (h >> np.uint64(6))


def _candidates(f, p, quota, seq, pt):
    """The kernel's `candidate` for an array of flat indices."""
    core, j = f // 80, f % 80
    traffic = core < p["n_traffic"]
    q = quota[np.minimum(core, p["n_cores"] - 1)]
    s = seq[np.minimum(core, p["n_cores"] - 1)]
    k = _w32(s + j)
    valid = j < q
    line = _segment_line(core, k)
    is_write = _w32((_w32(_w32(k + 1) * pt["wr"]) >> 6)
                    - (_w32(k * pt["wr"]) >> 6)) > 0
    issue = _w32(j * p["window_cycles"]) // np.maximum(q, 1)
    pf = np.zeros_like(valid)
    if p["prefetch"]:
        pfq = np.minimum(q >> p["pf_shift"], 16)
        jp = j - 64
        pf = (jp >= 0) & (jp < pfq)
        valid = valid | pf
        line = np.where(pf, _segment_line(core, _w32(_w32(s + q) + jp)),
                        line)
        is_write = is_write & ~pf
        issue = np.where(pf, _w32(jp * p["window_cycles"])
                         // np.maximum(pfq, 1), issue)
    chase = ~traffic & (core == p["n_cores"] - 1) & (j < pt["chase_iters"])
    return dict(
        valid=np.where(traffic, valid, chase),
        line=np.where(traffic, line, _chase_line(_w32(pt["chase_seq"] + j))),
        is_write=traffic & is_write,
        issue=np.where(traffic, issue, _w32(j * pt["iter_cycles"])),
        chase=chase, pf=traffic & pf, core=core)


def _decode(line, core, p):
    """The kernel's `decode`: uint32 line -> (ch, rank, bank, row)."""
    ln = line.astype(np.uint64)
    C, R = np.uint64(p["n_channels"]), np.uint64(p["ranks"])
    B, lpr = np.uint64(p["banks_per_rank"]), np.uint64(p["lines_per_row"])
    row_mask = np.uint64(p["row_mask"])

    def sh(x, n):
        return x >> np.uint64(n)

    def bit(x, n):
        return sh(x, n) & np.uint64(1)

    if MAPPINGS[p["mapping"]] == "skylake_xor":
        mc = bit(ln, 0) ^ bit(ln, 6) ^ bit(ln, 11) ^ bit(ln, 17)
        ch = mc * np.uint64(3) + ((sh(ln, 1) ^ sh(ln, 7) ^ sh(ln, 13)
                                   ^ sh(ln, 19)) & np.uint64(U32)) \
            % np.uint64(3)
        bank = ((bit(ln, 2) ^ bit(ln, 12))
                | ((bit(ln, 3) ^ bit(ln, 14)) << np.uint64(1))
                | ((bit(ln, 4) ^ bit(ln, 15)) << np.uint64(2))
                | ((bit(ln, 5) ^ bit(ln, 16)) << np.uint64(3)))
        rank = bit(ln, 8) ^ bit(ln, 18)
        row = sh(ln, 9) & np.uint64(0x1FFFF)
    elif MAPPINGS[p["mapping"]] == "simple":
        ch = ln % C
        a = ln // C // lpr
        rank = a % R
        a = a // R
        bank = a % B
        row = (a // B) & row_mask
    else:
        ch = (ln ^ sh(ln, 6) ^ sh(ln, 12) ^ sh(ln, 18)) % C
        a = ln // C
        bank = ((a // lpr) ^ sh(ln, 13)) % B
        rank = (sh(ln, 8) ^ sh(ln, 17)) % R
        row = sh(ln, 9) & row_mask
    ch = ch.astype(np.int64)
    cps = p["channels_per_socket"]
    if cps:
        ch = (core // 24) * cps + ch % cps
    return ch, rank.astype(np.int64), bank.astype(np.int64), \
        row.astype(np.int64)


def _bitonic(key):
    """The kernel's sorting network over a power-of-two array."""
    n = key.shape[0]
    i = np.arange(n // 2)
    k = 2
    while k <= n:
        j = k >> 1
        while j > 0:
            lo = ((i & ~(j - 1)) << 1) | (i & (j - 1))
            hi = lo + j
            a, z = key[lo], key[hi]
            swap = (a > z) == ((lo & k) == 0)
            key[lo] = np.where(swap, z, a)
            key[hi] = np.where(swap, a, z)
            j >>= 1
        k <<= 1
    return key


def emulate_point(q, seq, backlog, carry, pace, wr, l_ir, lat_est, p,
                  budget_num, broken=None):
    """One block of ``window_inject.cu`` (one point).

    ``q``: dict of the seven (C, Q) planes; ``seq``, ``backlog``: (N,);
    the rest scalars (``l_ir``, ``lat_est``, ``budget_num`` float32).
    ``broken``: ``"tie_high"`` (equal admission values ranked by the
    higher flat index) or ``"free_high"`` (each channel's free slots
    taken highest first), for the tests that must fail.
    Returns ``(queue', seq', backlog', carry', injected, l_ir_cycles)``.
    """
    N, C, Q = p["n_cores"], p["n_channels"], p["q"]
    n = N * 80
    n_sort = 2
    while n_sort < n:
        n_sort <<= 1
    # the point's scalars
    l_ir_cycles = max(int(np.rint(np.float32(l_ir))), 1)
    lat = np.float32(lat_est)
    lat = np.float32(1.0) if lat < 1 else lat
    per = np.float32(budget_num) / lat               # IEEE float32 division
    budget = int(np.float32(1.0) if per < 1 else per)
    noc_rt = p["noc_req_cycles"] + p["noc_resp_cycles"]
    iter_cycles = max(int(_w32(p["cache_path_cycles"] + noc_rt
                               + l_ir_cycles)), 1)
    chase_budget = int(_w32(p["window_cycles"] + carry))
    chase_iters = min(chase_budget // iter_cycles, 80)
    pt = dict(wr=int(wr), chase_seq=int(seq[N - 1]), chase_iters=chase_iters,
              iter_cycles=iter_cycles)
    want = _w32(pace + backlog)
    quota = np.minimum(np.minimum(want, 64), budget)

    # every candidate: generate, decode, its 64-bit key
    f = np.arange(n)
    cd = _candidates(f, p, quota, seq, pt)
    ch, _, _, _ = _decode(cd["line"], cd["core"], p)
    adm = _w32(_w32(ch * (1 << 26)) + _w32(
        _w32(np.where(cd["chase"], 0, 1) << 24) + _w32(cd["issue"] * 64))
        + cd["core"])
    low = (U32 - f) if broken == "tie_high" else f
    key = np.full(n_sort, np.uint64(2 ** 64 - 1))
    key[:n] = np.where(
        cd["valid"],
        ((adm.astype(np.uint64) & np.uint64(U32)) ^ np.uint64(1 << 31))
        << np.uint64(32),
        np.uint64(U32) << np.uint64(32)) | low.astype(np.uint64)
    cnt = np.bincount(ch[cd["valid"]], minlength=C)          # shared atomics
    start = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    # free slots: one 32-bit ballot per chunk, the row's prefix before it
    free = (q["valid"] == 0).reshape(-1)
    lanes = np.arange(32, dtype=np.uint64)
    masks = (free.reshape(-1, 32).astype(np.uint64) << lanes).sum(1)
    pops = free.reshape(-1, 32).sum(1)
    row_chunks = Q // 32
    before = np.array([pops[t - t % row_chunks:t].sum()
                       for t in range(pops.size)])
    key = _bitonic(key)

    # every slot once: a free slot, the fr-th of its channel, takes the
    # fr-th candidate of the channel in sorted order while fr < count
    out = {k: v.reshape(-1).copy() for k, v in q.items()}
    s = np.flatnonzero(free)
    c = s // Q
    below = masks[s >> 5] & ((np.uint64(1) << (s & 31).astype(np.uint64))
                             - np.uint64(1))
    fr = before[s >> 5] + np.array([bin(int(x)).count("1") for x in below],
                                   dtype=np.int64)
    if broken == "free_high":
        fr = pops.reshape(C, row_chunks).sum(1)[c] - 1 - fr
    take = fr < cnt[c]
    s, c, fr = s[take], c[take], fr[take]
    lo_bits = (key[start[c] + fr] & np.uint64(U32)).astype(np.int64)
    fi = (U32 - lo_bits) if broken == "tie_high" else lo_bits
    one = _candidates(fi, p, quota, seq, pt)
    _, rank, bank, row = _decode(one["line"], one["core"], p)
    cycle = _w32(p["w_cycles"] + one["issue"])
    arr = _w32(cycle + p["cache_path_cycles"] + p["noc_req_cycles"])
    out["valid"][s] = 1
    out["is_write"][s] = one["is_write"]
    out["arrival"][s] = _w32(_w32(arr * p["c2t_num"]) + p["c2t_round"]) \
        // p["c2t_den"]
    out["issue_cycle"][s] = cycle
    out["fbank"][s] = _w32(rank * p["banks_per_rank"] + bank)
    out["row"][s] = row
    out["is_chase"][s] = one["chase"]
    acc = np.zeros(N, np.int64)
    np.add.at(acc, one["core"][~one["pf"]], 1)        # shared atomics
    injected = int(take.sum())

    # MessFrontend.update
    traffic = np.arange(N) < p["n_traffic"]
    demanded = np.where(traffic, want, 0)
    new_backlog = np.clip(demanded - np.minimum(acc, demanded), 0, 192)
    new_seq = _w32(seq + np.where(traffic, quota, chase_iters))
    new_carry = int(_w32(chase_budget - chase_iters * iter_cycles))
    return ({k: v.reshape(C, Q) for k, v in out.items()}, new_seq,
            new_backlog, new_carry, injected, l_ir_cycles)


@functools.lru_cache(maxsize=None)
def _ref_fns(cfg):
    import jax

    from repro.core import workload as ref_workload

    wcfg, clock = cfg.workload_config(), cfg.clock()
    gen = jax.jit(lambda cores, p, wr, lir, budget: ref_workload.generate(
        cores, p, wr, lir, wcfg, 1000, budget))
    inj = jax.jit(lambda q, cand, w: ref_workload.inject_queue(
        q, cand, clock, w, wcfg))

    @jax.jit
    def upd(cores, aux, acc, p, wr):
        return ref_workload.MessFrontend(p, wr, wcfg).update(cores, aux, acc)

    return gen, inj, upd


def _run_against_reference(case, broken=None):
    """Emulation vs reference over WINDOWS windows; returns the first
    mismatch as a string, or None."""
    import jax.numpy as jnp

    from repro.core import dram as ref_dram
    from repro.core import workload as ref_workload
    from repro.core.stages import get_stage as ref_get_stage

    stage, preset, sockets, owner = case
    kw = dict(preset=preset, n_sockets=sockets, socket_channels=owner)
    ref_cfg, cfg = ref_get_stage(stage, **kw), get_stage(stage, **kw)
    gen, inj, upd = _ref_fns(ref_cfg)
    wcfg, clock, cpu = cfg.workload_config(), cfg.clock(), cfg.platform.cpu
    window_ps = cpu.window_cycles * cpu.cpu_ps_per_clk
    budget_num = np.float32(workload.MSHR_CAP * window_ps)
    d = ref_cfg.platform.dram
    rng = np.random.default_rng(sockets * 11 + len(stage) + len(preset))
    cores = [ref_workload.init_cores(wcfg.n_cores) for _ in POINTS]
    queues = [ref_dram.init_queue(d, ref_cfg.policy, sockets)
              for _ in POINTS]
    accepted = 0
    for w in range(WINDOWS):
        p = dict(zip(PARAM_NAMES, pack_params(
            wcfg, clock, mapping=addrmap.decode_route(wcfg.mapping, wcfg.dram),
            w=w, window_cycles=cpu.window_cycles,
            q=queues[0].valid.shape[-1])))
        l_ir = rng.uniform(0.5, 300.0, len(POINTS)).astype(np.float32)
        l_ir[w % len(POINTS)] = 2.5 + w                # halves: to even
        lat_est = rng.uniform(6e4, 1.2e6, len(POINTS)).astype(np.float32)
        new_queues, new_cores = [], []
        for i, (pace, wr) in enumerate(POINTS):
            lir_ref = jnp.maximum(jnp.round(jnp.float32(l_ir[i])).astype(
                jnp.int32), 1)
            budget = ref_workload.littles_law_budget(
                jnp.float32(lat_est[i]), window_ps)
            cand, aux = gen(cores[i], jnp.int32(pace), jnp.int32(wr),
                            lir_ref, budget)
            q_ref, acc_ref, n_ref = inj(queues[i], cand, jnp.int32(w))
            c_ref = upd(cores[i], aux, acc_ref, jnp.int32(pace),
                        jnp.int32(wr))
            qn = {k: np.asarray(v).astype(np.int64)
                  for k, v in queues[i]._asdict().items()}
            got = emulate_point(
                qn, np.asarray(cores[i].seq, np.int64),
                np.asarray(cores[i].backlog, np.int64),
                int(cores[i].chase_carry), pace, wr, l_ir[i], lat_est[i], p,
                budget_num, broken)
            want = ({k: np.asarray(v) for k, v in q_ref._asdict().items()},
                    np.asarray(c_ref.seq), np.asarray(c_ref.backlog),
                    int(c_ref.chase_carry), int(n_ref), int(lir_ref))
            names = ("queue", "seq", "backlog", "chase_carry", "injected",
                     "l_ir_cycles")
            for name, g, r in zip(names, got, want):
                if isinstance(g, dict):
                    for k in g:
                        if not np.array_equal(g[k], r[k]):
                            return f"window {w} point {i} queue.{k}"
                elif not np.array_equal(np.asarray(g), np.asarray(r)):
                    return f"window {w} point {i} {name}: {g} != {r}"
            accepted += int(n_ref)
            new_queues.append(q_ref)
            new_cores.append(c_ref)
        cores = new_cores
        # free a random part of each queue, as the weave phase would
        queues = []
        for q in new_queues:
            qd = {k: np.array(v) for k, v in q._asdict().items()}
            qd["valid"] &= (rng.random(qd["valid"].shape) < 0.6)
            queues.append(ref_dram.QueueState(
                **{k: jnp.asarray(v) for k, v in qd.items()}))
    assert accepted > 0
    return None


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_kernel_emulation_matches_reference(case):
    assert _run_against_reference(case) is None


@pytest.mark.parametrize("broken", ["tie_high", "free_high"])
def test_broken_emulation_fails(broken):
    # stage 07: prefetch and demand candidates of a core tie on issue cycle
    assert _run_against_reference(CASES[0], broken) is not None


# ---- on the card ---------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_kernel_matches_eager_route_on_card(cuda, case):
    stage, preset, sockets, owner = case
    cfg = get_stage(stage, preset=preset, n_sockets=sockets,
                    socket_channels=owner, windows=4, warmup=0)
    paces = torch.tensor([p for p, _ in POINTS], dtype=torch.int32,
                         device=cuda)
    wrs = torch.tensor([w for _, w in POINTS], dtype=torch.int32,
                       device=cuda)
    frontend = workload.MessFrontend(paces, wrs, cfg.workload_config())
    clock, wcfg = cfg.clock(), cfg.workload_config()
    carry = platform._init_carry(cfg, frontend, len(POINTS), cuda)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        for w in range(cfg.windows):
            fused = platform._bound_inject_fused(cfg, clock, wcfg, frontend,
                                                 carry, w)
            eager = platform._bound_inject_eager(cfg, clock, wcfg, frontend,
                                                 carry, w)
            torch.cuda.synchronize()
            for got, want in zip(fused, eager):
                for g, r in (zip(got, want) if isinstance(got, tuple)
                             else [(got, want)]):
                    assert torch.equal(g, r), f"window {w}"
            carry, _ = platform._window_step(cfg, clock, wcfg, frontend,
                                             carry, w)
    # compared + the loop's own
    assert kernels.launch_counts()["window_inject"] == 2 * cfg.windows
