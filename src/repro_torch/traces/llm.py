"""LLM inference traffic lowered onto the memory platform.

The "serve the planet" workload: per-decode-step HLO memory traffic —
weight streaming, KV-cache reads/writes under continuous batching —
derived from the model configs (`repro_torch.configs`, tinyllama_1_1b
through arctic_480b) and lowered into `repro_torch.traces.Trace`
streams that replay through the DDR4/DDR5/HBM presets.  The port of
the reference's ``traces/llm.py``: everything here is numpy and Python
integers (the lowering is exact, not approximate), and the trace is a
CPU `Trace` that `replay_suite` moves to the card.

The pipeline has three stages:

1. **Render + cost** (`decode_hlo`, `decode_cost`).  For a model
   config at a given pool size and context length, render an
   HLO-shaped text module for ONE continuous-batching decode step —
   an embedding gather, a trip-counted while loop over the stacked
   layers (weights consumed through fused dynamic-slices, exactly how
   a scan-over-layers decode lowers), attention score/context dots
   over the KV cache, dynamic-update-slice cache appends, and the
   vocab-projection dot — and run it through
   `repro_torch.perfmodel.hlo_cost.analyze`.  The renderer mirrors the cost
   model's byte accounting per op, tagged by traffic stream (weights
   / kv_read / kv_write / activations); `decode_cost` *raises* if the
   mirrored total ever disagrees with `analyze`, so the lowering can
   never drift from the HLO cost model it claims to consume.  The
   text targets `analyze`'s grammar (it is not XLA-round-trippable).
2. **Schedule** (`simulate_schedule`).  A host-side continuous-
   batching scheduler built on the *same* `repro_torch.serve.engine.SlotPool`
   admission the model engine uses: requests arrive by a Poisson /
   uniform / burst process, are admitted FIFO into a fixed slot pool,
   force-feed their prompt one token per step, then decode; finished
   slots recycle.  The schedule records per-step occupancy and
   per-slot context — what per-step memory traffic depends on.
3. **Lower** (`lower_decode`, `lower_serving`, `lower_scenario`).
   Byte totals become line-granular accesses.  Real per-step traffic
   is GBs (tens of millions of lines), so the trace models a 1/shard
   slice (one channel/device's share); ``shard`` is returned so byte
   conservation can be checked exactly: per traffic stream, emitted
   lines are the floor of the exact running byte total over the
   quantum ``shard x line_bytes`` (largest-remainder carry), so the
   whole trace conserves bytes to within one line per stream.
   Per-step stream bytes for the serving trace come from an exact
   bilinear model ``c0 + c_n * n_active + c_t * sum(ctx)`` fitted
   from three `decode_cost` anchor evaluations — exact, not
   approximate, because every rendered byte term is linear in the
   pool size and in pool-size x context (`serving_terms`).

Address layout is compact and regional: a weights region re-walked
sequentially every step (streamed layer weights), a KV region scanned
by reads with appends at the write cursor, and a small activation
region — so row locality and read/write mix are representative while
footprints stay far below the 2^31-line traffic address space.

Per-request latency under memory contention comes out the other side:
replay the lowered trace (`repro_torch.traces.replay.replay_suite`)
with ``telemetry=True`` and feed the interface-latency histograms to
`repro_torch.obs.hist_percentiles` (p50/p95/p99), and convert scheduler
steps to milliseconds with `request_latencies_ms` — see
`repro_torch.bench.serving`.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.models.common import ModelConfig
from repro_torch.perfmodel import hlo_cost
from repro_torch.perfmodel.hlo import DTYPE_BYTES
from repro_torch.serve.engine import SlotPool
from repro_torch.traces.trace import Trace, make_trace

#: traffic streams, in per-step emission order
STREAMS = ("weights", "kv_read", "act_rd", "act_wr", "kv_write")
#: reported phases (activation reads+writes fold into one)
PHASES = ("weights", "kv_read", "kv_write", "act")

_DT_NAMES = {torch.bfloat16: "bf16", torch.float32: "f32",
             torch.float16: "f16"}


def _dt_name(dtype) -> str:
    """The HLO element type of a config's torch dtype; an unmapped dtype
    raises (a silent default would render plausible wrong bytes)."""
    try:
        return _DT_NAMES[dtype]
    except KeyError:
        raise ValueError(f"no HLO element type for dtype {dtype!r}; one "
                         f"of {list(_DT_NAMES)}") from None


def _t(dt: str, dims=()) -> str:
    return f"{dt}[{','.join(str(d) for d in dims)}]"


def _nbytes(arr) -> int:
    dt, dims = arr
    n = 1
    for d in dims:
        n *= int(d)
    return n * DTYPE_BYTES[dt]


class _Module:
    """Accumulates rendered computation blocks + a unique-name counter.

    Every ``%name`` in the module is globally unique (the cost model
    keeps ONE module-wide name -> type map)."""

    def __init__(self):
        self.blocks: list[str] = []
        self._uid = 0

    def uid(self) -> int:
        self._uid += 1
        return self._uid

    def render(self) -> str:
        return "\n".join(self.blocks) + "\n"


class _Comp:
    """One computation (entry or while body) under construction.

    Emits op lines in `hlo_cost.analyze`'s grammar and mirrors its
    byte/flop accounting per op as ``(stream, bytes)`` contributions
    in emission order.  References are ``(name, (dtype, dims))``
    pairs; operand bytes always come from the reference's own array
    (matching the cost model's name->type lookup)."""

    def __init__(self, mod: _Module, name: str):
        self.mod = mod
        self.name = name
        self.cond_name = None
        self.lines: list[str] = []
        self.nparam = 0
        self.contribs: list[tuple] = []     # (stream, bytes)
        self.flops = 0.0

    def nm(self, tag: str = "n") -> str:
        return f"{tag}{self.mod.uid()}"

    # -- ops ---------------------------------------------------------------

    def param(self, arr):
        n = self.nm("p")
        self.lines.append(f"  %{n} = {_t(*arr)} parameter({self.nparam})")
        self.nparam += 1
        return (n, arr)

    def gather(self, out, table, idx, rd="weights", wr="act_wr"):
        """Slice-family read: charged 2 x out (read slice + write out)."""
        n = self.nm("g")
        self.lines.append(
            f"  %{n} = {_t(*out)} gather({_t(*table[1])} %{table[0]}, "
            f"{_t(*idx[1])} %{idx[0]}), offset_dims={{1}}")
        b = _nbytes(out)
        self.contribs += [(rd, b), (wr, b)]
        return (n, out)

    def dot(self, out, lhs, rhs, lcd: int, rcd: int,
            s_out="act_wr", s_lhs="act_rd", s_rhs="act_rd"):
        n = self.nm("d")
        self.lines.append(
            f"  %{n} = {_t(*out)} dot({_t(*lhs[1])} %{lhs[0]}, "
            f"{_t(*rhs[1])} %{rhs[0]}), lhs_contracting_dims={{{lcd}}}, "
            f"rhs_contracting_dims={{{rcd}}}")
        self.contribs += [(s_out, _nbytes(out)), (s_lhs, _nbytes(lhs[1])),
                          (s_rhs, _nbytes(rhs[1]))]
        oe = 1
        for d in out[1]:
            oe *= d
        self.flops += 2.0 * oe * lhs[1][1][lcd]
        return (n, out)

    def fusion(self, out, act, slices, idx,
               s_out="act_wr", s_act="act_rd", s_w="weights"):
        """A fused op streaming stacked per-layer weights.

        ``slices`` is a list of ``(stacked_arr, slice_arr)``: each
        stacked weight parameter is consumed by exactly one
        dynamic-slice inside the fusion computation, so the cost
        model's `_fusion_param_charges` charges the per-layer slice,
        not the whole stack — the weight-streaming accounting.
        """
        if len(slices) > 9:
            raise ValueError("fusion supports at most 9 weight slices "
                             "(names must stay prefix-distinct)")
        u = self.mod.uid()
        fname = f"f{u}"
        # fusion computation: params (prefix-distinct names), one
        # dynamic-slice per weight param, a root referencing only the
        # slice results (never the weight params — a second textual
        # use would void the slice charge)
        fl = [f"  %{fname}a = {_t(*act[1])} parameter(0)"]
        for i, (stk, _) in enumerate(slices):
            fl.append(f"  %{fname}w{i} = {_t(*stk)} parameter({i + 1})")
        fl.append(f"  %{fname}i = s32[] parameter({len(slices) + 1})")
        for i, (stk, sl) in enumerate(slices):
            sizes = ",".join(str(d) for d in sl[1])
            fl.append(
                f"  %{fname}s{i} = {_t(*sl)} dynamic-slice({_t(*stk)} "
                f"%{fname}w{i}, s32[] %{fname}i), "
                f"dynamic_slice_sizes={{{sizes}}}")
        s0 = f"{fname}s0"
        fl.append(f"  ROOT %{fname}r = {_t(*out)} add({_t(*slices[0][1])} "
                  f"%{s0}, {_t(*slices[0][1])} %{s0})")
        self.mod.blocks.append(
            f"%{fname} (h{u}a: s32[]) -> {_t(*out)} {{\n"
            + "\n".join(fl) + "\n}")
        # callsite: operand order matches the fusion's param indices
        wps = [self.param(stk) for stk, _ in slices]
        ip = self.param(("s32", ()))
        n = self.nm("fo")
        ops = ", ".join(
            [f"{_t(*act[1])} %{act[0]}"]
            + [f"{_t(*p[1])} %{p[0]}" for p in wps]
            + [f"s32[] %{ip[0]}"])
        self.lines.append(f"  %{n} = {_t(*out)} fusion({ops}), "
                          f"kind=kLoop, calls=%{fname}")
        self.contribs += [(s_out, _nbytes(out)), (s_act, _nbytes(act[1]))]
        self.contribs += [(s_w, _nbytes(sl)) for _, sl in slices]
        self.contribs.append((s_w, _nbytes(ip[1])))      # the s32 index
        _ = idx   # loop index is rendered per-fusion (kept for clarity)
        return (n, out)

    def dus(self, full, update, idx, stream="kv_write"):
        """dynamic-update-slice: charged 2 x update (read + write)."""
        n = self.nm("u")
        self.lines.append(
            f"  %{n} = {_t(*full[1])} dynamic-update-slice("
            f"{_t(*full[1])} %{full[0]}, {_t(*update[1])} %{update[0]}, "
            f"s32[] %{idx[0]})")
        self.contribs.append((stream, 2 * _nbytes(update[1])))
        return (n, full[1])

    def while_loop(self, body: "_Comp", trip: int, x):
        """Glue a finalized while body into this computation."""
        tt = f"({_t(*x[1])})"
        tup, wl, gte = self.nm(), self.nm(), self.nm()
        self.lines.append(f"  %{tup} = {tt} tuple({_t(*x[1])} %{x[0]})")
        self.lines.append(
            f"  %{wl} = {tt} while({tt} %{tup}), "
            f"condition=%{body.cond_name}, body=%{body.name}")
        self.lines.append(f"  %{gte} = {_t(*x[1])} "
                          f"get-tuple-element({tt} %{wl}), index=0")
        return (gte, x[1])

    # -- finalize ----------------------------------------------------------

    def finalize_body(self, trip: int, carry, last_ref):
        """Close a while body: root tuple + matching cond block."""
        tt = f"({_t(*carry)})"
        rn = self.nm()
        self.lines.append(f"  ROOT %{rn} = {tt} tuple("
                          f"{_t(*carry)} %{last_ref[0]})")
        u = self.mod.uid()
        self.cond_name = f"c{u}"
        kn, rn2 = f"k{self.mod.uid()}", f"k{self.mod.uid()}"
        self.mod.blocks.append(
            f"%{self.cond_name} (h{u}c: s32[]) -> pred[] {{\n"
            f"  %{kn} = s32[] constant({trip})\n"
            f"  ROOT %{rn2} = pred[] compare(s32[] %{kn}, s32[] %{kn}), "
            f"direction=LT\n}}")
        self.mod.blocks.append(
            f"%{self.name} (h{u}b: s32[]) -> {tt} {{\n"
            + "\n".join(self.lines) + "\n}")

    def finalize_entry(self, ret):
        self.lines[-1] = self.lines[-1].replace("  %", "  ROOT %", 1)
        u = self.mod.uid()
        self.mod.blocks.append(
            f"ENTRY %{self.name} (h{u}e: s32[]) -> {_t(*ret)} {{\n"
            + "\n".join(self.lines) + "\n}")


# ---------------------------------------------------------------- blocks

def _attn_block(c: _Comp, x, idx, *, B, S, D, HQ, HKV, DH, NL, dt,
                write=True, qkv=True):
    """Decode attention over a (B, S, HKV, DH) cache.

    Weights stream through a fused dynamic-slice (QKV + output
    projections, or Q + output only for cross-attention); the score
    and context dots read the K and V caches once each; the update
    writes one (B, 1, HKV, DH) row per cache (skipped for
    cross-attention, whose context is precomputed).
    """
    G = max(1, HQ // HKV)
    HQD = HQ * DH
    ind = (HQ + 2 * HKV) * DH if qkv else HQD
    q = c.fusion((dt, (B, HKV, G, DH)), x,
                 [((dt, (NL, D, ind)), (dt, (1, D, ind))),
                  ((dt, (NL, HQD, D)), (dt, (1, HQD, D)))], idx)
    kc = c.param((dt, (B, S, HKV, DH)))
    vc = c.param((dt, (B, S, HKV, DH)))
    sc = c.dot((dt, (B, HKV, G, S)), q, kc, 3, 3, s_rhs="kv_read")
    ctx = c.dot((dt, (B, HKV, G, DH)), sc, vc, 3, 1, s_rhs="kv_read")
    if write:
        kf = c.param((dt, (B, S + 1, HKV, DH)))
        vf = c.param((dt, (B, S + 1, HKV, DH)))
        kn = c.param((dt, (B, 1, HKV, DH)))
        vn = c.param((dt, (B, 1, HKV, DH)))
        c.dus(kf, kn, idx)
        c.dus(vf, vn, idx)
    return ctx


def _ffn_block(c: _Comp, x, idx, cfg: ModelConfig, *, B, NL, dt):
    D, F = cfg.d_model, cfg.d_ff
    if F == 0:
        return x
    if cfg.family == "moe" or (cfg.family == "hybrid" and cfg.n_experts):
        E, TK = cfg.n_experts, cfg.top_k
        slices = [((dt, (NL, D, E)), (dt, (1, D, E))),          # router
                  ((dt, (NL, E, D, F)), (dt, (1, TK, D, F))),   # gate
                  ((dt, (NL, E, D, F)), (dt, (1, TK, D, F))),   # up
                  ((dt, (NL, E, F, D)), (dt, (1, TK, F, D)))]   # down
        if cfg.dense_residual:
            slices += [((dt, (NL, D, 2 * F)), (dt, (1, D, 2 * F))),
                       ((dt, (NL, F, D)), (dt, (1, F, D)))]
    else:
        slices = [((dt, (NL, D, 2 * F)), (dt, (1, D, 2 * F))),  # gate+up
                  ((dt, (NL, F, D)), (dt, (1, F, D)))]          # down
    return c.fusion((dt, (B, D)), x, slices, idx)


def _ssm_block(c: _Comp, x, idx, cfg: ModelConfig, *, B, NL, dt):
    """Recurrent-state layer (mamba2 / xlstm): in/out projections
    stream like weights; the state — O(1) in sequence length — is
    gathered (read) and written back whole each step."""
    D, DI = cfg.d_model, cfg.d_inner
    se = DI * cfg.ssm_state + DI * cfg.conv_kernel    # SSD + conv state
    h = c.fusion((dt, (B, DI)), x,
                 [((dt, (NL, D, 2 * DI)), (dt, (1, D, 2 * DI))),
                  ((dt, (NL, DI, D)), (dt, (1, DI, D)))], idx)
    st = c.param((dt, (NL, B, se)))
    c.gather((dt, (B, se)), st, idx, rd="kv_read", wr="act_wr")
    up = c.param((dt, (1, B, se)))
    c.dus(st, up, idx)
    return h


def _render(cfg: ModelConfig, batch: int, ctx_len: int):
    """Render the decode-step module; returns ``(text, prog)``.

    ``prog`` is ``(pre, loops, post, flops)``: entry contributions
    before/after the layer loops and ``[(trip, body_contribs)]`` per
    while loop, all in emission order.
    """
    if batch < 1 or ctx_len < 1:
        raise ValueError(f"batch/ctx_len must be >= 1, got "
                         f"{batch}/{ctx_len}")
    B, S = int(batch), int(ctx_len)
    D, V, NL = cfg.d_model, cfg.vocab, cfg.n_layers
    HQ, HKV, DH = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = _dt_name(cfg.dtype)

    mod = _Module()
    e = _Comp(mod, "serve_decode")
    tok = e.param(("s32", (B, 1)))
    emb = e.param((dt, (V, D)))
    x = e.gather((dt, (B, D)), emb, tok, rd="weights", wr="act_wr")
    pre = list(e.contribs)
    e.contribs = []

    def body(fill):
        b = _Comp(mod, f"b{mod.uid()}")
        bx = b.param((dt, (B, D)))
        bi = b.param(("s32", ()))
        out = fill(b, bx, bi)
        return b, out

    loops = []
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        def self_layers(b, bx, bi):
            h = _attn_block(b, bx, bi, B=B, S=S, D=D, HQ=HQ, HKV=HKV,
                            DH=DH, NL=NL, dt=dt)
            if cfg.family == "audio":
                # enc-dec cross-attention every decoder layer
                h = _attn_block(b, h, bi, B=B, S=cfg.n_ctx_tokens, D=D,
                                HQ=HQ, HKV=HKV, DH=DH, NL=NL, dt=dt,
                                write=False, qkv=False)
            return _ffn_block(b, h, bi, cfg, B=B, NL=NL, dt=dt)
        loops.append((NL, body(self_layers)))
        if cfg.family == "vlm" and cfg.cross_attn_every:
            nc = -(-NL // cfg.cross_attn_every)
            loops.append((nc, body(lambda b, bx, bi: _attn_block(
                b, bx, bi, B=B, S=cfg.n_ctx_tokens, D=D, HQ=HQ, HKV=HKV,
                DH=DH, NL=nc, dt=dt, write=False, qkv=False))))
    elif cfg.family == "ssm":
        loops.append((NL, body(lambda b, bx, bi: _ssm_block(
            b, bx, bi, cfg, B=B, NL=NL, dt=dt))))
    elif cfg.family == "hybrid":
        loops.append((NL, body(lambda b, bx, bi: _ssm_block(
            b, bx, bi, cfg, B=B, NL=NL, dt=dt))))
        nsh = -(-NL // cfg.attn_every)

        def shared(b, bx, bi):
            h = _attn_block(b, bx, bi, B=B, S=S, D=D, HQ=HQ, HKV=HKV,
                            DH=DH, NL=nsh, dt=dt)
            return _ffn_block(b, h, bi, cfg, B=B, NL=nsh, dt=dt)
        loops.append((nsh, body(shared)))
    else:
        raise ValueError(f"unknown model family {cfg.family!r}")

    loop_contribs, flops = [], 0.0
    for trip, (b, out) in loops:
        b.finalize_body(trip, (dt, (B, D)), out)
        x = e.while_loop(b, trip, x)
        loop_contribs.append((trip, b.contribs))
        flops += trip * b.flops

    head = e.param((dt, (D, V)))
    e.dot((dt, (B, V)), x, head, 1, 0, s_rhs="weights")
    post = list(e.contribs)
    flops += e.flops
    e.finalize_entry((dt, (B, V)))
    return mod.render(), (pre, loop_contribs, post, flops)


# ------------------------------------------------------------------ cost

def decode_hlo(cfg: ModelConfig, batch: int, ctx_len: int) -> str:
    """The rendered decode-step HLO text (for inspection / analyze)."""
    return _render(cfg, batch, ctx_len)[0]


def decode_cost(cfg: ModelConfig, batch: int, ctx_len: int) -> dict:
    """Per-decode-step traffic from `hlo_cost.analyze`, by stream.

    Renders the module, analyzes it, and cross-checks the renderer's
    mirrored accounting against the cost model *exactly* — a drifted
    total raises, so the lowering provably consumes `analyze`'s
    numbers.  Returns ``bytes`` / ``flops`` (analyze's trip-scaled
    totals), ``stream_bytes`` / ``phase_bytes`` splits, and
    ``ordered`` — the flattened ``(stream, bytes)`` contributions of
    one decode step in program order (layer loops unrolled).
    """
    text, (pre, loops, post, flops) = _render(cfg, batch, ctx_len)
    got = hlo_cost.analyze(text)
    ordered = list(pre)
    for trip, contribs in loops:
        ordered.extend(contribs * trip)
    ordered.extend(post)
    mine = sum(b for _, b in ordered)
    if int(got["bytes"]) != int(mine):
        raise AssertionError(
            f"renderer/cost-model drift: analyze says {got['bytes']:.0f} "
            f"bytes, mirrored accounting says {mine} "
            f"({cfg.name}, B={batch}, S={ctx_len})")
    if abs(got["flops"] - flops) > 0.5:
        raise AssertionError(
            f"renderer/cost-model flop drift: {got['flops']} vs {flops}")
    stream_bytes = {s: 0 for s in STREAMS}
    for s, b in ordered:
        stream_bytes[s] += b
    phase_bytes = dict(weights=stream_bytes["weights"],
                       kv_read=stream_bytes["kv_read"],
                       kv_write=stream_bytes["kv_write"],
                       act=stream_bytes["act_rd"] + stream_bytes["act_wr"])
    return dict(bytes=int(mine), flops=float(got["flops"]),
                stream_bytes=stream_bytes, phase_bytes=phase_bytes,
                ordered=ordered)


# ------------------------------------------------------------- lowering

class _AddrGen:
    """Regional line-address generator with per-stream byte carries.

    One emitted line stands for ``quantum = shard x line_bytes`` bytes;
    per stream, line counts are the floor-difference of the exact
    cumulative byte total (largest-remainder), so the emitted trace
    conserves modeled bytes to within one line per stream.
    """

    def __init__(self, quantum: int, w_lines: int, kv_lines: int,
                 act_lines: int):
        self.q = quantum
        self.w0, self.wsz = 0, max(64, w_lines)
        self.k0, self.ksz = self.wsz, max(64, kv_lines)
        self.a0, self.asz = self.wsz + self.ksz, max(64, act_lines)
        self.footprint = self.wsz + self.ksz + self.asz
        self.carry = dict.fromkeys(STREAMS, 0)
        self.cur = dict(weights=0, kv_rd=0, kv_wr=0, act=0)
        self.lines: list[np.ndarray] = []
        self.wr: list[np.ndarray] = []

    def new_step(self):
        """Weights and activations re-walk their regions every step."""
        self.cur["weights"] = 0
        self.cur["act"] = 0

    def _take(self, stream: str, nbytes: int) -> int:
        c = self.carry[stream] + int(nbytes)
        n, self.carry[stream] = divmod(c, self.q)
        return n

    def emit(self, stream: str, nbytes: int):
        n = self._take(stream, nbytes)
        if n == 0:
            return
        if stream == "weights":
            base, sz, cur, w = self.w0, self.wsz, "weights", 0
        elif stream == "kv_read":
            base, sz, cur, w = self.k0, self.ksz, "kv_rd", 0
        elif stream == "kv_write":
            # RMW pairs: read + write of each appended line
            k = (n + 1) // 2
            ln = self.k0 + (self.cur["kv_wr"]
                            + np.repeat(np.arange(k), 2)[:n]) % self.ksz
            self.cur["kv_wr"] += k
            self.lines.append(ln.astype(np.int64))
            self.wr.append((np.arange(n) % 2).astype(np.int32))
            return
        else:                                   # act_rd / act_wr
            base, sz, cur, w = self.a0, self.asz, "act", \
                (1 if stream == "act_wr" else 0)
        ln = base + (self.cur[cur] + np.arange(n)) % sz
        self.cur[cur] += n
        self.lines.append(ln.astype(np.int64))
        self.wr.append(np.full(n, w, np.int32))

    def trace(self) -> Trace:
        lines = (np.concatenate(self.lines) if self.lines
                 else np.zeros(0, np.int64))
        if lines.size == 0:
            raise ValueError("lowering produced an empty trace "
                             "(raise target_lines or traffic)")
        wr = np.concatenate(self.wr)
        delta = np.diff(lines, prepend=0).astype(np.int32)
        return make_trace(delta, wr, np.zeros_like(wr), self.footprint)


def _region_lines(q, w_bytes, kv_bytes, act_bytes):
    cap = 1 << 20
    r = lambda b: min(cap, math.ceil(max(b, 1) / q))
    return r(w_bytes), r(kv_bytes), r(act_bytes)


def lower_decode(cfg: ModelConfig, batch: int, ctx_len: int, *,
                 steps: int = 1, target_lines: int = 4096,
                 line_bytes: int = 64):
    """Lower ``steps`` decode steps to a `Trace`; ``(trace, info)``.

    ``info['shard']`` is the byte-to-line scale: the trace models a
    1/shard slice of the step's traffic such that the whole lowering
    stays near ``target_lines`` accesses.  Conservation:
    ``accesses x line_bytes x shard`` equals
    ``decode_cost(...)['bytes'] x steps`` to within
    ``len(STREAMS) x line_bytes x shard``.
    """
    if target_lines < 64:
        raise ValueError("target_lines must be >= 64")
    cost = decode_cost(cfg, batch, ctx_len)
    total = cost["bytes"] * steps
    shard = max(1, math.ceil(total / (line_bytes * target_lines)))
    q = shard * line_bytes
    sb = cost["stream_bytes"]
    gen = _AddrGen(q, *_region_lines(
        q, sb["weights"],
        sb["kv_read"] + sb["kv_write"] * steps,
        sb["act_rd"] + sb["act_wr"]))
    for _ in range(steps):
        gen.new_step()
        for s, b in cost["ordered"]:
            gen.emit(s, b)
    trace = gen.trace()
    info = dict(shard=shard, line_bytes=line_bytes,
                accesses=int(trace.length), bytes_modeled=int(total),
                footprint_lines=gen.footprint,
                stream_bytes={k: int(v * steps) for k, v in sb.items()},
                phase_bytes={k: int(v * steps)
                             for k, v in cost["phase_bytes"].items()})
    return trace, info


# ----------------------------------------------------------- scheduling

@dataclasses.dataclass(frozen=True)
class ServeScenario:
    """One serving cell: a model under an arrival process."""

    model: ModelConfig
    arrival: str = "poisson"        # poisson | uniform | burst
    rate: float = 0.5               # mean request arrivals per step
    n_requests: int = 16
    n_slots: int = 4
    prompt_mean: int = 8
    decode_mean: int = 16
    seed: int = 0


@dataclasses.dataclass
class ServeRequest:
    rid: int
    arrival: int                    # step the request arrived
    total: int                      # prompt + decode tokens
    pos: int = 0                    # tokens in cache (context)
    admit: int = -1                 # step admitted into a slot
    finish: int = -1                # step the last token was produced


@dataclasses.dataclass
class ServeSchedule:
    """Per-step occupancy profile + per-request lifecycle."""

    scenario: ServeScenario
    n_active: np.ndarray            # (T,) slots busy per step
    ctx_sum: np.ndarray             # (T,) sum of per-slot context
    requests: list

    @property
    def steps(self) -> int:
        return len(self.n_active)

    @property
    def latency_steps(self) -> np.ndarray:
        """Per-request arrival-to-completion, scheduler steps."""
        return np.asarray([r.finish - r.arrival + 1 for r in self.requests])

    @property
    def queue_delay_steps(self) -> np.ndarray:
        return np.asarray([r.admit - r.arrival for r in self.requests])


def arrival_steps(scn: ServeScenario) -> np.ndarray:
    """Deterministic arrival process: request -> arrival step."""
    if scn.rate <= 0:
        raise ValueError(f"rate must be > 0, got {scn.rate}")
    rng = np.random.default_rng(scn.seed)
    n = scn.n_requests
    if scn.arrival == "poisson":
        gaps = rng.exponential(1.0 / scn.rate, size=n)
        return np.floor(np.cumsum(gaps)).astype(np.int64)
    if scn.arrival == "uniform":
        return np.floor(np.arange(n) / scn.rate).astype(np.int64)
    if scn.arrival == "burst":
        return np.zeros(n, np.int64)
    raise ValueError(f"unknown arrival process {scn.arrival!r}")


def simulate_schedule(scn: ServeScenario,
                      max_steps: int = 100_000) -> ServeSchedule:
    """Continuous batching on `repro_torch.serve.engine.SlotPool` admission.

    One step = one pooled decode tick (the `Engine` semantics: a
    prompt token force-feeds, a decode token is produced — either way
    the slot's context grows by one).  Finished slots recycle
    immediately; arrivals queue FIFO.
    """
    rng = np.random.default_rng(scn.seed + 1)
    arr = arrival_steps(scn)
    reqs = [ServeRequest(
        rid=i, arrival=int(arr[i]),
        total=max(1, int(rng.poisson(scn.prompt_mean)))
        + max(1, int(rng.poisson(scn.decode_mean))))
        for i in range(scn.n_requests)]
    pool = SlotPool(scn.n_slots)
    t, i = 0, 0
    n_active, ctx_sum = [], []
    while i < len(reqs) or pool.pending():
        while i < len(reqs) and reqs[i].arrival <= t:
            pool.submit(reqs[i])
            i += 1
        for _, r in pool.admit():
            r.admit = t
        act = pool.active()
        n_active.append(len(act))
        ctx_sum.append(sum(r.pos for _, r in act))
        for s, r in act:
            r.pos += 1
            if r.pos >= r.total:
                r.finish = t
                pool.free(s)
        t += 1
        if t >= max_steps:
            raise RuntimeError(
                f"schedule did not drain in {max_steps} steps")
    return ServeSchedule(scenario=scn,
                         n_active=np.asarray(n_active, np.int64),
                         ctx_sum=np.asarray(ctx_sum, np.int64),
                         requests=reqs)


# ----------------------------------------------------- serving lowering

def serving_terms(model: ModelConfig) -> dict:
    """Exact per-step traffic model ``c0 + c_n * n + c_t * ctx_sum``.

    Every rendered byte term is linear in the pool size ``B`` and in
    ``B x S`` (weights constant, activations per-slot, KV per
    slot-token), so three `decode_cost` anchor evaluations determine
    the per-stream coefficients exactly — the scheduler's per-step
    traffic *is* the HLO cost model's, evaluated at that step's
    occupancy.
    """
    B0, S0, S1 = 4, 32, 96
    p00 = decode_cost(model, B0, S0)["stream_bytes"]
    p01 = decode_cost(model, B0, S1)["stream_bytes"]
    p10 = decode_cost(model, 1, S0)["stream_bytes"]
    terms = {}
    for s in STREAMS:
        ct = (p01[s] - p00[s]) / (B0 * (S1 - S0))
        cn = (p00[s] - p10[s] - ct * (B0 - 1) * S0) / (B0 - 1)
        c0 = p10[s] - cn - ct * S0
        terms[s] = (c0, cn, ct)
    return terms


def step_stream_bytes(terms: dict, n_active: int, ctx_sum: int) -> dict:
    """Evaluate the bilinear traffic model at one scheduler step."""
    if n_active <= 0:
        return {s: 0 for s in STREAMS}
    return {s: int(round(max(0.0, c0 + cn * n_active + ct * ctx_sum)))
            for s, (c0, cn, ct) in terms.items()}


def lower_serving(model: ModelConfig, sched: ServeSchedule, *,
                  target_step_lines: int = 512, line_bytes: int = 64):
    """Lower a whole serving schedule to one `Trace`; ``(trace, info)``.

    Each scheduler step contributes its modeled stream bytes (from
    `serving_terms`) in weights -> kv_read -> act -> kv_write order;
    ``info['cum_bytes']`` maps steps to cumulative traffic so replay
    runtime converts to per-request latency (`request_latencies_ms`).
    """
    terms = serving_terms(model)
    per_step = [step_stream_bytes(terms, int(n), int(c))
                for n, c in zip(sched.n_active, sched.ctx_sum)]
    step_tot = np.asarray([sum(p.values()) for p in per_step], np.int64)
    if step_tot.sum() == 0:
        raise ValueError("schedule generated no traffic")
    shard = max(1, math.ceil(step_tot.max()
                             / (line_bytes * target_step_lines)))
    q = shard * line_bytes
    gen = _AddrGen(q, *_region_lines(
        q, max(p["weights"] for p in per_step),
        max(p["kv_read"] for p in per_step)
        + sum(p["kv_write"] for p in per_step),
        max(p["act_rd"] + p["act_wr"] for p in per_step)))
    for p in per_step:
        gen.new_step()
        for s in STREAMS:
            gen.emit(s, p[s])
    trace = gen.trace()
    tot = {s: int(sum(p[s] for p in per_step)) for s in STREAMS}
    info = dict(shard=shard, line_bytes=line_bytes,
                accesses=int(trace.length),
                bytes_modeled=int(step_tot.sum()),
                footprint_lines=gen.footprint,
                stream_bytes=tot,
                phase_bytes=dict(weights=tot["weights"],
                                 kv_read=tot["kv_read"],
                                 kv_write=tot["kv_write"],
                                 act=tot["act_rd"] + tot["act_wr"]),
                step_bytes=step_tot,
                cum_bytes=np.cumsum(step_tot))
    return trace, info


def lower_scenario(scn: ServeScenario, **kw):
    """Scenario -> schedule -> trace; ``(trace, sched, info)``."""
    sched = simulate_schedule(scn)
    trace, info = lower_serving(scn.model, sched, **kw)
    return trace, sched, info


def request_latencies_ms(sched: ServeSchedule, info: dict,
                         runtime_ms: float) -> np.ndarray:
    """Per-request latency under memory contention, milliseconds.

    The replayed ``runtime_ms`` (from `replay_suite`) is the service
    time of the whole schedule's traffic; each step's share is its
    byte fraction, so a request's latency is the service time of
    every step in its arrival..finish span — queueing delay priced at
    the platform's actual (contended) service rate.
    """
    cum = np.concatenate([[0], np.asarray(info["cum_bytes"], np.float64)])
    total = cum[-1]
    t_ms = runtime_ms * cum / total
    return np.asarray([t_ms[r.finish + 1] - t_ms[r.arrival]
                       for r in sched.requests])
