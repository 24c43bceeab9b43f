"""The partitioned dry-run (DTensor over the fake process group) against
the JAX package's partitioned compile, at toy sizes on the CPU.

The reference side runs once for the module, in one subprocess with
512 forced host devices and meshes of ``Auto`` axes
(``tests/_ref_partition.py``: the reference's own ``rules_for``,
``build_cell``, ``jit(...).lower(...).compile()`` and
``hlo_cost.analyze``).  The port's side is `launch.dryrun.partitioned_cell`
counted by `count_step(..., local=True)`: rank 0's local step on meta
shards, each cell in its own fake group, none left behind.

The toy is tinyllama's smoke config widened to d 256, 16 heads (16 KV
heads), d_ff 512, vocab 512, two layers, B 32 x S 128 (B 64 for one
multipod accum-2 cell, so that each microbatch's rows divide its 32
batch ranks; B 32 for another, whose 16 microbatch rows the reference
splits over ``pod`` alone); four GQA cells take 32 query heads and 4
KV heads, fewer than the ``model`` axis, as the production configs do,
and two take 8 heads, too few to split it (the attention's
sequence-parallel fallback, arctic-480b's 56 heads).  The recurrent
families: xlstm-1.3b's smoke config at d 256, 4 heads, vocab 512, one
mLSTM and one sLSTM layer (its 4 heads cannot split the model axis:
the mLSTM's sequence-parallel fallback, the ``state`` split of the
value dims), and zamba2-2.7b's at d 256, 16 heads of 16, d_ff 512,
vocab 512, state 16, two Mamba2 layers and one shared-block
application; each at prefill, train and decode on the pod and a train
step on the multipod, and each family's train step once more at four
layers (two sLSTM segments; zamba2 also at d 512 with two shared-block
applications), so that a term counted per layer, segment or
application is told from one counted once.  The full configs are held
at the pod:
tinyllama-1.1b's prefill_32k, decode_32k and train_4k, xlstm-1.3b's and
zamba2-2.7b's decode_32k.  Per cell:

* per-device FLOPs equal the reference's, counting the dots its cost
  model misses (``fused_dot_flops``: XLA puts the one-row products of
  the multipod decode into fusions, whose bodies ``hlo_cost`` does not
  walk).  Two gaps are reckoned: arctic-style experts' recompute
  (`router_gap`: the combine einsum ``torch.utils.checkpoint``
  recomputes and the router share XLA's recompute leaves out), and
  zamba2's train step, equal to the reference compiled with the port's
  factorisation of the SSD scan's three-operand einsums.  The backward
  products XLA splits over the model axis run so in the port
  (`parallel.axes.einsum`'s ``whole_forward`` / ``whole_grad``: GQA's
  K/V weight gradients, the sequence-parallel output projection,
  zamba2's ``w_cat``; arctic's router on each rank's experts);
* ``args`` per device exact;
* every collective kind the reference issues, the port issues.  DTensor
  has no collective-permute: the reference permutes the int32 token ids
  for its embedding gather (at least one rank's ids); the port moves its
  ids with its own all-gathers; where XLA permutes a weight shard between
  the two axes of the pod, the port moves the same elements by an
  all-to-all (`parallel.axes.transpose_shard`);
* every collective array, kind by kind, equal to the reference's by
  element count on every cell, but for the arrays `reckoned` computes
  from the cell's dims, each with its cause (the train step's softmax
  terms, norm gradients, table gradient, embedding all-to-all and
  hoisted gathers; the permute/all-to-all pairs; GQA's KV-head
  gradients; the sequence-parallel fallback's row gathers; serving's
  norm scales; arctic's routing over the split experts; the recurrent
  families' re-layouts, weight-gather orders and per-step recurrence
  arrays), and for the recurrent families the reference's arrays of
  `RELAYOUT_OPS` (its windowed re-layout of a projection's output cut
  into pieces its blocks do not line up with), which are not held here:
  ``tests/_relayout_gap.py`` measures them against the port's at full
  size.  No cell is held by a band; the cells of `COLLECTIVES_OPEN`
  (one: the two-segment xlstm train step, whose backward XLA partitions
  otherwise than `_xlstm_terms` states) are held in FLOPs and args only.
"""
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys
from collections import Counter

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import registry as cfgs
from repro_torch.configs.registry import get_smoke
from repro_torch.configs.shapes import SHAPES, ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (axis_groups, device_mesh,
                                     make_host_mesh, make_production_mesh,
                                     rules_for)
from repro_torch.models.registry import get_model
from repro_torch.parallel.axes import P, placements

HERE = pathlib.Path(__file__).resolve().parent
TOY = dict(d_model=256, n_heads=16, n_kv_heads=16, d_ff=512, vocab=512)


def _cell(arch="tinyllama-1.1b", kind="train", mesh="pod", accum=1,
          batch=32, serving=False, **cfg):
    return dict(arch=arch, cfg=dict(TOY, **cfg), kind=kind, seq=128,
                batch=batch, mesh=mesh, accum=accum, serving=serving)


CELLS = {
    **{f"{k}-{m}": _cell(kind=k, mesh=m)
       for m in ("pod", "multipod") for k in ("prefill", "train", "decode")},
    "train-accum2-pod": _cell(accum=2),
    "train-accum2-multipod": _cell(mesh="multipod", accum=2, batch=64),
    # 16 microbatch rows for the multipod's 32 batch ranks: the reference
    # splits them over ``pod`` alone and replicates them over ``data``
    "train-accum2-multipod-b32": _cell(mesh="multipod", accum=2, batch=32),
    "decode-opt-pod": _cell(kind="decode", serving=True),
    "moe-ep-pod": _cell(arch="arctic-480b", n_experts=16),
    "moe-tp-pod": _cell(arch="grok-1-314b", n_experts=8),
    # GQA as the production configs have it: 32 query heads, 4 KV heads
    # (too few for the 16-way model axis)
    **{f"gqa-{k}-{m}": _cell(kind=k, mesh=m, n_heads=32, n_kv_heads=4)
       for k, m in (("prefill", "pod"), ("decode", "pod"),
                    ("train", "pod"), ("train", "multipod"))},
    # 8 heads, too few for the model axis: the attention's
    # sequence-parallel fallback (arctic-480b's 56 heads)
    **{f"seqpar-{k}-pod": _cell(kind=k, n_heads=8, n_kv_heads=8)
       for k in ("prefill", "train")},
    # the recurrent families: xlstm's 4 heads (too few for the model
    # axis: the mLSTM's sequence-parallel fallback, the value pin), and
    # zamba2's Mamba2 blocks under one shared attention block
    **{f"{fam}-{k}-{m}": _cell(arch=arch, kind=k, mesh=m, **over)
       for fam, arch, over in (
           ("xlstm", "xlstm-1.3b", dict(n_heads=4, n_kv_heads=4, d_ff=0,
                                        n_layers=2, slstm_every=2)),
           ("zamba2", "zamba2-2.7b", dict(n_layers=2, attn_every=2,
                                          ssm_state=16, ssm_head_dim=16,
                                          d_head=16)))
       for k, m in (("prefill", "pod"), ("train", "pod"), ("decode", "pod"),
                    ("train", "multipod"))},
    # the recurrent train steps at another depth (and, for zamba2, width):
    # two sLSTM segments, two shared-block applications, so that a term
    # counted per layer, per segment or per application is told from one
    # counted once
    "xlstm-train-pod-4l": _cell(arch="xlstm-1.3b", n_heads=4, n_kv_heads=4,
                                d_ff=0, n_layers=4, slstm_every=2),
    "zamba2-train-pod-d512-4l": _cell(arch="zamba2-2.7b", d_model=512,
                                      d_head=32, n_layers=4, attn_every=2,
                                      ssm_state=16, ssm_head_dim=16),
}
#: cells whose collectives `reckoned` does not hold yet, each with why
#: (ROADMAP item 17): their FLOPs and args are held as every cell's
COLLECTIVES_OPEN = {
    "xlstm-train-pod-4l": "with two sLSTM segments XLA keeps its layer "
    "loop and partitions the sLSTM's backward otherwise than in the "
    "one-segment toy `_xlstm_terms` was read from (per step it gathers "
    "the gates' b*4*ds and reduces h's gradient once, not twice)",
}
#: the full configs at registered shapes on the pod
FULL = {**{f"full-{s}": dict(arch="tinyllama-1.1b", shape=s, mesh="pod")
           for s in ("prefill_32k", "decode_32k", "train_4k")},
        **{f"full-{a.split('-')[0]}-decode_32k":
           dict(arch=a, shape="decode_32k", mesh="pod")
           for a in ("xlstm-1.3b", "zamba2-2.7b")}}
#: the zamba2 train cells, compiled once more with the port's
#: factorisation of the SSD scan's einsums (the FLOP gap's cause)
SSD_TWO_OPERAND = {f"{n}+ssd2": dict(c, ssd="two_operand")
                   for n, c in CELLS.items()
                   if c["arch"] == "zamba2-2.7b" and c["kind"] == "train"}
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")


#: every cell the reference compiles, in its subprocess's order
REF_CELLS = {**CELLS, **FULL, **SSD_TWO_OPERAND}


@pytest.fixture(scope="module")
def _ref_proc():
    """The reference's subprocess, started first: it compiles while the
    port counts its cells (`port`)."""
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, str(HERE / "_ref_partition.py"),
         json.dumps(list(REF_CELLS.values()))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref(_ref_proc, port):
    out, err = _ref_proc.communicate(timeout=600)
    assert _ref_proc.returncode == 0, err[-4000:]
    return dict(zip(REF_CELLS, json.loads(out.splitlines()[-1])))


def port_count(cell):
    cfg = dataclasses.replace(get_smoke(cell["arch"]), **cell["cfg"])
    shape = ShapeConfig("toy", cell["kind"], cell["seq"], cell["batch"])
    mesh = make_production_mesh(multi_pod=cell["mesh"] == "multipod")
    with dryrun.partitioned_cell(get_model(cfg), shape, mesh,
                                 serving=cell["serving"],
                                 accum=cell["accum"]) as c:
        out = dryrun.count_step(c, local=True)
    assert not dist.is_initialized()
    return out


@pytest.fixture(scope="module")
def port(_ref_proc):
    """The port's counts, taken while the reference's subprocess
    compiles (`_ref_proc` starts it first)."""
    return {name: port_count(cell) for name, cell in CELLS.items()}


def weighted(rec):
    """The port's collective bytes per kind as the reference moves them
    (bf16 counts twice), and its int64 token-id moves apart."""
    out = dict.fromkeys(KINDS + ("ids",), 0)
    for kind, dtype, n in rec["coll_log"]:
        if dtype in (torch.int64, torch.int32):
            out["ids"] += n
        else:
            out[kind] += 2 * n if dtype == torch.bfloat16 else n
    return out


def router_gap(name):
    """arctic-style, per layer on one rank's (B 2, G 128) tokens: the
    combine einsum that ``torch.utils.checkpoint`` recomputes (it
    recomputes a block in program order up to the last tensor the
    backward needs, the dense residual's operands, where XLA's
    recompute drops the combine), and the router's share (1/16: each
    model rank's experts) that XLA's partitioned recompute leaves out
    (it keeps the forward's logits, where the port's recompute runs the
    router again).  Neither is a fault of either partitioner: each
    recomputes what its own checkpointing policy keeps.  The router's
    other three products (forward and the two of its backward) run on
    each rank's experts in both (`models.moe._router_logits`)."""
    c = CELLS[name]["cfg"]
    b, g, d, e, layers = 2, 128, c["d_model"], c["n_experts"], 2
    router = 2 * b * g * d * e
    cap = max(int(g * 2 * 1.25 / e), 2)
    combine = 2 * b * g * (e // 16) * cap * d
    return layers * (combine + router // 16)


@pytest.mark.parametrize("name", list(CELLS))
def test_flops_and_args_equal_reference(ref, port, name):
    """Per-device FLOPs equal the reference's but for two reckoned gaps:
    arctic-style experts' recompute (`router_gap`), and zamba2's train
    step, whose SSD scan the reference writes with three-operand
    einsums that XLA differentiates into other products than the port's
    two-operand ones: compiled with the port's factorisation
    (``tests/_ref_partition.py``'s ``ssd="two_operand"``), the counts
    are equal (the host count's same gap, ``tests/test_torch_dryrun.py``).
    xlstm's sLSTM step runs its product with both gradients computed
    (`parallel.axes.contract`), as the reference's scan transpose does
    into the zero initial state, so the host count's gap is not there."""
    r, p = ref[name], port[name]
    want = r["flops"] + r["fused_dot_flops"]
    if name == "moe-ep-pod":
        want += router_gap(name)
    if f"{name}+ssd2" in ref:
        two = ref[f"{name}+ssd2"]
        assert p["flops"] == two["flops"] + two["fused_dot_flops"], name
        assert p["flops"] != want and abs(p["flops"] / want - 1) < 1e-3
        want = p["flops"]
    assert p["flops"] == want, (name, p["flops"], want)
    assert p["args"] == r["args"], name


def _cell_info(name):
    """A cell of `CELLS` or `FULL` as ``dict(arch, cfg, kind, seq, batch,
    mesh, accum, serving)``, ``cfg`` every field of its config."""
    if name in CELLS:
        c = CELLS[name]
        cfg = dataclasses.replace(get_smoke(c["arch"]), **c["cfg"])
        return dict(c, cfg=dataclasses.asdict(cfg))
    c = FULL[name]
    shape = SHAPES[c["shape"]]
    return dict(arch=c["arch"], mesh=c["mesh"], accum=1, serving=False,
                cfg=dataclasses.asdict(cfgs.get_config(c["arch"])),
                kind=shape.kind, seq=shape.seq_len, batch=shape.global_batch)


@pytest.mark.parametrize("name", list(FULL))
def test_full_tinyllama_flops_and_args_equal_reference(ref, name):
    """The full configs at full width and depth: the per-device FLOPs and
    args of tinyllama-1.1b's pod prefill, decode and train step and of
    xlstm-1.3b's and zamba2-2.7b's pod decode equal the reference's
    partitioned compile's; tinyllama's prefill all-reduces too (bf16
    counting twice), and the recurrent decodes' collectives array by
    array (`_hold_collectives`: what tells them from the ideal
    partition, whose FLOPs and args are the same)."""
    c = FULL[name]
    cfg, shape = cfgs.get_config(c["arch"]), SHAPES[c["shape"]]
    rec = dryrun.cell_record(cfg, shape, "pod")
    r = ref[name]
    assert rec["partition"] == "dtensor"
    assert rec["hlo_flops_dev"] == r["flops"] + r["fused_dot_flops"]
    assert rec["memory_analysis"]["args"] == r["args"]
    if name == "full-prefill_32k":
        assert 2 * rec["collectives"]["bytes_by_op"]["all-reduce"] == \
            r["full_bytes_by_op"]["all-reduce"]
    if c["arch"] in RECURRENT:
        with dryrun.partitioned_cell(get_model(cfg), shape,
                                     make_production_mesh()) as cell:
            count = dryrun.count_step(cell, local=True)
        assert count["collectives"] == rec["collectives"]
        _hold_collectives(ref, name, count)


def _dims(name):
    """The cell's dims: ``a`` microbatches of ``b`` rows a batch rank
    (``B`` rows a microbatch), sequence ``S``, width ``d``, vocab ``V``,
    FFN width ``F``, ``L`` layers, ``H`` heads of ``hd``, ``KV`` KV heads,
    ``M`` model ranks, ``R`` batch ranks (which also split the embed dim;
    a microbatch too small for them is split over ``pod`` alone)."""
    c = _cell_info(name)
    cfg = c["cfg"]
    R = 32 if c["mesh"] == "multipod" else 16
    B = c["batch"] // c["accum"]
    H = cfg["n_heads"]
    return dict(a=c["accum"], B=B, b=B // R if B % R == 0 else B // 2,
                S=c["seq"], T=1 if c["kind"] == "decode" else c["seq"],
                d=cfg["d_model"], V=cfg["vocab"],
                F=cfg["d_ff"], L=cfg["n_layers"], H=H,
                KV=cfg["n_kv_heads"], hd=cfg["d_head"] or cfg["d_model"] // H,
                M=16, R=R,
                square=c["mesh"] == "pod", kind=c["kind"])


#: the families whose blocks are recurrent (xlstm-1.3b, zamba2-2.7b)
RECURRENT = ("xlstm-1.3b", "zamba2-2.7b")


def _zamba2_terms(D, cfg, train, ref, port):
    """zamba2's arrays (see `reckoned`)."""
    b, T, d, L, M, R = (D[k] for k in ("b", "T", "d", "L", "M", "R"))
    n, hp, k = cfg["ssm_state"], cfg["ssm_head_dim"], 4
    d_in = 2 * d
    h = d_in // hp
    conv = d_in + 2 * n
    cols = 2 * d_in + 2 * n + h
    passes = 2 if train else 1
    # B and C gathered by XLA for the scan; the port's re-layouts of the
    # in-projection's and the conv's outputs (`models.mamba2._pieces`:
    # each rank's share of z, of the conv's channels and of dt, then
    # its heads' x and B, C whole), whose backward returns rank 0's
    # blocks' gradients (its block lies in z and in x)
    ref["all-gather"] += [b * T * n] * 2 * L * passes
    port["all-to-all"] += [b * T * (d_in + conv + h) // M,
                           b * T * (d_in // M + 2 * n)] * L * passes
    if D["square"]:
        # w_cat's shard permuted to the model axis at each application
        # of the shared block (and its gradient back): the same
        # elements by an all-to-all in the port
        w = [2 * d // R * d] * (L // cfg["attn_every"]) * (2 if train else 1)
        ref["collective-permute"] += w
        port["all-to-all"] += w
    if not train:
        return
    port["all-to-all"] += [b * T * cols // M, b * T * conv // M] * L
    ref["all-reduce"] += [d] * L + [d_in // M] * L + \
        [conv // M] * (k + 1) * L + [h // M] * 3 * L + [b * T * n] * 2 * L
    port["all-reduce"] += [L * d, L * d_in // M, L * k * conv // M,
                           L * conv // M] + [h] * 3 * L
    ref["all-gather"] += [L * h] * 9
    port["all-gather"] += [h] * 3 * L
    # the shared block's two norm weights: XLA reduces their gradients
    # at each application, the port once (autograd sums the
    # applications' first)
    ref["all-reduce"] += [d] * 2 * (L // cfg["attn_every"])
    port["all-reduce"] += [d] * 2


def _xlstm_terms(D, cfg, kind, ref, port):
    """xlstm's arrays (see `reckoned`)."""
    b, T, d, L, M, R = (D[k] for k in ("b", "T", "d", "L", "M", "R"))
    h = cfg["n_heads"]
    d_in, ds = 2 * d, d                 # the mLSTM's and sLSTM's widths
    dh, dhs = d_in // h, ds // h
    n_s = L // cfg["slstm_every"]       # sLSTM layers
    n_m = L - n_s
    decode = kind == "decode"
    passes = 2 if kind == "train" else 1
    # the mLSTM's up-projection output re-laid for q/k/v (and z)
    port["all-gather"] += [b * T * 2 * d_in] * n_m * passes
    ref["all-gather"] += ([b * d_in, b * dh] if decode else
                          [b * T * d_in, b * T * dh]) * n_m
    if decode:
        # (z, gathered for every layer at once before XLA's layer scan)
        ref["all-gather"] += [n_m * b * d_in]
    if not decode:
        # the weights gathered whole for the rows' products: XLA gathers
        # the output projections' over the data axes first (``/M``),
        # w_x's over ``model`` first (``/R``), the port the other way
        ref["all-gather"] += [h * dh * d // M, h * dh * d] * n_m + \
            [ds * d // M, ds * d] * n_s + [d * 4 * ds // R, d * 4 * ds] * n_s
        port["all-gather"] += [h * dh * d // R, h * dh * d] * n_m + \
            [ds * d // R, ds * d] * n_s + [d * 4 * ds // M, d * 4 * ds] * n_s
    if decode:
        ref["all-reduce"] += [b * h] * n_m
        ref["all-to-all"] += [b * d_in // M] * n_m
        ref["collective-permute"] += [b * d_in // M] * n_m
        if D["square"]:
            ref["collective-permute"] += [d // R * h * 2] * n_m
            port["all-to-all"] += [d // R * h * 2] * n_m
    else:
        ref["all-gather"] += [b * T * h] * 2 * n_m * passes
        port["all-gather"] += [b * T * h * 2] * n_m * passes
    # the sLSTM: XLA gathers each step's h twice (for the recurrent
    # product and for the stacked output) and one head's share of it
    ref["all-gather"] += [b * dhs] * T * n_s
    ref["collective-permute"] += [b * 4 * ds // M] * T * n_s
    if decode:
        port["all-gather"] += [b * 4 * ds] * n_s
        ref["all-to-all"] += [b * 4 * ds // M] * n_s
    else:
        ref["all-gather"] += [b * ds] * T * n_s
        ref["all-to-all"] += [T * b * 4 * ds // M] * n_s
        port["all-gather"] += [4 * ds] * n_s
    if kind == "train":
        # the sLSTM's backward, per step: XLA's mirrors the forward's
        # gathers and re-layout, reduces the h gradient's partial sums
        # twice and the recurrent weights' and the bias's gradient shares
        # every step; the port reduce-scatters the h gradient onto its
        # share, and reduces the stacked recurrent weights' gradient
        # once and each layer's bias gradient once
        rh = h * dhs * 4 * dhs // M
        ref["all-gather"] += [b * dhs, b * ds] * T * n_s
        ref["collective-permute"] += [b * 4 * ds // M] * T * n_s
        ref["all-reduce"] += [b * ds, b * ds, rh, 4 * ds // M] * T * n_s
        port["reduce-scatter"] += [b * ds // M] * T * n_s
        port["all-reduce"] += [n_s * rh] + [4 * ds] * n_s
        port["all-gather"] += [4 * ds] * n_s
        # in its recompute XLA gathers the up-projection's weight whole
        # (over ``model``, then the data axes) and q/k/v's whole, but not
        # w_o over ``model``, the port w_o as in its forward and the
        # up-projection's over the data axes; in the backward XLA
        # regathers w_x's and w_o's first shares and the head
        ref["all-gather"] += [h * dh * d // M] * n_m + \
            [d * 4 * ds // M] * n_s + \
            [d * 2 * d_in // R, d * 2 * d_in] * n_m + \
            [h * dh * dh] * 3 * n_m + [d * D["V"] // M]
        port["all-gather"] += [h * dh * d // R, h * dh * d] * n_m + \
            [d * 2 * d_in // M] * n_m
        # and it gathers the gates' cumulative sums thrice more, the rows
        # once more, xh in its layout twice (forward and recompute) and
        # k once more in the backward
        ref["all-gather"] += [b * T * h] * 3 * n_m + [b * T * d] + \
            [b * T * d_in] * 3 * n_m
        # re-layouts in the backward: XLA moves the input contributions'
        # slices (``T*b*ds/M``) and k's and v's gradients by all-to-alls,
        # the port reduce-scatters k's and v's onto the value split; the
        # port's recompute moves q to the rows again
        ref["all-to-all"] += [T * b * ds // M] * n_s + \
            [b * T * h * dh // M] * 2 * n_m
        port["all-to-all"] += [b * T * h * dh // M] * n_m
        port["reduce-scatter"] += [b * T * h * dh // M] * 2 * n_m
        # the weights' gradients: XLA reduces each whole over each axis
        # (the output projections', the up-projection's; q/k/v's over
        # ``model``, computed whole after its recompute's gathers), the
        # port reduce-scatters them (w_x's it reduces whole over
        # ``model``: the rows' partial sums, where XLA reduces its
        # ``state`` share over the batch ranks); the gates' gradients
        # XLA reduces over ``model`` (``b*T*h``, twice), the port
        # reduce-scatters them onto the rows; XLA reduces xh's partial
        # gradients twice, the port thrice
        ref["all-reduce"] += [ds * d] * 2 * n_s + [h * dh * d] * 2 * n_m + \
            [2 * d_in * d] * 2 * n_m + [h * dh * dh] * 3 * n_m + \
            [4 * ds // M * d] * n_s + [b * T * h] * 2 * n_m + \
            [b * T * d_in] * 2 * n_m
        port["reduce-scatter"] += [ds * d // R, ds * d // (M * R)] * n_s + \
            [h * dh * d // R, h * dh * d // (M * R)] * n_m + \
            [b * T * h * 2 // M] * n_m
        port["all-reduce"] += [d * 2 * d_in // M] * n_m + \
            [d * 4 * ds] * n_s + [b * T * d_in] * 3 * n_m
        # the gates and the sLSTM's input projection run on each model
        # rank's rows: XLA reduces each layer's gradients of the norms
        # before them (and the final one's) over the batch ranks and
        # over ``model``, and the input gate's bias's twice and its
        # weight's (its ``d/R`` share), the port each stacked leaf once
        # (the mLSTM norms, the sLSTM norms, the final norm, the gate
        # biases); the port's backward of the up-projection output's
        # gather reduce-scatters it onto the columns (XLA's inverse of
        # its split, not held)
        ref["all-reduce"] += [d] * 2 * (n_m + n_s + 1) + \
            [h * 2] * 2 * n_m + [d // R * h * 2] * n_m
        port["all-reduce"] += [n_m * d, n_s * d, d, n_m * h * 2]
        port["reduce-scatter"] += [b * T * 2 * d_in // M] * n_m


def reckoned(name):
    """``(ref_only, port_only)``: for each collective kind, the arrays
    (by element count) that one partitioner moves and the other does
    not, each computed from the cell's dims (`_dims`) with its cause:

    * train, per microbatch: XLA's backward all-reduces two more
      per-position terms of the vocab-split softmax (``b*S`` each;
      autograd keeps the forward's); it reduces each layer's two norm
      weights' gradients in its layer scan (``2L`` arrays of ``d``),
      the port each stacked norm leaf (2 of ``L*d``: the same
      elements); it all-reduces the embedding table's gradient whole
      over ``model`` and slices it (``V*d/R``), DTensor reduce-scatters
      it (``V*d/(R*M)``); and its backward all-to-all of the embedding's
      rows carries the whole sequence (``b*S*d``) before it drops the
      other model ranks' rows, DTensor's its ``S/M`` rows
      (``b*S*d/M``);
    * train with ``a > 1``: XLA gathers the table and the head once a
      step, outside its microbatch loop; the port per microbatch
      (``a - 1`` more of each, ``V*d/R`` and ``d*V/M``);
    * a microbatch too small for the batch ranks (``B < R``: its rows
      split over ``pod`` alone): XLA splits the loss's rows further (5
      per-position arrays of ``S`` a microbatch against the port's 3 of
      ``b*S``, in place of the two above); it gathers the embedding's
      rows' vocab mask (``b*S*d``) beside the rows, which the port
      moves once more over ``pod`` by an all-to-all (``b*S*d``; its
      backward ``b*S*d/M``, where XLA reduces the table's gradient and
      permutes its shard, ``V*d/(R*M)``, once more outside the loop),
      and one row's width twice (``S*d``) where the port gathers the
      rows' width over ``model`` (``b*S*d/M``);
    * GQA with fewer KV heads than model ranks: on the pod XLA permutes
      each layer's K and V weight shards (``d/R*KV*hd``) to the model
      axis, in the forward (and the recompute) and their gradients back
      in the backward, where the port moves the same elements by an
      all-to-all (`parallel.axes.transpose_shard`: one kind for
      another); in the backward it reduces each KV head's gradient over
      the model ranks that read it (``b*S*hd``) and gathers the heads
      (``b*S*KV*hd``), the port all-reduces the whole gradient over
      ``model`` (``b*S*KV*hd``); at decode it also gathers one KV head's
      queries (``b*H/KV*hd``) and reduces the P.V product twice
      (``b*H*hd``);
    * the sequence-parallel fallback (heads too few for the model
      axis): XLA keeps the residual stream's rows split over ``model``
      between layers and gathers them for each product that reads them
      (the q/k/v projections, the residual add, the FFN: 3 a layer, and
      the logits' 1) and gathers k and v (2 a layer); the port gathers
      q, k, v and the attention's rows (4 a layer), each ``b*S*d``; XLA
      permutes one of the four attention weights' shards to the model
      axis (``d/R*H*hd``: the forward, and the recompute and the
      gradient in a train step).  In its train step XLA gathers the rows
      5 times a layer in the forward, 6 in the backward and the logits'
      once in each (``11L + 2``), the port 4 in the forward, 4 in the
      recompute and 2 in the backward (``10L``); XLA also regathers the
      FFN's gate and up weights in the backward and the head (``d*F/M``:
      ``2L + 1``), reduces the norm weights' gradients over ``model``
      too (``2L + 1`` of ``d``), the permuted weight's gradient block by
      block (4 of ``d/R*H*hd`` a layer, where the port reduces it
      whole, ``d*H*hd``), and re-lays the projections' input gradient
      by an all-to-all (``b*S*d/M`` a layer);
    * arctic-style experts (the experts split the model axis; groups of
      ``G = S`` tokens, capacity ``C``), a train step: XLA routes on the
      experts split over ``model``, so the softmax's and each top-k
      round's reductions are all-reduced per token (``b*G``: 16 a layer
      over the forward, the recompute and the backward) and it gathers
      the gates twice a pass (``b*G*E``: 4 a layer); the port gathers
      the router's logits once a pass (2 a layer) and routes on every
      rank, slicing the dispatch and combine weights to its experts,
      whose gradient it then gathers (``b*G*E*C`` a layer) with the
      router's (``d*E`` a layer), where XLA updates the replicated
      router (its parameter and two moments) on each rank's experts and
      gathers the three (``L*d*E``); ``torch.utils.checkpoint``
      recomputes the combine einsum (the FLOP gap below) and reduces
      its partial sums once more (``b*G*d`` a layer);
    * the serving rules' decode: XLA normalises each row where it lies
      and gathers its scale for the embed-split copy (``B`` twice a
      layer), and permutes the FFN's hidden shares between the two
      axes (``B*F/(R*M)`` a layer), where the port moves the same
      elements by an all-to-all;
    * the recurrent families (`_zamba2_terms`, `_xlstm_terms`, each
      array with its cause there): the port's re-layouts of a
      projection's output, XLA's gathers of what its windowed
      re-layouts leave split, the order in which each partitioner
      gathers a weight over the two axes, the per-layer against the
      stacked reductions of small parameters' gradients, and the sLSTM's
      per-step arrays.
    """
    D = _dims(name)
    a, b, B, S, d, V, F, L = (D[k] for k in "abBSdVFL")
    H, KV, hd, M, R = (D[k] for k in ("H", "KV", "hd", "M", "R"))
    c = _cell_info(name)
    ref, port = {k: [] for k in KINDS + ("collective-permute",)}, \
        {k: [] for k in KINDS}
    train = c["kind"] == "train"
    if train and B >= R:
        ref["all-reduce"] += a * [b * S] * 2
        ref["all-to-all"] += a * [b * S * d]
        port["all-to-all"] += a * [b * S * d // M]
    if train:
        ref["all-reduce"] += a * [V * d // R]
        port["reduce-scatter"] += a * [V * d // (R * M)]
    if train and c["arch"] not in RECURRENT:
        ref["all-reduce"] += a * [d] * 2 * L
        port["all-reduce"] += a * [L * d] * 2
        port["all-gather"] += (a - 1) * [V * d // R, d * V // M]
    if train and B < R:
        ref["all-reduce"] += a * [S] * 5
        port["all-reduce"] += a * [b * S] * 3
        ref["all-gather"] += a * ([b * S * d] + [S * d] * 2)
        port["all-gather"] += a * [b * S * d // M]
        port["all-to-all"] += a * [b * S * d, b * S * d // M]
        ref["collective-permute"] += (a + 1) * [V * d // (R * M)]
    recurrent = c["arch"] in RECURRENT
    if KV < M <= H and not recurrent:
        w = d // R * KV * hd
        passes = 3 * a if train else 1
        if D["square"]:
            ref["collective-permute"] += 2 * L * passes * [w]
            port["all-to-all"] += 2 * L * passes * [w]
        if train:
            ref["all-reduce"] += a * 2 * L * [b * S * hd]
            ref["all-gather"] += a * 2 * L * [b * S * KV * hd]
            port["all-reduce"] += a * 2 * L * [b * S * KV * hd]
        if c["kind"] == "decode":
            ref["all-gather"] += L * [b * H // KV * hd]
            ref["all-reduce"] += L * [b * H * hd]
    if H < M and not recurrent:
        rows = b * S * d
        ref["collective-permute"] += (3 if train else 1) * L * [
            d // R * H * hd]
        ref["all-gather"] += [rows] * (11 * L + 2 if train else 5 * L + 1)
        port["all-gather"] += [rows] * (10 * L if train else 4 * L)
        if train:
            ref["all-gather"] += [d * F // M] * (2 * L + 1)
            ref["all-reduce"] += [d] * (2 * L + 1) + \
                [d // R * H * hd] * 4 * L
            port["all-reduce"] += [d * H * hd] * L
            ref["all-to-all"] += [rows // M] * L
    E = c["cfg"].get("n_experts", 0)
    if train and E and E % M == 0:
        G, C = S, max(int(S * 2 * 1.25 / E), 2)
        ref["all-reduce"] += [b * G] * 16 * L
        ref["all-gather"] += [b * G * E] * 4 * L + [L * d * E] * 3
        port["all-gather"] += [b * G * E] * 2 * L + [d * E] * L + \
            [b * G * E * C] * L
        port["all-reduce"] += [b * G * d] * L
    if c["arch"] == "zamba2-2.7b":
        _zamba2_terms(D, c["cfg"], train, ref, port)
    if c["arch"] == "xlstm-1.3b":
        _xlstm_terms(D, c["cfg"], c["kind"], ref, port)
    if c["serving"]:
        ref["all-gather"] += [B] * 2 * L
        ref["collective-permute"] += [B * F // (R * M)] * L
        port["all-to-all"] += [B * F // (R * M)] * L
    return ref, port


def _elements(arrays):
    """Per kind, a Counter of the float arrays' element counts (0-d
    arrays apart, under ``"scalars"``); integer arrays (token ids) are
    left out."""
    out = {k: Counter() for k in KINDS + ("collective-permute",
                                          "scalars")}
    for kind, dtype, n, runs in arrays:
        if dtype in ("s32", "int32", "int64"):
            continue
        out["scalars" if n == 1 and kind == "all-reduce" else kind][n] += \
            runs
    return out


def ref_elements(rec):
    def size(dims):
        return math.prod(int(x) for x in dims.split(",")) if dims else 1
    return _elements([(k, t, size(d), runs) for k, t, d, runs, _
                      in rec["arrays"]])


def port_elements(rec):
    return _elements([(k, str(t).replace("torch.", ""), n // t.itemsize, 1)
                      for k, t, n in rec["coll_log"]])


@pytest.mark.parametrize("name", [n for n in CELLS
                                  if n not in COLLECTIVES_OPEN])
def test_collective_kinds_and_bytes_against_reference(ref, port, name):
    """Every collective array equals the reference's, kind by kind, by
    element count (`_hold_collectives`), on every cell but those of
    `COLLECTIVES_OPEN`."""
    _hold_collectives(ref, name, port[name])


#: XLA's ops whose collectives re-lay a dim cut into pieces its blocks
#: do not line up with: the recurrent families' projection outputs
#: (Mamba2's in-projection, 1088 columns in blocks of 68, cut into z,
#: x, B, C and dt; the mLSTM's up-projection cut into its two halves)
#: and the conv's concatenated input.  XLA moves the windows where a
#: piece's blocks and the source's overlap, by collective-permutes that
#: group (source, target) pairs by transfer size (or all-to-alls), which
#: `reckoned` does not compute, so these arrays are not held; the port's
#: counterparts (`models.mamba2._pieces`' all-to-alls, the mLSTM's
#: up-projection gathered whole over ``model``, and their backward) it
#: does.  ``tests/_relayout_gap.py`` sets the two against each other at
#: full size.
RELAYOUT_OPS = ("split", "concatenate")


def _hold_collectives(ref, name, count):
    """XLA's CPU compile carries every product and collective in f32, the
    port its bf16 products in bf16: elements, not bytes, are the common
    measure.  Every array equals the reference's, kind by kind, but for
    the arrays `reckoned` states, and for the recurrent families the
    reference's `RELAYOUT_OPS`.  An all-to-all's tuple of chunks counts
    as one total.  Left out: the token ids (integers: the reference
    permutes its int32 ids, at least one rank's, the port gathers its
    own) and 0-d all-reduces (XLA reduces each leaf's squared norm and
    the loss's terms apart, 15-29 scalars; the port one sum, the global
    norm's)."""
    r, w = ref[name]["full_bytes_by_op"], weighted(count)
    cell = _cell_info(name)
    ranks = 32 if cell["mesh"] == "multipod" else 16
    ids = max(cell["batch"] // ranks, 1) * (
        1 if cell["kind"] == "decode" else cell["seq"]) * 4
    assert r["collective-permute"] >= ids, (name, r)
    assert w["ids"] > 0, name
    for kind, n in r.items():
        if kind != "collective-permute":
            assert w[kind] > 0, (name, kind)
    arrays = ref[name]["arrays"]
    if cell["arch"] in RECURRENT:
        arrays = [a for a in arrays if a[4] not in RELAYOUT_OPS]
    re_, pe = ref_elements(dict(ref[name], arrays=arrays)), \
        port_elements(count)
    ref_only, port_only = reckoned(name)
    for kind in KINDS:
        want = re_[kind] + Counter(port_only[kind])
        got = pe[kind] + Counter(ref_only[kind])
        if kind == "all-to-all":
            want, got = sum(k * v for k, v in want.items()), \
                sum(k * v for k, v in got.items())
        assert got == want, (name, kind, got, want)
    assert re_["collective-permute"] == Counter(
        ref_only["collective-permute"]), (name, re_["collective-permute"])
    train = cell["kind"] == "train"
    assert pe["scalars"] == (Counter({1: 1}) if train else Counter()), name
    assert sum(re_["scalars"].values()) >= train, name


def test_the_toy_product_counts_local_flops():
    """(4096 x 1024) @ (1024 x 4096) on the 16 x 16 pod, rows over data,
    columns over model: rank 0's product is 256 x 1024 x 256."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    mesh = make_production_mesh()
    with device_mesh(mesh, "cuda") as dm:
        a = DTensor.from_local(torch.zeros(256, 1024, device="meta"), dm,
                               placements(P("data"), dm), run_check=False)
        b = DTensor.from_local(torch.zeros(1024, 256, device="meta"), dm,
                               placements(P(None, "model"), dm),
                               run_check=False)
        with implicit_replication(), \
                dryrun.StepCounter(local=True) as counter:
            y = a @ b
    assert counter.flops == 134_217_728
    assert tuple(y.shape) == (4096, 4096)
    assert sum(counter.coll_counts.values()) == 0
    assert not dist.is_initialized()


@pytest.mark.parametrize("eq,x_shape,w_shape,dim", [
    ("bsd,dhk->bshk", (2, 1, 256), (256, 8, 32), 2),
    ("bshk,hkd->bsd", (2, 1, 32, 8), (32, 8, 256), 2)])
def test_split_contraction_splits_the_weights_contracted_dim(
        eq, x_shape, w_shape, dim):
    """A decode-sized activation and a weight both whole over a mesh dim
    are split there along w's first dim and the x dim ``eq`` contracts
    it with (for the attention output: the heads, not the head dim)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.models.common import _split_contraction
    mesh = make_production_mesh()
    with device_mesh(mesh, "cuda") as dm:
        def whole(shape):
            return DTensor.from_local(torch.zeros(shape, device="meta"), dm,
                                      [Replicate(), Replicate()],
                                      run_check=False)
        x, w = _split_contraction(whole(x_shape), whole(w_shape), eq)
        assert list(x.placements) == [Shard(dim), Replicate()]
        assert list(w.placements) == [Shard(0), Replicate()]
    assert not dist.is_initialized()


def test_device_mesh_groups_and_teardown():
    pod, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert axis_groups(multi, rules_for(multi)) == [("pod", "data"),
                                                    ("model",)]
    assert axis_groups(multi, rules_for(multi, serving=True)) == [
        ("pod",), ("data",), ("model",)]
    assert axis_groups(pod, rules_for(pod)) == [("data",), ("model",)]
    with device_mesh(multi, "cpu", rules_for(multi)) as dm:
        assert dm.mesh_dim_names == ("pod_data", "model")
        assert tuple(dm.shape) == (32, 16)
        pl = placements(P(("pod", "data"), None, "model"), dm)
        assert [str(p) for p in pl] == ["S(0)", "S(2)"]
        with pytest.raises(ValueError, match="whole runs"):
            placements(P("data"), dm)
    assert not dist.is_initialized()
    with device_mesh(make_host_mesh("cpu")) as dm:
        assert tuple(dm.shape) == (1,)
    assert not dist.is_initialized()
