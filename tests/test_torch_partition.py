"""The partitioned dry-run (DTensor over the fake process group) against
the JAX package's partitioned compile, at toy sizes on the CPU.

The reference side runs once for the module, in one subprocess with
512 forced host devices and meshes of ``Auto`` axes
(``tests/_ref_partition.py``: the reference's own ``rules_for``,
``build_cell``, ``jit(...).lower(...).compile()`` and
``hlo_cost.analyze``; for zamba2 also the bare Mamba2 block's re-layouts
at the cell's dims, ``relayouts``).  The port's side is
`launch.dryrun.partitioned_cell` counted by `count_step(...,
local=True)`: rank 0's local step on meta shards, each cell in its own
fake group, none left behind.

The toy is tinyllama's smoke config widened to d 256, 16 heads (16 KV
heads), d_ff 512, vocab 512, two layers, B 32 x S 128 (B 64 for one
multipod accum-2 cell, so that each microbatch's rows divide its 32
batch ranks; B 32 for another, whose 16 microbatch rows the reference
splits over ``pod`` alone); four GQA cells take 32 query heads and 4
KV heads, fewer than the ``model`` axis, as the production configs do,
and six take 8 heads, too few to split it (the attention's
sequence-parallel fallback, arctic-480b's 56 heads): prefill and train
on the pod, train at one row a rank on each mesh, and prefill and train
over 2,048 rows (B 16), longer than one attention chunk; and arctic's
own shape over those rows (8 heads over 4 KV heads, 16 experts split
over the model axis), prefill and train.  The recurrent
families: xlstm-1.3b's smoke config at d 256, 4 heads, vocab 512, one
mLSTM and one sLSTM layer (its 4 heads cannot split the model axis:
the mLSTM's sequence-parallel fallback, the ``state`` split of the
value dims; and its prefill and train step over 2,048 rows (B 16), two
mLSTM query chunks, past which the gates and the projections run on
the whole rows), and zamba2-2.7b's at d 256, 16 heads of 16, d_ff 512,
vocab 512, state 16, two Mamba2 layers and one shared-block
application; each at prefill, train and decode on the pod and a train
step on the multipod, and each family's train step once more deeper
(xlstm at two and three sLSTM segments; zamba2 at d 512 with two
shared-block applications), so that a term counted per layer, segment
or application is told from one counted once.  The cross-attention
families: whisper-large-v3's smoke config at d 320, 20 heads of 16 (20
does not divide the model axis: the sequence-parallel fallback), d_ff
640, vocab 518 (does not divide 16, as 51,866 does not), two encoder
and two decoder layers over 64 frames, and once more at three decoder
layers over one encoder layer, and its prefill and train step over
2,048 tokens and 1,500 frames (B 16); llama-3.2-vision-11b's at the toy widths
with 32 query heads over 4 KV heads and a gated cross block every
second of 4 layers (two segments) over 64 patches, and its train step
once more at 6 layers (three segments); each at prefill, train and
decode on the pod and a train step on the multipod.  The full configs
are held at the pod: tinyllama-1.1b's prefill_32k, decode_32k and
train_4k (and its train_4k at full width cut to 2 layers, plain and
under ``REPRO_SP_RESIDUAL``), the decode_32k of xlstm-1.3b,
zamba2-2.7b, whisper-large-v3 and llama-3.2-vision-11b, and xlstm-1.3b's
train_4k and prefill_32k at full width cut to one segment (8 layers),
its train_4k once more under ``REPRO_NO_SP``.  The knob cells
(`KNOB_CELLS`) are cells of these with one of the reference's A/B knobs
set in both packages (``env``: around the reference's trace in its
subprocess, around the port's count): ``REPRO_NO_SP`` on the 8-heads
train cell at one row a rank, on arctic's shape at 128 rows (its base
compiled by the reference only, `KNOB_BASES`), on whisper's train
cell and on xlstm's prefill and train cells at 128 and 2,048 rows;
``REPRO_SP_RESIDUAL`` on the dense train and prefill cells, the
arctic-style MoE train cell and zamba2's train and prefill cells on the
pod and the dense train cell on the multipod (and zamba2-2.7b's
train_4k at full width cut to one shared-block application, 6 layers);
``REPRO_REMAT_POLICY=dots`` on the dense and MoE train cells on
the pod and the dense train cell on the multipod.  Each reference
record differs from its base's (the knob took effect).  Per cell:

* per-device FLOPs equal the reference's, counting the dots its cost
  model misses (``fused_dot_flops``: XLA puts the one-row products of
  the multipod decode into fusions, whose bodies ``hlo_cost`` does not
  walk), with no term for xlstm.  Two gaps are reckoned: arctic-style
  experts' recompute
  (`router_gap`: the combine einsum ``torch.utils.checkpoint``
  recomputes and the router share XLA's recompute leaves out), and
  zamba2's train step, equal to the reference compiled with the port's
  factorisation of the SSD scan's three-operand einsums.  The backward
  products XLA splits over the model axis run so in the port
  (`parallel.axes.einsum`'s ``whole_forward`` / ``whole_grad`` /
  ``share_grad``: GQA's K/V weight gradients, the sequence-parallel
  projections, zamba2's ``w_cat``; arctic's router on each rank's
  experts);
* ``args`` per device exact (a decode cell takes no parameter its step
  never reads, as the reference's jit leaves them out);
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
  arrays, the sLSTM's for any number of segments, and XLA's windowed
  re-layouts of their projections' outputs (`relayout_windows`); the
  cross-attention families' query, context and gate arrays).  No
  reference array is left out and no cell is held by a band;
  ``tests/_relayout_gap.py`` sets XLA's re-layouts against the port's at
  full size; xlstm's plan past one mLSTM chunk and under ``REPRO_NO_SP``
  (`_xlstm_whole_terms`), held on the toy cells and at full width.
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
          batch=32, serving=False, seq=128, **cfg):
    return dict(arch=arch, cfg=dict(TOY, **cfg), kind=kind, seq=seq,
                batch=batch, mesh=mesh, accum=accum, serving=serving)


#: the reference's A/B knobs, one setting each
NO_SP = {"REPRO_NO_SP": "1"}
SP_RESIDUAL = {"REPRO_SP_RESIDUAL": "1"}
DOTS = {"REPRO_REMAT_POLICY": "dots"}


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
    # the same at one row a rank on either mesh (the weights' gradients
    # from each rank's share of the rows on the pod, from the gathered
    # rows on the multipod: `models.common._gathered_grad`), and over
    # rows longer than one attention chunk (the projections on the whole
    # rows: `models.common._rows_whole`, arctic-480b's train_4k and
    # prefill_32k)
    "seqpar-train-pod-b16": _cell(n_heads=8, n_kv_heads=8, batch=16),
    # arctic-style over those rows: its sequence-parallel attention (8
    # heads over 4 KV heads) before experts that split the model axis
    **{f"moe-ep-seqpar-{k}-pod-s2048": _cell(
        arch="arctic-480b", kind=k, n_heads=8, n_kv_heads=4, n_experts=16,
        batch=16, seq=2048) for k in ("prefill", "train")},
    "seqpar-train-multipod": _cell(mesh="multipod", n_heads=8, n_kv_heads=8),
    **{f"seqpar-{k}-pod-s2048": _cell(kind=k, n_heads=8, n_kv_heads=8,
                                      batch=16, seq=2048)
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
    **{f"xlstm-train-pod-{n}l": _cell(arch="xlstm-1.3b", n_heads=4,
                                      n_kv_heads=4, d_ff=0, n_layers=n,
                                      slstm_every=2) for n in (4, 6)},
    "zamba2-train-pod-d512-4l": _cell(arch="zamba2-2.7b", d_model=512,
                                      d_head=32, n_layers=4, attn_every=2,
                                      ssm_state=16, ssm_head_dim=16),
    # the cross-attention families: whisper's 20 heads of 16 (20 does not
    # divide the model axis: the sequence-parallel fallback, K/V of the
    # encoder states whole) and its vocab 518 (does not divide 16, as
    # 51,866 does not), two encoder and two decoder layers; the vision
    # model's 32 query heads over 4 KV heads with a gated cross block
    # every second of its 4 layers (two segments); 64 context rows each
    **{f"{fam}-{k}-{m}": _cell(arch=arch, kind=k, mesh=m, n_ctx_tokens=64,
                               **over)
       for fam, arch, over in (
           ("whisper", "whisper-large-v3", dict(
               d_model=320, n_heads=20, n_kv_heads=20, d_ff=640, vocab=518,
               n_layers=2, n_encoder_layers=2)),
           ("vlm", "llama-3.2-vision-11b", dict(
               n_heads=32, n_kv_heads=4, n_layers=4, cross_attn_every=2)))
       for k, m in (("prefill", "pod"), ("train", "pod"), ("decode", "pod"),
                    ("train", "multipod"))},
    # the vision model's train step at three segments, so that a term
    # counted per segment is told from one counted once or twice
    "vlm-train-pod-6l": _cell(arch="llama-3.2-vision-11b", n_ctx_tokens=64,
                              n_heads=32, n_kv_heads=4, n_layers=6,
                              cross_attn_every=2),
    # whisper's train step at three decoder layers over one encoder
    # layer, so that a term counted per decoder layer is told from one
    # counted per encoder layer
    "whisper-train-pod-3d1e": _cell(
        arch="whisper-large-v3", n_ctx_tokens=64, d_model=320, n_heads=20,
        n_kv_heads=20, d_ff=640, vocab=518, n_layers=3, n_encoder_layers=1),
    # xlstm over 2,048 rows, two mLSTM query chunks: past one chunk the
    # gates and the projections around the loop run on the whole rows
    # (`models.common._rows_whole`), the plan of its production train
    # and prefill cells
    **{f"xlstm-{k}-pod-s2048": _cell(
        arch="xlstm-1.3b", kind=k, batch=16, seq=2048, n_heads=4,
        n_kv_heads=4, d_ff=0, n_layers=2, slstm_every=2)
       for k in ("prefill", "train")},
    # whisper over 2,048 tokens and 1,500 frames (the published frames,
    # which do not divide 16), both longer than one attention chunk: the
    # plan of its production train and prefill cells
    **{f"whisper-{k}-pod-s2048": _cell(
        arch="whisper-large-v3", kind=k, batch=16, seq=2048,
        n_ctx_tokens=1500, d_model=320, n_heads=20, n_kv_heads=20, d_ff=640,
        vocab=518, n_layers=2, n_encoder_layers=2)
       for k in ("prefill", "train")},
}
#: arctic's shape (8 heads over 4 KV heads, 16 experts split over the
#: model axis) over rows of one attention chunk: the base of a knob cell,
#: compiled by the reference only
KNOB_BASES = {"moe-ep-seqpar-train-pod-b16": _cell(
    arch="arctic-480b", n_heads=8, n_kv_heads=4, n_experts=16, batch=16)}
#: the knob cells: each a cell of `CELLS` (or `KNOB_BASES`) with one of
#: the reference's A/B knobs set in both packages (``env``), and the
#: name of that cell
KNOB_CELLS = {
    f"{tag}-{base}": (base, env)
    for env, tag, bases in (
        (NO_SP, "nosp", ("seqpar-train-pod-b16", "moe-ep-seqpar-train-pod-b16",
                         "whisper-train-pod", "xlstm-prefill-pod",
                         "xlstm-train-pod", "xlstm-prefill-pod-s2048",
                         "xlstm-train-pod-s2048")),
        (SP_RESIDUAL, "spres", ("train-pod", "prefill-pod", "moe-ep-pod",
                                "train-multipod", "zamba2-train-pod",
                                "zamba2-prefill-pod")),
        (DOTS, "dots", ("train-pod", "moe-ep-pod", "train-multipod")))
    for base in bases}
CELLS.update({name: dict({**CELLS, **KNOB_BASES}[base], env=env)
              for name, (base, env) in KNOB_CELLS.items()})
#: the full configs at registered shapes on the pod
FULL = {**{f"full-{s}": dict(arch="tinyllama-1.1b", shape=s, mesh="pod")
           for s in ("prefill_32k", "decode_32k", "train_4k")},
        **{f"full-{a.split('-')[0]}-decode_32k":
           dict(arch=a, shape="decode_32k", mesh="pod")
           for a in ("xlstm-1.3b", "zamba2-2.7b", "whisper-large-v3",
                     "llama-3.2-vision-11b")},
        # at full width cut to 2 layers, and so under REPRO_SP_RESIDUAL:
        # GQA's K/V projected on each rank's rows (no toy cell shows the
        # reference's full-width plan for it)
        **{f"full-train_4k-2l{tag}": dict(arch="tinyllama-1.1b",
                                          shape="train_4k", mesh="pod",
                                          layers=2, **env)
           for tag, env in (("", {}), ("-spres", dict(env=SP_RESIDUAL)))},
        # at full width cut to one segment (7 mLSTM + 1 sLSTM layers): the
        # sLSTM's loop over 4,096 and 32,768 steps, counted by its trip
        # count as the reference's cost model counts its scan
        **{f"full-xlstm-{s}-8l": dict(arch="xlstm-1.3b", shape=s,
                                      mesh="pod", layers=8)
           for s in ("train_4k", "prefill_32k")},
        # and its train step under REPRO_NO_SP: the mLSTM's scores split
        # over the value dims, every row whole
        "full-xlstm-train_4k-8l-nosp": dict(arch="xlstm-1.3b",
                                            shape="train_4k", mesh="pod",
                                            layers=8, env=NO_SP),
        # zamba2-2.7b at full width cut to one shared-block application (6
        # Mamba2 layers) under REPRO_SP_RESIDUAL: the residual's rows split
        # over ``model`` through the Mamba2 blocks and the fold
        "full-zamba2-train_4k-6l-spres": dict(arch="zamba2-2.7b",
                                              shape="train_4k", mesh="pod",
                                              layers=6, env=SP_RESIDUAL)}
#: the full cells' bases without the knob, compiled by the reference only
FULL_BASES = {"full-zamba2-train_4k-6l": dict(arch="zamba2-2.7b",
                                              shape="train_4k", mesh="pod",
                                              layers=6)}
#: the zamba2 train cells, compiled once more with the port's
#: factorisation of the SSD scan's einsums (the FLOP gap's cause)
SSD_TWO_OPERAND = {f"{n}+ssd2": dict(c, ssd="two_operand")
                   for n, c in {**CELLS, **FULL}.items()
                   if c["arch"] == "zamba2-2.7b" and "train" in (
                       c.get("kind"), c.get("shape", "").split("_")[0])}
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")


#: every cell the reference compiles, in its subprocess's order
REF_CELLS = {**CELLS, **KNOB_BASES, **FULL, **FULL_BASES, **SSD_TWO_OPERAND}


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
    with dryrun.knobs_set(cell.get("env")), \
            dryrun.partitioned_cell(get_model(cfg), shape, mesh,
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
    """arctic-style, per layer on one rank's (B b, G S) tokens: the
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
    D = _dims(name)
    b, g, d, layers = D["b"], D["S"], D["d"], D["L"]
    e = CELLS[name]["cfg"]["n_experts"]
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
    if CELLS[name]["arch"] == "arctic-480b" and CELLS[name]["kind"] == "train":
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
    cfg = cfgs.get_config(c["arch"])
    if c.get("layers"):
        cfg = dataclasses.replace(cfg, n_layers=c["layers"])
    accum = (dryrun.TRAIN_ACCUM.get(cfg.name, dryrun.DEFAULT_ACCUM)
             if shape.kind == "train" else 1)
    return dict(arch=c["arch"], mesh=c["mesh"], accum=accum, serving=False,
                cfg=dataclasses.asdict(cfg), kind=shape.kind,
                seq=shape.seq_len, batch=shape.global_batch,
                env=c.get("env"))


@pytest.mark.parametrize("name", list(FULL))
def test_full_tinyllama_flops_and_args_equal_reference(ref, name):
    """The full configs at full width and depth: the per-device FLOPs and
    args of tinyllama-1.1b's pod prefill, decode and train step (and its
    train step cut to 2 layers, plain and under ``REPRO_SP_RESIDUAL``) and
    of
    xlstm-1.3b's, zamba2-2.7b's, whisper-large-v3's and
    llama-3.2-vision-11b's pod decode equal the reference's partitioned
    compile's; tinyllama's prefill all-reduces too (bf16 counting
    twice), and the other families' decodes' collectives array by array
    (`_hold_collectives`: what tells them from the ideal partition,
    whose FLOPs and args are the same)."""
    c = FULL[name]
    cfg, shape = cfgs.get_config(c["arch"]), SHAPES[c["shape"]]
    if c.get("layers"):
        cfg = dataclasses.replace(cfg, n_layers=c["layers"])
    with dryrun.knobs_set(c.get("env")):
        counted = dryrun.partitioned_count(cfg, shape, "pod")
        rec = dryrun.cell_record(cfg, shape, "pod", counted=counted)
    r = ref[name]
    if c.get("env"):
        base = ref[name.replace("-spres", "").replace("-nosp", "")]
        assert r["flops"] != base["flops"], name      # the knob took effect
        assert rec["knobs"] == dict(dict.fromkeys(dryrun.KNOBS, ""),
                                    **c["env"])
    assert rec["partition"] == "dtensor"
    want = r["flops"] + r["fused_dot_flops"]
    if f"{name}+ssd2" in ref:
        # (zamba2's train step: the reference with the port's SSD
        # factorisation, as `test_flops_and_args_equal_reference`)
        two = ref[f"{name}+ssd2"]
        assert abs(rec["hlo_flops_dev"] / want - 1) < 1e-3, name
        want = two["flops"] + two["fused_dot_flops"]
    assert rec["hlo_flops_dev"] == want
    assert rec["memory_analysis"]["args"] == r["args"]
    if name == "full-prefill_32k":
        assert 2 * rec["collectives"]["bytes_by_op"]["all-reduce"] == \
            r["full_bytes_by_op"]["all-reduce"]
    if c["arch"] == "xlstm-1.3b" and shape.kind != "decode":
        assert rec["loops"]["slstm"]["trip"] == shape.seq_len
        _hold_step_collectives(ref, name, counted)
    if c["arch"] != "tinyllama-1.1b":
        _hold_collectives(ref, name, counted)


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
    L = cfg["n_layers"]
    # the vision model's cross blocks (one a segment) and its self blocks
    Lx = L // cfg["cross_attn_every"] if cfg["cross_attn_every"] else 0
    return dict(a=c["accum"], B=B, b=B // R if B % R == 0 else B // 2,
                S=c["seq"], T=1 if c["kind"] == "decode" else c["seq"],
                d=cfg["d_model"], V=cfg["vocab"],
                F=cfg["d_ff"], L=L, Ls=L - Lx, Lx=Lx, H=H,
                KV=cfg["n_kv_heads"], hd=cfg["d_head"] or cfg["d_model"] // H,
                M=16, R=R, C=cfg["n_ctx_tokens"], E=cfg["n_encoder_layers"],
                square=c["mesh"] == "pod", kind=c["kind"])


#: the families whose blocks are recurrent (xlstm-1.3b, zamba2-2.7b)
RECURRENT = ("xlstm-1.3b", "zamba2-2.7b")


def relayout_windows(D, cfg, train, relayout) -> dict:
    """XLA's windowed re-layouts of zamba2's Mamba2 blocks (its ops
    ``split`` and ``concatenate``), the arrays by kind for the cell of
    dims ``D`` (`_dims`); ``relayout``: XLA's permutes for the bare
    block at the cell's dims (``tests/_ref_partition.py``'s
    ``relayouts``: its forward's, and its gradient's).

    Each layer's in-projection output (blocks of ``cols/M``) is cut into
    z, x, B and C, dt, x is concatenated with B and C (the conv's
    channels, blocks of ``conv/M``) and the conv's output cut into x, B,
    C, each piece laid out by the ``state`` split: XLA moves the windows
    where a piece's blocks and its source's overlap by collective-
    permutes, in the forward and, in a train step, again with the pieces'
    gradients put back (the recompute and the backward); their grouping
    into permutes is XLA's compact halo exchange, read off the bare
    block's compile (not reduced here to a closed form).  The
    concatenation XLA makes by gathering x and B, C at a decode step
    (``b*d_in``, ``b*2n``), and otherwise by all-to-alls of the rows'
    share (``b*T/M`` rows of x, of B and C, and of the conv's channels, a
    pass); the backward's re-lay B's and C's gradients, B and C's
    together, dt's, x's thrice, the conv input's and the in-projection
    output's."""
    b, T, d, L, M = (D[k] for k in ("b", "T", "d", "L", "M"))
    n = cfg["ssm_state"]
    d_in = cfg["ssm_expand"] * d
    h = d_in // cfg["ssm_head_dim"]
    conv, cols = d_in + 2 * n, 2 * d_in + 2 * n + h
    out = {"collective-permute": [], "all-gather": [], "all-to-all": []}
    for phase in ("forward", "grad") if train else ("forward",):
        out["collective-permute"] += relayout[phase] * L
    if D["kind"] == "decode":
        out["all-gather"] += [b * 2 * n, b * d_in] * L
        return out
    rows = b * T // M
    out["all-to-all"] += [rows * 2 * n, rows * d_in, rows * conv] * L * (
        2 if train else 1)
    if train:
        out["all-to-all"] += [rows * n] * 2 * L + \
            [rows * 2 * n, rows * h] * L + [rows * d_in] * 3 * L + \
            [rows * conv, rows * cols] * L
    return out


def _zamba2_terms(D, cfg, train, ref, port, relayout):
    """zamba2's arrays (see `reckoned`); ``relayout``: XLA's arrays for
    the bare splits of the Mamba2 block at the cell's dims
    (``tests/_ref_partition.py``'s ``relayouts``)."""
    b, T, d, L, M, R = (D[k] for k in ("b", "T", "d", "L", "M", "R"))
    n, hp, k = cfg["ssm_state"], cfg["ssm_head_dim"], cfg["conv_kernel"]
    d_in = cfg["ssm_expand"] * d
    h = d_in // hp
    conv = d_in + 2 * n
    cols = 2 * d_in + 2 * n + h
    passes = 2 if train else 1
    for kind, sizes in relayout_windows(D, cfg, train, relayout).items():
        ref[kind] += sizes
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


def _zamba2_spres_terms(D, cfg, train, ref, port, relayout):
    """zamba2's arrays under ``REPRO_SP_RESIDUAL`` outside a decode step
    (see `reckoned`): the residual's rows split over ``model`` through the
    Mamba2 blocks, the fold and the shared block.  Per microbatch (``a``
    of them) but for the weights XLA gathers once a step outside its
    microbatch loop; ``relayout``: XLA's permutes for one bare Mamba2
    block on those rows (``tests/_ref_partition.py``'s
    ``block_relayout``)."""
    a, b, S, d, V, F, L, M, R = (D[k] for k in "abSdVFLMR")
    H, hd = D["H"], D["hd"]
    n, hp, k = cfg["ssm_state"], cfg["ssm_head_dim"], cfg["conv_kernel"]
    d_in = cfg["ssm_expand"] * d
    h, conv = d_in // hp, d_in + 2 * n
    nc = S // min(cfg["ssm_chunk"], S)
    Ls, rows = L // cfg["attn_every"], b * S // M
    passes = 2 if train else 1          # the forward and the recompute
    for phase in ("forward", "grad") if train else ("forward",):
        ref["collective-permute"] += relayout[phase] * L * a
    # the conv: XLA runs it on each rank's rows with every channel, its
    # weight's k rows and its bias gathered whole, and moves its output
    # to the channels' split; the SSD scan's decays and terms between the
    # chunks' rows and the heads (dt, the cumulative decays, the states'
    # decays, the chunks' carry, the off-chunk term) and gathers C's
    # chunks; the port runs the conv on each rank's channels over every
    # row, and the scan on its heads with B and C whole (one all-to-all)
    ref["all-gather"] += ([conv] * (k + 1) + [b * S * n]) * L * a * passes
    # (w_in gathered whole for the rows' product: XLA over ``model`` first,
    # the port over the data axes first)
    ref["all-gather"] += [d // R * (2 * d_in + 2 * n + h)] * L * a * passes
    port["all-gather"] += [d * (2 * d_in + 2 * n + h) // M] * L * a * passes
    ref["all-to-all"] += ([b * S * conv // M, b * S * d_in // M] +
                          [b * S * h // M] * 4 + [b * nc * h // M]) * \
        L * a * passes
    port["all-to-all"] += [b * S * (d_in // M + 2 * n)] * L * a * passes
    # the shared block (``Ls`` applications; not recomputed): XLA runs the
    # query and key projections on each rank's rows, their weights
    # gathered whole (over ``model``, then the data axes) once a step, and
    # re-lays the rotation's halves, a head at a time; the port gathers
    # the normed rows and runs every projection on its heads, the four
    # weights' head shares gathered each microbatch
    ref["all-gather"] += ([d * H * hd, d // R * H * hd] * 2 +
                          [d * H * hd // M] * 2) * Ls
    port["all-gather"] += [d * H * hd // M] * 4 * Ls * a
    ref["all-to-all"] += [rows * hd // 2] * 4 * H * Ls * a
    # the embedding: in a microbatch loop XLA looks the ids up in its share
    # of the vocab (partial sums, reduced), where the port gathers the
    # table and the rows
    if a > 1:
        ref["all-reduce"] += [b * S * d] * a
        port["all-gather"] += [V * d // R, b * S * d] * a
    # the weights XLA gathers once a step (w_cat, the FFN's, the head),
    # the port each microbatch
    port["all-gather"] += ([2 * d * d] + [d * F // M] * 3 * Ls +
                           [d * V // M]) * (a - 1)
    if not train:
        return
    # the backward: XLA regathers the conv's weight rows and C's chunks,
    # the attention's four weights' head shares and its output
    # projection's weight whole, the FFN's weights and the head (once a
    # step), and moves the scores' rows, the output's and the softmax
    # statistics' between the rows' split and the heads'
    ref["all-gather"] += ([conv] * k + [b * S * n]) * L * a + \
        ([d * H * hd // M] * 4 + [H * hd * d] + [d * F // M] * 3) * Ls + \
        [d * V // M]
    if S <= 1024:
        # (rows within one attention chunk: the scores' rows, the
        # output's and the softmax statistics' a head at a time, and the
        # values' rows gathered)
        ref["all-to-all"] += ([rows * S] * 2 + [rows * hd] * 2 +
                              [rows] * 3) * H * Ls * a
        ref["all-gather"] += [b * S * H * hd] * Ls * a
    else:
        # (past one chunk: the chunks' query rows and their gradients, and
        # two of the statistics, all heads at once)
        ref["all-to-all"] += ([rows * H * hd] * 3 + [rows * H] * 2) * Ls * a
    # the Mamba2 blocks' backward: XLA moves the off-chunk term's gradient
    # and two more of the scan's value-sized terms (``b*S*d_in/M``), the
    # decays' and the chunks' carry's back between the chunks' rows and
    # the heads; the port sends the in-projection's pieces' and the conv
    # input's gradients back (`parallel.axes.rows_to_cols`, `regather`)
    ref["all-to-all"] += ([b * S * d_in // M] * 3 + [b * S * h // M] * 4 +
                          [b * nc * h // M]) * L * a
    port["all-to-all"] += [b * S * (2 * d_in + 2 * n + h) // M,
                           b * S * conv // M] * L * a
    # the fold's weight gradient: XLA reduces its ZeRO-3 shard's rows over
    # ``model`` at each application before the whole
    ref["all-reduce"] += [2 * d // R * d] * Ls * a
    # the recompute of C.B^T: XLA's three-operand compile gathers the
    # chunks as its forward does, the two-operand one (whose FLOPs the
    # port's equal) runs it on the state dim's shares (partial sums
    # reduced); in the backward XLA reduces C's chunks' gradient (the
    # heads' partial sums)
    cq = b * S * min(cfg["ssm_chunk"], S)
    ref["all-gather"] += [cq] * L * a
    port["all-reduce"] += [cq] * L * a
    ref["all-reduce"] += [b * S * n] * L * a
    # the heads' three vectors (A's log, dt's bias, D): XLA gathers one
    # whole in the forward and the recompute and reduces two gradients'
    # shares (``h/M``) and whole, updates each stacked leaf on its
    # heads' share and gathers it and its two moments; the port slices
    # each to its heads (the gradients gathered back) and reduces them
    # whole over the batch ranks
    ref["all-gather"] += [h] * L * a * passes + [L * h] * 9
    port["all-gather"] += [h] * 3 * L * a
    ref["all-reduce"] += ([h // M] * 2 + [h] * 2) * L * a
    port["all-reduce"] += [h] * 3 * L * a
    # the weights' gradients: XLA reduces w_in's over each axis (the port
    # over both at once), each layer's conv rows and bias and norm (and
    # the shared block's and the final norms) over each axis, and
    # norm_y's share, where the port reduces each stacked leaf once a
    # microbatch
    ref["all-reduce"] += ([d * (2 * d_in + 2 * n + h)] + [conv] * 2 * (k + 1)
                          + [d] * 2 + [d_in // M]) * L * a + \
        [d] * 2 * (2 * Ls + 1) * a
    port["all-reduce"] += [L * d, L * k * conv // M, L * conv // M,
                           L * d_in // M, d, d, d] * a


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
    # XLA's windowed re-layout (``split``) of each mLSTM's up-projection
    # output into its two halves (blocks of 2*d_in/M against pieces of
    # d_in/M): in the forward only, by collective-permutes of one piece
    # (three at a decode step) and of two, and, but at a decode step, an
    # all-to-all of the rows
    w = b * (1 if decode else T) * d_in // M
    ref["collective-permute"] += ([w] * (3 if decode else 1) + [2 * w]) * n_m
    if not decode:
        ref["all-to-all"] += [2 * w] * n_m
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
        # with one sLSTM segment XLA unrolls the step's layers; with more
        # it keeps its layer loop over the segments and partitions the
        # sLSTM's backward and w_x's gradient otherwise (``single``)
        single = n_s == 1
        # the sLSTM's backward, per step: XLA's mirrors the forward's
        # gathers and re-layout, reduces the h gradient's partial sums
        # (twice in one segment, once in the loop, where it gathers the
        # gates' pre-activations too) and the recurrent weights' and the
        # bias's gradient shares every step; the port reduce-scatters the
        # h gradient onto its share, and reduces the stacked recurrent
        # weights' gradient once and each layer's bias gradient once
        rh = h * dhs * 4 * dhs // M
        ref["all-gather"] += [b * dhs, b * ds] * T * n_s
        ref["collective-permute"] += [b * 4 * ds // M] * T * n_s
        ref["all-reduce"] += ([b * ds] * (2 if single else 1) +
                              [rh, 4 * ds // M]) * T * n_s
        if not single:
            ref["all-gather"] += [b * 4 * ds] * T * n_s
        port["reduce-scatter"] += [b * ds // M] * T * n_s
        port["all-reduce"] += [n_s * rh] + [4 * ds] * n_s
        port["all-gather"] += [4 * ds] * n_s
        # in its recompute XLA gathers the up-projection's weight whole
        # (over ``model``, then the data axes) and q/k/v's whole, but not
        # w_o over ``model``, the port w_o as in its forward and the
        # up-projection's over the data axes; in the backward XLA
        # regathers w_o's first share and the head, and in one segment
        # w_x's first share and the rows for w_x's gradient
        ref["all-gather"] += [h * dh * d // M] * n_m + \
            [d * 4 * ds // M, b * T * d] * single * n_s + \
            [d * 2 * d_in // R, d * 2 * d_in] * n_m + \
            [h * dh * dh] * 3 * n_m + [d * D["V"] // M]
        port["all-gather"] += [h * dh * d // R, h * dh * d] * n_m + \
            [d * 2 * d_in // M] * n_m
        # and it gathers the gates' cumulative sums thrice more, xh in its
        # layout twice (forward and recompute) and k once more in the
        # backward; the rows of each layer's input the port gathers in its
        # forward and their gradient's in its backward (2 a layer), XLA's
        # layer loop once a layer and once more in each
        ref["all-gather"] += [b * T * h] * 3 * n_m + \
            [b * T * d_in] * 3 * n_m
        port["all-gather"] += [b * T * d] * 2 * (n_m - 1)
        # re-layouts in the backward: XLA moves the input contributions'
        # slices (``T*b*ds/M``) and k's and v's gradients by all-to-alls,
        # the port reduce-scatters k's and v's onto the value split; the
        # port's recompute moves q to the rows again
        ref["all-to-all"] += [T * b * ds // M] * (2 - single) * n_s + \
            [b * T * h * dh // M] * 2 * n_m
        # (and in the loop pads them across the model ranks once)
        ref["collective-permute"] += [T * b * ds // M] * (1 - single) * n_s
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
            [4 * ds // M * d] * single * n_s + [b * T * h] * 2 * n_m + \
            [b * T * d_in] * 2 * n_m
        # w_x's gradient: in one segment XLA reduces its share and the
        # rows', in the loop the whole over both axes, where the port
        # reduces each layer's input gradient (the rows') over ``model``
        ref["all-reduce"] += [d * 4 * ds] * 2 * (1 - single) * n_s
        port["all-reduce"] += [b * T * d] * (1 - single) * n_s
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


def _xlstm_whole_terms(D, cfg, kind, no_sp, ref, port):
    """xlstm's arrays where the projections around the mLSTM's query-chunk
    loop run on the whole rows (see `reckoned`): rows past one chunk of
    1,024 (`models.common._rows_whole`), the loop's rows split over
    ``model``, or under ``REPRO_NO_SP`` at any length, the loop on
    blocks of the value dims (`models.xlstm._mlstm_by_value`).  Per
    microbatch (``a`` of them) but for the weights XLA gathers once a
    step outside its microbatch loop."""
    a, b, T, d, V, L, M, R = (D[k] for k in "abTdVLMR")
    h = cfg["n_heads"]
    d_in, ds = 2 * d, d                 # the mLSTM's and sLSTM's widths
    dh, dhs = d_in // h, ds // h
    n_s = L // cfg["slstm_every"]       # sLSTM layers
    n_m = L - n_s
    c = min(1024, max(-(-T // 128) * 128, 128))
    nq = -(-T // c)                     # query chunks
    P = nq * c                          # the rows padded to whole chunks
    train = kind == "train"
    passes = 2 if train else 1          # the forward and the recompute
    w = b * T * d_in // M               # one piece of the up-projection
    u = b * P * d_in // M               # the value dims' share of the rows
    rh = h * dhs * 4 * dhs // M         # the recurrent weights' share
    # the up-projection's output: the port gathers it whole, XLA re-lays
    # its halves (three windowed permutes of a piece and one of two, in
    # each pass; in the backward two more of a piece) and gathers xh's
    # head share and xh (in each pass and in the backward)
    port["all-gather"] += [b * T * 2 * d_in] * n_m * passes * a
    ref["collective-permute"] += ([w] * 3 + [2 * w]) * n_m * passes * a
    ref["all-gather"] += [b * T * d_in, b * T * dh] * n_m * (
        3 if train else 1) * a
    # the gates' weight: XLA permutes its shard to the model axis (and
    # its gradient back); under REPRO_NO_SP both gather each rank's head
    if not no_sp:
        ref["collective-permute"] += [d // R * h * 2] * n_m * (
            3 if train else 1) * a
    # the output projection: XLA re-lays w_o's value split into blocks of
    # the heads' flattened value dims (an all-to-all and a permute, in the
    # forward) and reduces the partial sums in two stages (two all-reduces
    # of the rows), the port runs it on w_o's own split (one all-reduce;
    # in a train step it reduces the rows' gradient once more, which XLA
    # does not); under REPRO_NO_SP the port moves w_o to the same blocks
    # (`parallel.axes.regather_local`: one all-to-all)
    ref["all-to-all"] += [h * dh * d // M] * n_m * a
    ref["collective-permute"] += [h * dh * d // M] * n_m * a
    if no_sp:
        port["all-to-all"] += [h * dh * d // M] * n_m * (
            3 if train else 1) * a
    if not train:
        ref["all-reduce"] += [b * T * d] * n_m
    if no_sp:
        # the scores' partial sums over the value dims: XLA reduces them in
        # two stages (all heads over one group of model ranks, then the
        # rank's head over the other), the port in one (in each pass and
        # in the backward)
        ref["all-reduce"] += [b * c * P] * nq * n_m * (
            3 if train else 1) * a
    # the sLSTM: XLA re-lays each step's gates (a permute) and output (four
    # all-to-alls) between w_x's and w_o's blocks of the width and the
    # recurrent weights' split of each head, and gathers one head's share
    # of h, each in the forward and the backward; the port moves w_x's and
    # w_o's blocks to that split (`parallel.axes.regather`: one
    # all-to-all each, and their gradients back) and gathers the bias (and
    # its gradient)
    ref["collective-permute"] += [b * 4 * ds // M] * T * n_s * passes * a
    ref["all-to-all"] += [b * 4 * dhs // M] * 4 * T * n_s * passes * a
    ref["all-gather"] += [b * dhs] * T * n_s * passes * a
    port["all-to-all"] += [d * 4 * ds // M, ds * d // M] * n_s * passes * a
    port["all-gather"] += [4 * ds] * n_s * passes * a
    # the weights XLA gathers once a step (the sLSTM's w_x and w_o shares,
    # the head), the port each microbatch
    port["all-gather"] += ([d * 4 * ds // M, ds * d // M] * n_s +
                           [d * V // M]) * (a - 1)
    # the embedding: in one microbatch XLA looks the ids up in each rank's
    # share of the table, permuted to the model axis (and its gradient
    # back), where the port moves the rows from the sequence split by an
    # all-to-all; in a microbatch loop it looks them up in its share of
    # the vocab (partial sums, reduced) and moves the rows by all-to-alls,
    # where the port gathers the table and the rows
    if T <= c:
        pass        # (rows within one chunk: the port's own plan)
    elif a == 1:
        ref["collective-permute"] += [V * d // (R * M)] * (2 if train
                                                          else 1)
        port["all-to-all"] += [b * T * d]
    else:
        ref["all-reduce"] += [b * T * d] * a
        port["all-gather"] += [V * d // R, b * T * d] * a
        if train:
            ref["all-to-all"] += [b * T * d] * a
    if not train:
        return
    # the backward of the query-chunk loop: XLA moves the decay-weighted
    # scores and the chunk's terms between the rows' and the value dims'
    # splits in every chunk (gathers of the scores, ``b*c*P*h``, and of
    # the chunk's normalisers and gates, ``b*c*h``; reductions of the
    # scores' and the gates' partial sums, ``b*h*c*P``, ``b*c*h``,
    # ``b*P*h``; the chunk's rows of the value dims by an all-to-all),
    # gathers the gates' cumulative sums and k once more, reduces xh's and
    # the rows' partial gradients more often, and re-lays the
    # up-projection's and the value dims' gradients by all-to-alls; the
    # port reduces the gates' gradient once (``b*T*h*2``), moves q's and
    # the output's gradients back by all-to-alls, reduce-scatters k's,
    # v's and the up-projection's, and gathers the loop's output again in
    # its recompute
    ref["all-gather"] += [b * T * d_in] * 2 * n_m * a
    ref["all-reduce"] += [b * T * d_in] * 3 * n_m * a
    ref["collective-permute"] += [w] * 2 * n_m * a
    port["all-gather"] += [b * P * d_in] * n_m * a
    port["reduce-scatter"] += [b * T * 2 * d_in // M] * n_m * a
    if no_sp:
        # (under REPRO_NO_SP: the scores gathered thrice a chunk and the
        # chunk's terms thrice, the rows' gradient reduced once more a
        # layer, w_o's gradient share reduced whole; the port
        # reduce-scatters v's and w_o's gradients, moves w_o's back, and
        # takes no gates' or k's gradient across ranks)
        ref["all-gather"] += ([b * c * P * h] + [b * c * h]) * 3 * nq * \
            n_m * a
        ref["all-reduce"] += ([b * c * h] * nq + [b * T * d,
                                                  h * dh * d // M]) * n_m * a
        ref["all-to-all"] += [u] * 6 * n_m * a
        port["reduce-scatter"] += [b * T * d_in // M,
                                   h * dh * d // (M * R)] * n_m * a
    else:
        ref["all-gather"] += ([b * c * P * h] + [b * c * h] * 2) * nq * \
            n_m * a + [b * P * h] * n_m * a
        ref["all-reduce"] += [b * h * c * P, b * c * h, b * P * h,
                              b * T * d_in] * nq * n_m * a
        ref["all-to-all"] += [u] * 7 * n_m * a
        port["all-reduce"] += [b * T * h * 2] * n_m * a
        port["reduce-scatter"] += [b * T * d_in // M] * 2 * n_m * a
    # the sLSTM's backward steps (`slstm_step_terms`), and its weights'
    # gradients: XLA all-reduces w_x's and w_o's shares, the port
    # reduce-scatters them onto their ZeRO-3 shards
    ref["all-gather"] += [b * ds] * T * n_s * a
    ref["all-reduce"] += [4 * ds // M, b * ds, rh] * T * n_s * a + \
        [d * 4 * ds // M, ds * d // M] * n_s * a
    port["all-reduce"] += [n_s * rh] * a + [4 * ds] * n_s * a
    port["reduce-scatter"] += [b * ds // M] * (T - 1) * n_s * a + \
        [d * 4 * ds // (M * R), ds * d // (M * R)] * n_s * a
    # the small leaves: XLA reduces each layer's gate bias and its norms'
    # (and the final one's) in its layer loop, and the input gate's weight
    # as its share over ``model``; the port each stacked leaf once, and
    # the input gate's weight whole (its gradient from the share of d,
    # `parallel.axes.einsum`'s ``share_grad``)
    ref["all-reduce"] += [d] * (n_m + n_s + 1) * a
    port["all-reduce"] += [n_m * h * 2, n_m * d, n_s * d, d] * a
    if no_sp:
        # (under REPRO_NO_SP each rank's head's gate weight and bias: XLA
        # gathers the stacked leaves' shares once a step, thrice, and
        # reduces each layer's head's gradients whole; the port
        # reduce-scatters the head's weight gradient onto its ZeRO-3
        # share and reduces the stacked leaf's over ``model`` once)
        ref["all-gather"] += [n_m * h * 2, n_m * d // R * h * 2] * 3
        ref["all-reduce"] += [2, d * 2] * n_m * a
        port["reduce-scatter"] += [d * 2 // R] * n_m * a
        port["all-reduce"] += [n_m * d // R * h * 2] * a
    else:
        ref["all-reduce"] += [h * 2, d * h * 2 // M] * n_m * a
        port["all-reduce"] += [d * h * 2] * n_m * a
    # the rows' gradient: XLA reduces it once more a microbatch (the
    # sLSTM's), the port reduce-scatters it onto the embedding's sequence
    # split
    ref["all-reduce"] += [b * T * d] * a
    port["reduce-scatter"] += [b * T * d // M] * a


def _whisper_terms(D, cfg, kind, ref, port):
    """whisper's arrays (see `reckoned`).  Its 20 heads take the
    sequence-parallel fallback in all three attentions, its vocab (518)
    leaves the embedding table split over the data axis on its width
    alone, and its frames (64) pad to one attention chunk of ``P``
    rows."""
    b, S, C, d, F, V, M, R, L, E = (D[k] for k in (
        "b", "S", "C", "d", "F", "V", "M", "R", "L", "E"))
    hw = D["H"] * D["hd"]               # an attention weight's width
    w = d // R * hw                     # its ZeRO-3 shard
    P = min(1024, max(-(-C // 128) * 128, 128))
    if S > 1024 and kind != "decode":
        assert C > 1024, "rows and frames on either side of one chunk"
        return _whisper_whole_terms(D, kind, ref, port)
    # XLA permutes one attention weight's shard of each self-attention to
    # the model axis (`reckoned`'s sequence-parallel terms), and the
    # head's, in the forward (and the recompute and backward)
    passes = 1 if kind != "train" else 3
    if D["square"]:
        ref["collective-permute"] += [w] * (L + (E if kind != "decode"
                                                 else 0)) * passes
        ref["collective-permute"] += [d // R * V] * (2 if kind == "train"
                                                     else 1)
    if kind == "decode":
        # XLA keeps the decode step's residual as partial sums over
        # ``model`` and reduces each row's mean square for every norm
        # (``b``), the rows for the FFN, the norms' and the logits'
        # inputs and each layer's new K and V rows (``b*d``); it looks the
        # ids up in each rank's share of the table's width and gathers
        # the rows
        ref["all-reduce"] += [b] * (3 * L + 1) + [b * d] * (4 * L + 1)
        ref["all-gather"] += [b * d]
        return
    # the encoder's frames: XLA moves each rank's rows to their places in
    # the chunk they pad to, and back, by collective-permutes
    k = 2 if kind == "train" else 1
    ref["collective-permute"] += [b * P // M * d] * k * E + \
        [b * C // M * d] * k * k * E
    # the embedding: XLA looks the ids up in each rank's share of the
    # table's width and gathers the rows; the port moves the ids
    ref["all-gather"] += [b * S * d]
    if kind == "prefill":
        # the port gathers q for its pin and splits it again for the
        # attention (a layer), which XLA keeps split; XLA gathers the
        # encoder's residual rows twice a layer (at the block's end and
        # for its FFN) where the port gathers the attention's output rows
        port["all-gather"] += [b * S * hw] * L + [b * C * hw] * E
        ref["all-gather"] += [b * C * d] * 2 * E
        return
    # `models.common._gathered_grad`: the weights' gradients from each
    # rank's share of the rows on the pod, from the gathered rows on the
    # multipod (its batch split over two mesh axes)
    share = D["square"]
    # in the forward, the recompute and the backward the port gathers q
    # for its pin (4 a decoder layer); XLA regathers one FFN weight a
    # layer and the cross K or V in the backward, and the encoder's padded
    # rows once a layer
    port["all-gather"] += [b * S * hw] * 4 * L
    ref["all-gather"] += [d * F // M] * (L + E) + [b * C * hw] * L + \
        [b * P * hw] * E
    # the gradients of the small leaves: XLA reduces each layer's in its
    # layer scans, each norm weight's twice (over the batch ranks and
    # over ``model``, whose ranks hold row shares of what it scales) and
    # each bias's once, and the final norms' twice; the port each stacked
    # leaf once (the decoder's three norms and output bias, the
    # encoder's two and its bias, the FFN input biases, the two final
    # norms)
    ref["all-reduce"] += [F // M] * (L + E) + [d] * (7 * L + 5 * E + 4)
    port["all-reduce"] += [L * F // M, E * F // M] + [L * d] * 4 + \
        [E * d] * 3 + [d] * 2
    # the attention weights' gradients: XLA reduces each one's data shard
    # over ``model`` (all but one weight of each layer, and with two rows
    # a rank that one too, where the port reduces the cross query's and
    # the encoder output's whole, from its rows' share); the table's
    # width share twice (once with one row a rank), where the port
    # reduces the head's whole (from its rows' share)
    ref["all-reduce"] += [w] * (7 * L + 3 * E) + \
        [V * d // R] * (2 if share else 1)
    if share:
        ref["all-reduce"] += [w] * (L + E)
        port["all-reduce"] += [d * hw] * (L + E) + [d * V]
    # the cross attention's K and V gradients (partial sums over
    # ``model``): XLA all-reduces them, the port reduce-scatters them onto
    # the encoder states' rows
    ref["all-reduce"] += [b * C * hw] * 2 * L
    port["reduce-scatter"] += [b * C * hw // M] * 2 * L
    if D["square"]:
        # XLA re-lays the projections' input gradients by all-to-alls of
        # the rows' share (a layer, and the logits')
        ref["all-to-all"] += [b * S * d // M] * (L + 1) + \
            [b * C * d // M] * E


def _whisper_no_sp_terms(D, kind, ref, port):
    """whisper's arrays under ``REPRO_NO_SP`` (see `reckoned`): its 20
    heads run whole on every model rank in all three attentions, no
    sequence-parallel fallback.  Every attention weight (q, k, v and the
    output of the decoder's two attentions and the encoder's, ``8L +
    4E``) is whole over ``model``, and the head too (its vocab does not
    divide the axis): both partitioners move each ZeRO-3 shard to the
    model axis in each pass, XLA by collective-permutes, the port by
    all-to-alls (`parallel.axes.transpose_shard`).  XLA looks the ids up
    in each rank's share of the table's width and gathers the rows; it
    reduces the small leaves' gradients per layer in its layer scans,
    the port each stacked leaf once; and the head's gradient as its ZeRO-3
    shard over ``model``."""
    b, S, d, F, V, M, R, L, E = (D[k] for k in (
        "b", "S", "d", "F", "V", "M", "R", "L", "E"))
    passes = 3 if kind == "train" else 1
    w = [d // R * D["H"] * D["hd"]] * (8 * L + 4 * E) * passes + \
        [d // R * V] * (2 if kind == "train" else 1)
    ref["collective-permute"] += w
    port["all-to-all"] += w
    ref["all-gather"] += [b * S * d]
    if kind != "train":
        return
    ref["all-reduce"] += [d] * (4 * L + 3 * E) + [F // M] * (L + E) + \
        [d // R * V]
    port["all-reduce"] += [L * d] * 4 + [E * d] * 3 + [L * F // M,
                                                        E * F // M]


def _whisper_whole_terms(D, kind, ref, port):
    """whisper's arrays (see `reckoned`) where its tokens and its frames
    are both longer than one attention chunk (`models.common._rows_whole`):
    every projection around the sequence-parallel attention runs on the
    whole rows, in both partitioners, and only the chunks' query rows
    split."""
    b, S, C, d, F, V, M, R, L, E = (D[k] for k in (
        "b", "S", "C", "d", "F", "V", "M", "R", "L", "E"))
    hw = D["H"] * D["hd"]
    w = d // R * hw
    attns = 2 * L + E                   # the decoder's two, the encoder's

    def padded(n):                      # rows padded to whole chunks
        return -(-n // 1024) * 1024

    train = kind == "train"
    passes, fwd = (3, 2) if train else (1, 1)
    # XLA permutes every attention weight's shard to the model axis (in
    # each pass), and the table's and head's width shards (forward, and
    # in a train step their gradients back)
    ref["collective-permute"] += [w] * 4 * attns * passes + \
        [V * d // R] * (4 if train else 2)
    # the embedding: XLA looks the ids up in each rank's share of the
    # table's width and gathers the rows; the port moves its rows (and
    # their gradient) from the sequence split by an all-to-all
    ref["all-gather"] += [b * S * d]
    port["all-to-all"] += [b * S * d] * (2 if train else 1)
    # each attention's output: XLA gathers the chunk loop's output (rows
    # padded to whole chunks) in every pass; the port gathers the
    # decoder's rows before its output projections (forward, recompute),
    # sums the encoder's padded rows from the ranks that hold them
    # (`models.common._leading_rows`) and, in the backward, gathers each
    # attention's query-row gradient
    ref["all-gather"] += ([b * padded(S) * hw] * 2 * L
                          + [b * padded(C) * hw] * E) * passes
    port["all-gather"] += [b * S * hw] * 2 * L * fwd
    port["all-reduce"] += [b * C * hw] * E * fwd
    if not train:
        return
    port["all-gather"] += [b * padded(S) * hw] * 2 * L + \
        [b * padded(C) * hw] * E
    # the K and V gradients (partial sums over ``model``, whose ranks hold
    # the query rows): XLA reduces them in each query chunk, the port once
    nq = padded(S) // 1024
    ref["all-reduce"] += [b * S * hw] * 2 * L * nq + \
        [b * C * hw] * 2 * L * nq + [b * C * hw] * 2 * E * (padded(C) // 1024)
    port["all-reduce"] += [b * S * hw] * 2 * L + [b * C * hw] * 2 * (L + E)
    # the attention weights' gradients: XLA reduces each one's ZeRO-3
    # shard over ``model``, the port the whole (`parallel.axes.einsum`'s
    # ``share_grad``: partial sums of the rows' shares); the head's: XLA
    # its width shard twice, the port the whole
    ref["all-reduce"] += [w] * 4 * attns + [V * d // R] * 2
    port["all-reduce"] += [d * hw] * 4 * attns + [d * V]
    # the small leaves: XLA reduces each layer's once in its layer scans
    # (the decoder's three norms and output bias, the encoder's two and
    # its bias, the FFN input biases, the two final norms), the port each
    # stacked leaf once
    ref["all-reduce"] += [F // M] * (L + E) + [d] * (4 * L + 3 * E + 2)
    port["all-reduce"] += [L * F // M, E * F // M] + [L * d] * 4 + \
        [E * d] * 3 + [d] * 2


def _vlm_terms(D, kind, ref, port):
    """The vision model's arrays (see `reckoned`): its cross blocks', and
    those its self blocks add to the dense family's per-layer terms,
    each in a layer scan of its own (one a segment)."""
    b, d, F, V, H, KV, hd, M, R, n, C = (D[k] for k in (
        "b", "d", "F", "V", "H", "KV", "hd", "M", "R", "Lx", "C"))
    if kind == "decode":
        # the cross attention over the cached image K/V (context rows
        # split over ``model``), its one query row padded to a chunk of
        # P: the port gathers the K/V; where they outweigh the padded
        # queries (the full config's 1,600 patches), XLA gathers the
        # queries' heads (and one KV group's) instead and reduces the
        # softmax's max and sum and the output over the context's rows
        P = 128
        if C * KV > P * H:
            port["all-gather"] += [b * C * KV * hd] * 2 * n
            ref["all-gather"] += [b * P * H * hd, b * P * H // KV * hd] * n
            ref["all-reduce"] += [b * P * H] * 2 * n + \
                [b * P * H * hd] * 2 * n
        return
    if kind != "train":
        return
    kv = max(H // M // (H // KV), 1) * hd   # a rank's KV heads' width
    w = d // R * KV * hd                    # a K/V weight's ZeRO-3 shard
    # the cross blocks' norms: XLA reduces each block's gradients, the
    # port each stacked leaf's
    ref["all-reduce"] += [d] * 2 * n
    port["all-reduce"] += [n * d] * 2
    # the cross blocks' K/V weights (`models.common._grouped_cross`): XLA
    # all-reduces each block's KV-head slice gradient whole over the
    # batch ranks, the port reduce-scatters it onto its shard; XLA
    # reduces each block's K and V gradients over the model ranks that
    # share their KV head, the port the stacked weights' gradients over
    # ``model`` once; XLA updates the stacked weights on a split of their
    # KV heads over those ranks and gathers the updated weights and their
    # two moments
    ref["all-reduce"] += [d * kv] * 2 * n + [b * C * kv] * 2 * n
    port["reduce-scatter"] += [d // R * kv] * 2 * n
    port["all-reduce"] += [n * w] * 2
    ref["all-gather"] += [n * w] * 6
    # the backward regathers what the port keeps from its forward: the
    # cross blocks' three FFN weights in every block; in every segment
    # but the last (whose backward follows its forward) the self and
    # cross blocks' q and o weights, the self block's K and V (permuted
    # to the model axis again on the pod) and its FFN's gate and up; the
    # head once
    ref["all-gather"] += [d * F // M] * 3 * n + \
        [d * H * hd // M] * 4 * (n - 1) + [d * KV * hd] * 2 * (n - 1) + \
        [d * F // M] * 2 * (n - 1) + [d * V // M]
    if D["square"]:
        ref["collective-permute"] += [w] * 2 * (n - 1)


def _sp_residual_terms(D, moe, ref):
    """XLA's arrays under ``REPRO_SP_RESIDUAL`` (see `reckoned`) that the
    port's plan does not move, for a decoder-only or MoE cell whose heads
    split the model axis.  The port gathers each block's normed rows
    before its attention and its FFN and keeps its rows of their outputs
    (`models.transformer._block_fwd_seq`), the products as without the
    knob.  XLA carries the rows' split into the attention: it runs the
    query projection on each model rank's rows with the weight gathered
    whole over ``model`` (its ZeRO-3 shard's heads, then the whole), and
    re-lays the rotation's halves, the causal mask's rows and the
    scores' and statistics' chunks between the rows' split and the heads'
    by all-to-alls, a head at a time; it gathers the rotation's tables and
    the FFN's gate and up weights once more, and reduces the norm
    weights' gradients over ``model`` too."""
    b, S, d, F, L, H, hd, M, R = (D[k] for k in (
        "b", "S", "d", "F", "L", "H", "hd", "M", "R"))
    rows = b * S // M                   # a rank's rows of the residual
    train = D["kind"] == "train"
    ref["all-gather"] += [d * H * hd] * (5 if train else 2) * L
    # the rotation's halves, a head at a time (forward; and in a train
    # step the recompute and the backward)
    ref["all-to-all"] += [rows * hd // 2] * (8 if train else 4) * H * L
    if not train:
        return
    ref["all-gather"] += [d // R * H * hd] * 4 * L + \
        [d * F // M] * (2 * L + 1) + [S * hd // 2] * 8 * L + \
        [b * S * d] * (2 + (L if moe else 0))
    ref["all-reduce"] += [d] * (2 * L + 1)
    # the scores' rows (``rows*S``), the output's (``rows*hd``) and the
    # softmax statistics' (``rows``), a head at a time
    ref["all-to-all"] += ([rows * S] * 2 + [rows * hd] * 2 + [rows] * 3) \
        * H * L


def reckoned(name, relayout=None):
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
    * the sequence-parallel fallback over rows longer than one attention
      chunk (``whole_rows``: both partitioners project the whole rows,
      so no row gathers tell them apart): XLA permutes all four
      attention weights' shards to the model axis (``4L`` a pass) and
      the table's width share (the forward, and its gradient back)
      where the port moves the embedding's rows by an all-to-all
      (``b*S*d``); in a train step it reduces each attention weight's
      gradient as its shard (``d/R*H*hd``, the port whole, ``d*H*hd``)
      and the K and V gradients in each query chunk (the port once);
    * the sequence-parallel fallback on the multipod, whose batch splits
      over two mesh axes: both compute the output projection's weight
      gradient from the gathered rows (`models.common._gathered_grad`),
      so XLA reduces three weight shards a layer, not four, the port
      none whole, and neither re-lays the input gradient; XLA permutes
      no weight there;
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
      stacked reductions of small parameters' gradients, the sLSTM's
      per-step arrays (stated for one segment and for XLA's layer loop
      over several) and XLA's windowed re-layouts (`relayout_windows`,
      the mLSTM's up-projection halves);
    * ``REPRO_NO_SP`` with heads too few for the model axis: every
      attention weight (and whisper's head) whole over ``model``, its
      ZeRO-3 shard moved to the model axis in each pass (XLA's permutes
      against the port's all-to-alls, `_whisper_no_sp_terms` for
      whisper's three attentions and small leaves), no sequence-parallel
      terms;
    * ``REPRO_SP_RESIDUAL`` (`_sp_residual_terms`): XLA carries the
      rows' split into the attention, the port gathers the normed rows
      before it and before the FFN; for zamba2 (`_zamba2_spres_terms`)
      into the Mamba2 blocks too, its conv and parts of its scan on the
      rows where the port runs them on the channels and the heads, and
      XLA's permutes of one bare block on the split rows
      (``relayout``); ``REPRO_REMAT_POLICY=dots`` needs no term (both
      save the projections' reduced outputs);
    * xlstm where the projections around the mLSTM's chunk loop run on
      the whole rows, past one chunk or under ``REPRO_NO_SP``
      (`_xlstm_whole_terms`, each array with its cause there): XLA's
      windowed re-layouts of the up-projection's halves and of w_o's
      value blocks, its two-stage reductions of the output projection
      and of the scores, the chunk loop's backward on the value dims'
      split (the scores and the chunk's terms moved in every chunk), the
      sLSTM's per-step re-layouts against the port's once-moved weight
      blocks, the embedding's lookup by rows past one chunk, the weights
      XLA gathers once a step outside its microbatch loop;
    * the cross-attention families (`_whisper_terms`, `_vlm_terms`, each
      array with its cause there): whisper's projections around the
      sequence-parallel attention, its undivided vocab's embedding and
      logits, the encoder's padded chunk, the decode step's partial
      residual; the vision model's K/V heads sliced per rank, its gates,
      the layer scans of one layer a segment, the decode step's cross
      attention over the split context rows at full size.

    ``relayout``: XLA's permutes for the bare Mamba2 block at the cell's
    dims (``tests/_ref_partition.py``'s ``relayouts``; zamba2 only).
    Where the rows of a knob cell past one attention chunk and XLA's
    three-operand recompute of C.B^T differ from the port's, the term
    says so.
    """
    D = _dims(name)
    a, b, B, S, d, V, F = (D[k] for k in "abBSdVF")
    L = D["Ls"]                 # the self-attention blocks
    H, KV, hd, M, R = (D[k] for k in ("H", "KV", "hd", "M", "R"))
    c = _cell_info(name)
    ref, port = {k: [] for k in KINDS + ("collective-permute",)}, \
        {k: [] for k in KINDS}
    train = c["kind"] == "train"
    # whisper's vocab does not split the model axis: `_whisper_terms`
    audio = c["arch"] == "whisper-large-v3"
    # the sequence-parallel fallback over rows longer than one attention
    # chunk (`models.common._rows_whole`): the projections run on the
    # whole rows
    # ``REPRO_NO_SP``: heads too few for the model axis run whole on
    # every model rank, no sequence-parallel fallback (`_no_sp_terms`)
    no_sp = c.get("env") == NO_SP
    recurrent = c["arch"] in RECURRENT
    whole_rows = H < M and S > 1024 and not audio and (not no_sp or
                                                       recurrent)
    if train and B >= R and not audio:
        ref["all-reduce"] += a * [b * S] * 2
        if not whole_rows:
            ref["all-to-all"] += a * [b * S * d]
        port["all-to-all"] += a * [b * S * d // M]
    if train and not audio:
        ref["all-reduce"] += a * [V * d // R]
        port["reduce-scatter"] += a * [V * d // (R * M)]
    if train and c["arch"] not in RECURRENT and not audio:
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
    if whole_rows and not recurrent:
        rows, kv = b * S * d, b * S * KV * hd
        # the q and output weights' ZeRO-3 shards, and the K and V's
        shards = [d // R * H * hd] * 2 * L + [d // R * KV * hd] * 2 * L
        ref["collective-permute"] += shards * (3 if train else 1) + \
            [V * d // (R * M)] * (2 if train else 1)
        port["all-to-all"] += [rows]
        if train:
            nq = -(-S // 1024)
            ref["all-reduce"] += shards + [kv] * 2 * L * nq
            port["all-reduce"] += [d * H * hd] * 2 * L + \
                [d * KV * hd] * 2 * L + [kv] * 2 * L
    elif H < M and not recurrent and not no_sp:
        rows = b * S * d
        # `models.common._gathered_grad`: the multipod's batch splits
        # over two mesh axes
        gathered = not D["square"]
        if D["square"]:
            ref["collective-permute"] += (3 if train else 1) * L * [
                d // R * H * hd]
        ref["all-gather"] += [rows] * (11 * L + 2 if train else 5 * L + 1)
        port["all-gather"] += [rows] * (10 * L if train else 4 * L)
        if train:
            ref["all-gather"] += [d * F // M] * (2 * L + 1)
            ref["all-reduce"] += [d] * (2 * L + 1) + \
                [d // R * H * hd] * (3 if gathered else 4) * L
            if not gathered:
                port["all-reduce"] += [d * H * hd] * L
                ref["all-to-all"] += [rows // M] * L
    E = c["cfg"].get("n_experts", 0)
    if c["kind"] == "prefill" and E and E % M == 0:
        # the routing on experts split over ``model`` (see train): XLA
        # reduces the softmax's and the top-k rounds' terms per token (6
        # a layer) and gathers the gates twice a layer, the port the
        # router's logits once
        ref["all-reduce"] += [b * S] * 6 * L
        ref["all-gather"] += [b * S * E] * L
    if train and E and E % M == 0:
        G, C = S, max(int(S * 2 * 1.25 / E), 2)
        ref["all-reduce"] += [b * G] * 16 * L
        ref["all-gather"] += [b * G * E] * 4 * L + [L * d * E] * 3
        port["all-gather"] += [b * G * E] * 2 * L + [d * E] * L + \
            [b * G * E * C] * L
        port["all-reduce"] += [b * G * d] * L
    spres = c.get("env") == SP_RESIDUAL
    if c["arch"] == "zamba2-2.7b" and spres and c["kind"] != "decode":
        _zamba2_spres_terms(D, c["cfg"], train, ref, port, relayout)
    elif c["arch"] == "zamba2-2.7b":
        _zamba2_terms(D, c["cfg"], train, ref, port, relayout)
    if c["arch"] == "xlstm-1.3b" and c["kind"] != "decode" and (
            S > 1024 or no_sp):
        _xlstm_whole_terms(D, c["cfg"], c["kind"], no_sp, ref, port)
    elif c["arch"] == "xlstm-1.3b":
        _xlstm_terms(D, c["cfg"], c["kind"], ref, port)
    if c["arch"] == "llama-3.2-vision-11b":
        _vlm_terms(D, c["kind"], ref, port)
    if audio and no_sp:
        _whisper_no_sp_terms(D, c["kind"], ref, port)
    elif audio:
        _whisper_terms(D, c["cfg"], c["kind"], ref, port)
    if no_sp and H < M and not recurrent and not audio:
        # ``REPRO_NO_SP`` with heads too few for the model axis: every
        # attention weight is whole over ``model``, and both partitioners
        # move its ZeRO-3 shard to the model axis in each pass (the q, k,
        # v projections then split their contraction, the output
        # projection runs whole); XLA by collective-permutes, the port by
        # all-to-alls (`parallel.axes.transpose_shard`)
        w = [d // R * H * hd] * 2 * L + [d // R * KV * hd] * 2 * L
        passes = 3 * a if train else 1
        if D["square"]:
            ref["collective-permute"] += w * passes
            port["all-to-all"] += w * passes
    if c.get("env") == SP_RESIDUAL and c["arch"] in (
            "tinyllama-1.1b", "arctic-480b", "grok-1-314b"):
        _sp_residual_terms(D, bool(E), ref)
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


@pytest.mark.parametrize("name", list(CELLS))
def test_collective_kinds_and_bytes_against_reference(ref, port, name):
    """Every collective array equals the reference's, kind by kind, by
    element count (`_hold_collectives`), on every cell."""
    _hold_collectives(ref, name, port[name])


def _hold_collectives(ref, name, count):
    """XLA's CPU compile carries every product and collective in f32, the
    port its bf16 products in bf16: elements, not bytes, are the common
    measure.  Every array equals the reference's, kind by kind, but for
    the arrays `reckoned` states.  An all-to-all's tuple of chunks counts
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
    re_, pe = ref_elements(ref[name]), port_elements(count)
    ref_only, port_only = reckoned(name, ref[name]["relayout"])
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
    # the global norm's sum, and the vision model's 0-d gates' gradients
    gates = 2 * _dims(name)["Lx"]
    assert pe["scalars"] == (Counter({1: 1 + gates}) if train
                             else Counter()), name
    assert sum(re_["scalars"].values()) >= train, name


def slstm_step_terms(name):
    """``(ref, port)``: the arrays each partitioner moves at every step
    of the sLSTM's loop, per microbatch, by kind, in elements, at full
    size (rows past one mLSTM chunk: the full cells).  XLA gathers the
    previous h whole once (``b*ds``, for the recurrent product) and one
    head's share (``b*dhs``), permutes the gates' pre-activation share
    (``b*4*ds/M``) and re-lays the stacked output's share by four
    all-to-alls (``b*4*dhs/M`` each), where at the toy's size it gathers
    h a second time; its backward mirrors the forward's arrays and
    all-reduces the h gradient's partial sums, the recurrent weights' and
    the bias's gradient shares every step.  The port gathers h once
    (`parallel.axes.gather_share`) and reduce-scatters its gradient onto
    the share, and reduces the recurrent weights' and the bias's
    gradients once, outside the loop."""
    D, cfg = _dims(name), _cell_info(name)["cfg"]
    b, M = D["b"], D["M"]
    ds = cfg["d_model"]
    dhs = ds // cfg["n_heads"]
    fwd = {"all-gather": [b * dhs, b * ds],
           "all-to-all": [b * 4 * dhs // M] * 4,
           "collective-permute": [b * 4 * ds // M]}
    ref = {k: list(v) for k, v in fwd.items()}
    port = {"all-gather": [b * ds]}
    if D["kind"] == "train":
        for k, v in fwd.items():
            ref[k] += v
        ref["all-reduce"] = [b * ds, cfg["n_heads"] * dhs * 4 * dhs // M,
                             4 * ds // M]
        port["reduce-scatter"] = [b * ds // M]
    return ref, port


def _hold_step_collectives(ref, name, count):
    """The sLSTM's per-step collective arrays of a full xlstm cell, kind
    by kind, by element count (`slstm_step_terms`): the arrays of each
    size that run ``T`` times a microbatch or more, counted in multiples
    of ``T*a`` (the few arrays of the same size outside the loop fall
    below one; an array of every step but the last, one a microbatch
    fewer, counts as one: the backward of the last step's gather of h,
    which no step reads, does not run).  The trip count multiplies
    exactly these; `_hold_collectives` holds them with every other
    array."""
    D = _dims(name)
    per, a = D["T"] * D["a"], D["a"]
    want_ref, want_port = slstm_step_terms(name)
    got_ref, got_port = Counter(), Counter()
    for kind, dtype, dims, runs, _ in ref[name]["arrays"]:
        if dtype not in ("s32", "int32", "int64"):
            got_ref[(kind, math.prod(int(x) for x in dims.split(",")
                                     if x))] += runs
    for kind, dtype, n in count["coll_log"]:
        if dtype not in (torch.int32, torch.int64):
            got_port[(kind, n // dtype.itemsize)] += 1

    def steps(got):
        return Counter({k: (v + a) // per for k, v in got.items()
                        if v + a >= per})

    def terms(want):
        return Counter((k, n) for k, sizes in want.items() for n in sizes)

    assert steps(got_ref) == terms(want_ref), (name, steps(got_ref))
    assert steps(got_port) == terms(want_port), (name, steps(got_port))


@pytest.mark.parametrize("name", list(KNOB_CELLS))
def test_knob_changes_the_reference_record(ref, name):
    """Each knob cell's reference record differs from the same cell's
    without the knob, in its FLOPs or its collectives: the knob took
    effect in the reference's trace (and, the cell holding, in the
    port's)."""
    base = KNOB_CELLS[name][0]
    r, b = ref[name], ref[base]
    assert (r["flops"] + r["fused_dot_flops"], ref_elements(r)) != \
        (b["flops"] + b["fused_dot_flops"], ref_elements(b)), name


#: cells ``REPRO_SP_RESIDUAL`` leaves as they are: the reference's
#: decode step never reads it (its shared block runs `decode_block`), and
#: a pure Mamba2 model has no shared block whose output it pins
KNOB_IDLE = {"zamba2-decode-pod": CELLS["zamba2-decode-pod"],
             "mamba2-train-pod": dict(CELLS["zamba2-train-pod"], cfg=dict(
                 CELLS["zamba2-train-pod"]["cfg"], family="ssm"))}


@pytest.mark.parametrize("name", list(KNOB_IDLE))
def test_sp_residual_leaves_the_record(name):
    """The port's record of a cell the knob does not reach is its record
    without the knob: the Mamba2 blocks and the fold take the rows' plan
    only from rows laid split over ``model`` (`models.mamba2._rows_plan`),
    which only zamba2's sequence forward lays."""
    cell = KNOB_IDLE[name]
    base, knob = port_count(cell), port_count(dict(cell, env=SP_RESIDUAL))
    for key in ("flops", "args", "bytes", "temp", "coll_log"):
        assert knob[key] == base[key], (name, key)


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


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "arctic-480b",
                                  "whisper-large-v3", "xlstm-1.3b"])
def test_host_mesh_forward_past_one_chunk_equals_plain(arch):
    """On the degenerate 1 x 1 mesh (one card, as `chip_smoke.py`'s
    partition phase runs it) every family's heads fall back to the
    sequence-parallel branch, whose rows split over one rank: a forward
    over rows longer than one attention (or mLSTM) chunk runs the plain
    plan (`models.common._rows_whole` is false there) and equals the
    plain forward bit for bit."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.parallel.axes import distribute_tree, sharding_rules

    cfg = dataclasses.replace(get_smoke(arch), dtype=torch.float32)
    api = get_model(cfg)
    params = api.init(0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, 1100), generator=gen,
                                     dtype=torch.int32)}
    specs = {"tokens": ("batch", None)}
    if cfg.n_encoder_layers:
        batch["ctx"] = torch.randn(1, cfg.n_ctx_tokens, cfg.d_model,
                                   generator=gen)
        specs["ctx"] = ("batch", None, None)
    with torch.no_grad():
        plain = api.forward(params, batch)
    host = make_host_mesh("cpu")
    rules = rules_for(host)
    with device_mesh(host, "cpu", rules) as dm, sharding_rules(host, rules):
        dp = distribute_tree(api.param_specs(), params, dm)
        db = distribute_tree(specs, batch, dm)
        with torch.no_grad(), implicit_replication():
            out = api.forward(dp, db)
        assert torch.equal(out.to_local(), plain), arch
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
