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
sequence-parallel fallback, arctic-480b's 56 heads).
tinyllama-1.1b itself is held at its pod prefill_32k and decode_32k.
Per cell:

* per-device FLOPs equal the reference's, counting the dots its cost
  model misses (``fused_dot_flops``: XLA puts the one-row products of
  the multipod decode into fusions, whose bodies ``hlo_cost`` does not
  walk).  Three gaps are reckoned: arctic-style experts, where DTensor
  runs the router on every ``model`` rank of a batch shard (16 x the
  router's products; XLA splits them), ``torch.utils.checkpoint``
  recomputes the combine einsum (the host count's known arctic gap) and
  XLA's recompute leaves one router share out (+4.5% in all); GQA on
  the pod's train step, where XLA splits the K/V weight-gradient
  product over the model axis and DTensor does not (+7.6%; full
  tinyllama-1.1b train_4k +5.5%, the same cause); and the
  sequence-parallel fallback's train step (8 heads on 16 model ranks),
  where XLA runs the output projection's backward on each rank's rows
  and DTensor on all (+40%);
* ``args`` per device exact;
* every collective kind the reference issues, the port issues.  DTensor
  has no collective-permute: the reference permutes the int32 token ids
  for its embedding gather (at least one rank's ids); the port moves its
  ids with its own all-gathers;
* every collective array, kind by kind, equal to the reference's by
  element count but for the arrays `reckoned` states (the train step's
  softmax terms, norm gradients, table gradient, embedding all-to-all
  and hoisted gathers; GQA's weight permutes); the prefill and decode
  cells on both meshes, the train steps at accum 1 and 2 on both, and
  grok-style tensor parallelism are held so.  The cells of `LOOSE`
  (serving decode, arctic-style experts, GQA decode and train, the
  microbatch too small for the multipod's batch ranks, the
  sequence-parallel fallback) are held only
  to a factor 3 a kind and 2 in total: their schedules differ in ways
  not reckoned yet.
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
}
#: tinyllama-1.1b itself, at two registered shapes on the pod
FULL = {f"full-{s}": dict(arch="tinyllama-1.1b", shape=s, mesh="pod")
        for s in ("prefill_32k", "decode_32k")}
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"),
               JAX_PLATFORMS="cpu")
    cells = {**CELLS, **FULL}
    proc = subprocess.run(
        [sys.executable, str(HERE / "_ref_partition.py"),
         json.dumps(list(cells.values()))],
        capture_output=True, text=True, env=env, timeout=600, check=True)
    return dict(zip(cells, json.loads(proc.stdout.splitlines()[-1])))


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
def port():
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


def kv_grad_gap(name):
    """GQA on the pod's train step, per layer: XLA splits the K/V
    projections' weight-gradient product over the 16 ``model`` ranks
    (one of the four passes over them: forward, recompute, input and
    weight gradients), which DTensor runs whole on each: 15/16 of one
    pass over one rank's (B 2 x S 128) tokens."""
    c = CELLS[name]["cfg"]
    kv = c["n_kv_heads"] * c["d_model"] // c["n_heads"]
    return 2 * (2 * 2 * 256 * c["d_model"] * kv) * 15 // 16


def seqpar_out_grad_gap(name):
    """The sequence-parallel fallback's train step, per layer: both
    partitioners gather the attention's rows and run the output
    projection on every ``model`` rank, and XLA runs its backward (the
    input and weight gradients) on each rank's own rows, where DTensor
    runs it on all: 15/16 of two products of one rank's (B 2 x S 128)
    rows."""
    c = CELLS[name]["cfg"]
    return 2 * 2 * (2 * 2 * 128 * c["d_model"] * c["d_model"]) * 15 // 16


def router_gap(name):
    """arctic-style, per layer on one rank's (B 2, G 128) tokens: the
    router's four products (forward, recompute, the two of the backward)
    on all 16 ``model`` ranks where XLA splits them 16 ways, the combine
    einsum that ``torch.utils.checkpoint`` recomputes, and one router
    share (1/16) that XLA's partitioned recompute leaves out."""
    c = CELLS[name]["cfg"]
    b, g, d, e, layers = 2, 128, c["d_model"], c["n_experts"], 2
    router = 2 * b * g * d * e
    cap = max(int(g * 2 * 1.25 / e), 2)
    combine = 2 * b * g * (e // 16) * cap * d
    return layers * (4 * 15 * router // 16 + combine + router // 16)


@pytest.mark.parametrize("name", list(CELLS))
def test_flops_and_args_equal_reference(ref, port, name):
    r, p = ref[name], port[name]
    want = r["flops"] + r["fused_dot_flops"]
    if name == "moe-ep-pod":
        want += router_gap(name)
    if name == "gqa-train-pod":
        want += kv_grad_gap(name)
    if name == "seqpar-train-pod":
        want += seqpar_out_grad_gap(name)
    assert p["flops"] == want, (name, p["flops"], want)
    assert p["args"] == r["args"], name


@pytest.mark.parametrize("name", list(FULL))
def test_full_tinyllama_flops_and_args_equal_reference(ref, name):
    """tinyllama-1.1b at full width and depth: the per-device FLOPs and
    args of its pod prefill and decode equal the reference's partitioned
    compile's (its all-reduces too, bf16 counting twice, at prefill)."""
    rec = dryrun.cell_record(cfgs.get_config("tinyllama-1.1b"),
                             SHAPES[FULL[name]["shape"]], "pod")
    r = ref[name]
    assert rec["hlo_flops_dev"] == r["flops"] + r["fused_dot_flops"]
    assert rec["memory_analysis"]["args"] == r["args"]
    if name == "full-prefill_32k":
        assert 2 * rec["collectives"]["bytes_by_op"]["all-reduce"] == \
            r["full_bytes_by_op"]["all-reduce"]


#: the cells whose collectives are held loosely (each kind within 3x,
#: the total within 2x): their partitioners' schedules differ in ways
#: not reckoned yet
LOOSE = ("decode-opt-pod", "moe-ep-pod", "gqa-decode-pod", "gqa-train-pod",
         "gqa-train-multipod", "train-accum2-multipod-b32",
         "seqpar-prefill-pod", "seqpar-train-pod")


def reckoned(name):
    """``(ref_only, port_only)``: for each collective kind, the arrays
    (by element count) that one partitioner moves and the other does
    not, for a cell outside `LOOSE`.  With ``a`` microbatches of ``b``
    rows a batch rank, sequence ``S``, width ``d``, vocab ``V``, ``L``
    layers, ``M`` model ranks and ``R`` batch ranks (which also split
    the embed dim):

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
    * GQA with fewer KV heads than model ranks: XLA also permutes each
      layer's K and V weight shards (``d/R * KV * hd``) to the model
      ranks whose query heads read them (DTensor has no permute; the
      port's gathers are the same bytes as XLA's).
    """
    c = CELLS[name]
    cfg, a, S = c["cfg"], c["accum"], c["seq"]
    d, V, M, L = cfg["d_model"], cfg["vocab"], 16, 2
    R = 32 if c["mesh"] == "multipod" else 16
    b = c["batch"] // (a * R)
    ref, port = {k: [] for k in KINDS + ("collective-permute",)}, \
        {k: [] for k in KINDS}
    if c["kind"] == "train":
        ref["all-reduce"] += a * ([b * S] * 2 + [d] * 2 * L + [V * d // R])
        port["all-reduce"] += a * [L * d] * 2
        port["reduce-scatter"] += a * [V * d // (R * M)]
        ref["all-to-all"] += a * [b * S * d]
        port["all-to-all"] += a * [b * S * d // M]
        port["all-gather"] += (a - 1) * [V * d // R, d * V // M]
    if cfg["n_kv_heads"] < M:
        hd = d // cfg["n_heads"]
        ref["collective-permute"] += 2 * L * [d // R * cfg["n_kv_heads"]
                                              * hd]
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
    return _elements([(k, t, size(d), runs) for k, t, d, runs
                      in rec["arrays"]])


def port_elements(rec):
    return _elements([(k, str(t).replace("torch.", ""), n // t.itemsize, 1)
                      for k, t, n in rec["coll_log"]])


@pytest.mark.parametrize("name", list(CELLS))
def test_collective_kinds_and_bytes_against_reference(ref, port, name):
    """Outside `LOOSE`, every collective array equals the reference's,
    kind by kind, by element count (XLA's CPU compile carries every
    product and collective in f32, the port its bf16 products in bf16:
    elements, not bytes, are the common measure), but for the arrays
    `reckoned` states.  An all-to-all's tuple of chunks counts as one
    total.  Left out: the token ids (integers: the reference permutes
    its int32 ids, at least one rank's, the port gathers its own) and
    0-d all-reduces (XLA reduces each leaf's squared norm and the
    loss's terms apart, 16-25 scalars; the port one sum, the global
    norm's)."""
    r, w = ref[name]["full_bytes_by_op"], weighted(port[name])
    cell = CELLS[name]
    ranks = 32 if cell["mesh"] == "multipod" else 16
    ids = cell["batch"] // ranks * (1 if cell["kind"] == "decode"
                                    else cell["seq"]) * 4
    assert r["collective-permute"] >= ids, (name, r)
    assert w["ids"] > 0, name
    for kind, n in r.items():
        if kind != "collective-permute":
            assert w[kind] > 0, (name, kind)
    if name in LOOSE:
        for kind, n in r.items():
            if kind != "collective-permute":
                assert 1 / 3 <= w[kind] / n <= 3, (name, kind, w[kind], n)
        total = sum(v for k, v in r.items() if k != "collective-permute")
        assert 0.5 <= sum(w[k] for k in KINDS) / total <= 2, (name, w, r)
        return
    re_, pe = ref_elements(ref[name]), port_elements(port[name])
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
