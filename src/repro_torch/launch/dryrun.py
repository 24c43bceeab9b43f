"""Dry-run: count each (arch x shape x mesh) cell's step.

The reference lowers and compiles every cell on 512 forced host devices
and reads FLOPs, bytes and collectives out of the partitioned HLO.  A
torch step has no HLO.  The port counts the step it runs, once, under
its own counters (`StepCounter`):

* the train step (`train.step.build_train_step`, the reference's
  ``TRAIN_ACCUM`` / ``DEFAULT_ACCUM`` microbatches, bf16 Adam moments
  for the archs in ``BF16_OPT_STATE``), the prefill forward, or one
  decode step against ``init_cache(global_batch, seq_len)``; parameters
  from ``api.init(0, device="meta")``, their fp32 leaves cast to bf16
  for a decode cell under ``--variant opt`` (weight-stationary serving);
  a decode cell takes no parameter its step never reads
  (``api.decode_unread``: the context families' encoder and cross K/V
  weights), as the reference's jit leaves such arguments out;
* ``hlo_flops_dev``: the products' FLOPs (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, convolutions), as the reference's ``hlo_cost`` counts its
  ``dot`` ops;
* ``hlo_bytes_dev``: for each aten op that materialises an output, its
  operand bytes plus its output bytes (views and reshapes 0; an op that
  writes into an operand counts its other operands and the bytes it
  writes: the values of an indexed write, else the operand).  These are
  the eager program's bytes, op by op: not XLA's fused bytes, which are
  fewer;
* ``memory_analysis``: ``args``, the exact bytes of params, optimizer
  state, batch and cache; ``temp``, the peak of the bytes of the
  storages the step creates and holds at once (the step's outputs
  included); ``output``, the bytes of the outputs it creates;
  ``bytes_per_device = args + temp``, the predicted peak;
* ``n_params``, ``n_active_params`` and ``model_flops`` (tokens = batch
  x seq for train and prefill, batch for decode).

The meshes (``--mesh``):

* ``host`` -- the port's own program on one card, priced at one H100,
  counted on ``meta`` tensors at the cell's global shape: every term
  is the count itself, ``chips`` 1, no
  collective, ``partition: "exact"``;
* ``pod`` / ``multipod`` (``single`` / ``multi``; ``both``) -- the
  reference's 16x16 and 2x16x16 meshes as H100 meshes.  For every family
  (``PARTITIONED_FAMILIES``: dense, MoE, SSM, hybrid, audio, vlm) the
  step runs as rank 0
  of the mesh under DTensor over the fake process group
  (`partitioned_cell`: every arg a DTensor placed by its logical specs
  under `launch.mesh.rules_for`, its local shard on ``meta``; the
  models' ``shard`` annotations as in the reference), ``partition:
  "dtensor"``, ``collectives_scope: "all"``: FLOPs, bytes, ``args``,
  ``temp`` and ``output`` are rank 0's, counted on its local shards
  (`StepCounter` with ``local=True``: below DTensor's dispatch, its
  sharding propagation skipped), and ``collectives`` lists every
  collective DTensor issues -- the weights' gathers and the gradients'
  reductions, the activations' all-gathers, all-to-alls and
  all-reduces of partial sums -- each at its output bytes, as the
  reference's ``hlo`` counts them.  The train step donates its params
  and optimizer state, as the reference's jitted step does (AdamW
  writes each leaf in place).  A cell that DTensor cannot partition
  fails, naming the op; nothing falls back.  ``cell_record(...,
  partition="ideal")`` still gives the ideal partition, to compare
  against: ``args`` per card is exact (each
  leaf's local shape under `parallel.axes.resolve_tree`); FLOPs, bytes
  and ``temp`` per card are the global counts over ``chips``, a lower
  bound; collectives cover the weights only (``collectives_scope:
  "weights"``): each parameter leaf is all-gathered over the mesh axes
  the rules give its ``fsdp`` / ``embed`` dims, in its stored dtype,
  once per forward (per microbatch); a train step gathers it once more
  for the recompute and backward and reduce-scatters its fp32 gradient
  over the same axes, once per microbatch.  Under the serving rules no
  weight moves.

Each record keeps the reference's keys (so `perfmodel.report` and
`bench.roofline_bench` read either kind) plus ``partition``,
``collectives_scope``, ``loops`` and ``peak`` (the constants used);
``compile_s`` holds the count's wall time, and ``knobs`` the values of
the reference's four A/B knobs the models read while the step was
counted (``KNOBS``: ``REPRO_NO_SP``, ``REPRO_SP_RESIDUAL``,
``REPRO_REMAT_POLICY``, ``REPRO_FP32_PROBS``; empty where unset).
Records go to ``reports/torch/dryrun[_opt]/<mesh>/<arch>__<shape>.json``;
a record on disk is reused unless ``--force``, and only where its
``knobs`` equal the environment's (a record without the key counts as
counted with none set); otherwise the cell is counted again and the
record written over.  A config with ``use_flash_kernel`` raises: the
counter cannot see the kernel's launch.

A loop over time (`models.common.scan`: xlstm-1.3b's sLSTM) is counted
by its trip count, as the reference's cost model counts a ``lax.scan``
body once and multiplies it: its first four steps and its last run op by
op, steps 2 and 3 are held alike, forward and backward, and step 3
stands in for each step left out (`StepCounter`).  Counted so, every
field equals the op-by-op count's, ``temp`` included (the left-out
steps' live bytes held from their forward to their backward, or, in a
forward alone, until its outputs are freed).  Each
record names its loops (``loops``: ``{name: {trip, run_steps, calls}}``;
empty where there is none).  xlstm-1.3b's ``train_4k`` counts in about
90 s a mesh at full depth on meta, where op by op it ran past 30
minutes (``PERF.md``).

Usage (``--arch`` without ``--shape``: the arch's registered cells):
  python -m repro_torch.launch.dryrun --mesh host --arch tinyllama-1.1b \\
      --shape train_4k
  python -m repro_torch.launch.dryrun --mesh single --arch tinyllama-1.1b \\
      --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import dataclasses
import functools
import json
import math
import os
import pathlib
import sys
import time
import traceback
import weakref

import torch
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import registry as cfgs
from repro_torch.configs.shapes import SHAPES, ShapeConfig
from repro_torch.launch.mesh import (device_mesh, make_production_mesh,
                                     rules_for)
from repro_torch.models.registry import get_model
from repro_torch.parallel.axes import (distribute_tree, is_dtensor,
                                       local_shape, resolve, resolve_tree,
                                       serving_mode, sharding_rules)
from repro_torch.perfmodel import report
from repro_torch.perfmodel import roofline as roof
from repro_torch.perfmodel.hlo import COLLECTIVES
from repro_torch.train import optimizer as opt
from repro_torch.train.step import batch_specs, build_train_step
from repro_torch.tree import leaves, map_tree

REPORT_DIR = report.DEFAULT_DIR

#: gradient-accumulation factor per arch for train_4k (bounds
#: activation memory; microbatch = 256/accum global).
TRAIN_ACCUM = {
    "qwen2-72b": 16, "arctic-480b": 16, "grok-1-314b": 16,
    "minitron-8b": 8, "llama-3.2-vision-11b": 8,
}
DEFAULT_ACCUM = 4

#: bf16 Adam moments for archs whose fp32 m+v would not fit one card
BF16_OPT_STATE = {"arctic-480b", "grok-1-314b"}

MESHES = ("host", "pod", "multipod")

#: the reference's A/B knobs, environment variables the models read at
#: each call (`models.common.heads_tp_available`, `probs_dtype`,
#: `models.transformer.residual_spec`, `remat_policy`)
KNOBS = ("REPRO_NO_SP", "REPRO_SP_RESIDUAL", "REPRO_REMAT_POLICY",
         "REPRO_FP32_PROBS")


def knobs() -> dict:
    """Each of ``KNOBS`` as the environment sets it now, ``""`` where
    unset."""
    return {k: os.environ.get(k, "") for k in KNOBS}


@contextlib.contextmanager
def knobs_set(env):
    """The knobs ``env`` (names of ``KNOBS`` to values) set in this
    process's environment for the enclosed scope, the previous values
    restored after: a count, or a step, under them."""
    unknown = set(env or {}) - set(KNOBS)
    if unknown:
        raise ValueError(f"not a knob: {sorted(unknown)}; one of {KNOBS}")
    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

#: the logical names whose mesh axes a weight is gathered over
_GATHERED = ("fsdp", "embed")

#: ops that write into an operand at indices: they write their values
_INDEXED_WRITES = ("index_put", "scatter", "index_copy", "index_add",
                   "index_fill", "masked_scatter")

#: the families whose ``pod`` / ``multipod`` cells DTensor partitions
#: (``partition: "dtensor"``): all six
PARTITIONED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")

#: the collectives DTensor issues, by op, and their `COLLECTIVES` name
_COLLECTIVE_OPS = {
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_dtensor::shard_dim_alltoall": "all-to-all",
}

#: collective bookkeeping that moves no bytes
_WAIT = "_c10d_functional::wait_tensor"
_WRAP = "_c10d_functional::_wrap_tensor_autograd"
_NO_BYTES = (_WAIT, _WRAP)


def _local(t):
    """A DTensor's local shard (this rank's), any other tensor itself."""
    return t._local_tensor if is_dtensor(t) else t


def tensor_bytes(t) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


def _in_sharding_prop() -> bool:
    """True inside DTensor's sharding propagation, which runs ops on meta
    tensors of the global shapes to infer the outputs' (and prices
    candidate redistributions): they are not the rank's work."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_globals.get("__name__") == \
                "torch.distributed.tensor._sharding_prop":
            return True
        f = f.f_back
    return False


def tree_bytes(tree) -> int:
    return sum(tensor_bytes(t) for t in leaves(tree))


def _mutated(func, args, kwargs) -> list:
    """The tensors ``func`` writes into (in-place and ``out=``)."""
    out = []
    for i, arg in enumerate(func._schema.arguments):
        if arg.alias_info is None or not arg.alias_info.is_write:
            continue
        val = args[i] if i < len(args) else kwargs.get(arg.name)
        out += [t for t in tree_leaves(val) if isinstance(t, torch.Tensor)]
    return out


#: a trip-counted loop runs its first ``_LEAD`` steps and its last; the
#: last two of the first (``_MIDDLE``) are the middle steps held alike.
#: Step 1 is not one: its backward releases what step 0's leaves (the
#: last view of the gradient of the stacked outputs)
_LEAD = 4
_MIDDLE = (_LEAD - 2, _LEAD - 1)


class _Probe:
    """One step of a trip-counted loop, forward or backward, as the
    counter saw it: what its ops added to the counter's fields
    (`fields`)."""

    def __init__(self, counter):
        self.counter = counter
        self.flops, self.bytes = counter.flops, counter.bytes
        self.log = len(counter.coll_log)
        self.live = self.top = counter.live
        self.created = 0
        self.keys = set()

    def fields(self) -> dict:
        """``flops``, ``bytes`` and ``coll_log`` of the step's ops; the
        bytes of the storages it created (``created``) and of those
        still alive (``alive``); its change of the live bytes (``live``)
        and its peak above the live bytes it started from (``peak``)."""
        c = self.counter
        return dict(flops=c.flops - self.flops, bytes=c.bytes - self.bytes,
                    coll_log=c.coll_log[self.log:], created=self.created,
                    alive=sum(c._new.get(k, 0) for k in self.keys),
                    live=c.live - self.live, peak=self.top - self.live)


class _Loop:
    """One call of `models.common.scan` under a `StepCounter`: the steps
    that run (``steps``: the first ``_LEAD`` and the last, or every step
    where the trip holds no step to leave out) and the fields of its two
    middle steps (``_MIDDLE``), forward (``fwd``) and backward
    (``bwd``)."""

    def __init__(self, counter, name: str, trip: int):
        self.counter, self.name, self.trip = counter, name, trip
        self.steps = (list(range(trip)) if trip <= _LEAD + 1
                      else list(range(_LEAD)) + [trip - 1])
        self.skipped = trip - len(self.steps)
        self.fwd, self.bwd = {}, {}
        self.kept = set()          # the later middle step's live storages
        self.graphed = False       # autograd recorded a step
        self.done = False          # its last step has run
        self.unwound = False       # a backward op of its steps has run

    @contextlib.contextmanager
    def step(self, t: int):
        """Step ``t`` runs inside: its forward ops are counted (and held,
        for a middle step), the autograd nodes it creates noted for its
        backward; before the last step the left-out steps' forward is
        added."""
        c = self.counter
        if not self.skipped:
            yield
            return
        if t == self.trip - 1:
            c._add_steps(self, self.fwd, "forward")
        first = torch._C._autograd._get_sequence_nr()
        probe = c._open(_Probe(c)) if t in _MIDDLE else None
        yield
        if probe is not None:
            self.fwd[t] = c._close(probe)
            self.kept = {k for k in probe.keys if k in c._new}
        end = torch._C._autograd._get_sequence_nr()
        # (a custom Function takes a sequence number in no-grad mode too)
        if end > first and torch.is_grad_enabled():
            self.graphed = True
            c._nodes.append((first, end, self, t))
        if t == self.trip - 1:
            self.done = True


def _alike(loop: _Loop, probes: dict, phase: str) -> dict:
    """The fields of ``loop``'s middle step in ``phase``, held equal
    between its two middle steps (``_MIDDLE``): steps that differ raise,
    naming the loop and the field."""
    i, j = _MIDDLE
    if set(probes) != {i, j}:
        raise RuntimeError(
            f"loop {loop.name!r} (trip {loop.trip}): its {phase} steps {i} "
            f"and {j} were not both seen ({sorted(probes)}); it cannot be "
            f"counted by its trip count")
    a, b = probes[i], probes[j]
    for field in a:
        if a[field] != b[field]:
            raise RuntimeError(
                f"loop {loop.name!r} (trip {loop.trip}): its {phase} steps "
                f"{i} and {j} differ in {field!r} ({a[field]!r} against "
                f"{b[field]!r}); it cannot be counted by its trip count")
    return b


class StepCounter(TorchDispatchMode):
    """Counts, for every aten op dispatched inside it, the FLOPs of its
    product by ``torch.utils.flop_counter``'s formulas (``flops``) and
    the bytes it moves (``bytes``), and tracks the storages the ops
    create: the bytes alive at once (``live``) and their peak
    (``peak``).  A storage counts from the op that creates it until it
    is freed.

    With ``local=True`` it counts one rank of a DTensor program: the ops
    on the local shards (DTensor dispatches each op to them; its sharding
    propagation, on the global shapes, is skipped), and every collective
    DTensor issues, its output bytes per `COLLECTIVES` name
    (``coll_bytes``, ``coll_counts``; ``coll_log`` lists each as
    ``(name, dtype, bytes)``).  A collective op this counter does not
    know raises.  A collective's output lives as on the card: its wait
    returns it, and the functional collectives' autograd wrapper holds
    it while the wrapper lives (their meta kernels return new tensors).

    With ``trips=True`` it counts each `models.common.scan` loop by its
    trip count, as the reference's cost model counts a ``lax.scan``
    (``loops`` names each): the first ``_LEAD`` steps and the last run
    op by op (`_Loop`), and the two middle ones among them (``_MIDDLE``)
    are held alike, forward and backward (the ops each dispatches, and
    in the backward those of the autograd nodes it created, read off
    ``torch._C._current_autograd_node``).  The later middle step stands
    in for each step left out: its FLOPs, bytes and collectives (in the
    log where the left-out steps' would be) added once for each, the
    live bytes it leaves held as ``virtual`` bytes from its forward to
    its backward (where autograd records the loop: but for a storage it
    left alive that is freed after the loop and before its backward, an
    output no step saves, whose copies go with it; else until the last
    of the storages it left alive is freed), its transient peak counted
    on top of each.  The steps
    at the ends run as themselves: step 0 (a zero state with no
    gradient), step 1 (its backward releases what step 0's leaves) and
    the last step (its h read by the output alone).  Middle steps that
    differ raise."""

    def __init__(self, local: bool = False, trips: bool = True):
        super().__init__()
        self.local = local
        self.trips = trips
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.flops = 0
        self.coll_bytes = {c: 0 for c in COLLECTIVES}
        self.coll_counts = {c: 0 for c in COLLECTIVES}
        self.coll_log = []
        self.loops = {}
        self.virtual = 0           # the left-out steps' live bytes
        self._new = {}             # id(storage) -> nbytes, while alive
        self._held = {}            # id(storage) -> the tensor it holds
        self._on_free = {}         # id(storage) -> callbacks (`_release`)
        self._probes = []          # open probes
        self._nodes = []           # (first, end, loop, step) by sequence nr
        self._seg = None           # (loop, step) of the backward op
        self._window = None        # [loop, live, log index, peak] (`_seen`)
        self._bwd_probe = None

    def __exit__(self, *exc):
        if exc[0] is None:
            self._seen(None)
        return super().__exit__(*exc)

    def loop(self, name: str, trip: int) -> _Loop | None:
        """The `_Loop` of one `models.common.scan` call (None: every step
        runs, op by op, where ``trips`` is off)."""
        if not self.trips:
            return None
        if self._probes:
            raise NotImplementedError(
                f"loop {name!r} inside a step of another trip-counted loop")
        loop = _Loop(self, name, trip)
        self.loops.setdefault(name, dict(trip=trip, run_steps=loop.steps,
                                         calls=0))["calls"] += 1
        return loop

    def _open(self, probe):
        self._probes.append(probe)
        return probe

    def _close(self, probe) -> dict:
        self._probes.remove(probe)
        return probe.fields()

    def _add_steps(self, loop: _Loop, probes: dict, phase: str):
        """Add ``loop``'s left-out steps of ``phase`` (their middle step's
        fields once for each): in the forward, before its last step; in
        the backward, once its earlier middle step is done, at the live
        bytes and log position of the window (`_seen`)."""
        f = _alike(loop, probes, phase)
        n = loop.skipped
        self.flops += n * f["flops"]
        self.bytes += n * f["bytes"]
        for name, _, b in f["coll_log"]:
            self.coll_bytes[name] += n * b
            self.coll_counts[name] += n
        d = f["live"]
        if phase == "forward":
            live, at = self.live + self.virtual, len(self.coll_log)
            top = live + max(0, (n - 1) * d) + f["peak"]
        else:
            _, live, at, after = self._window
            top = max(live + max(0, (n - 1) * d) + f["peak"], after + n * d)
        self.coll_log[at:at] = f["coll_log"] * n
        self.peak = max(self.peak, top)
        self.virtual += n * d
        if phase == "forward" and loop.graphed:
            self._outlived(loop, n)
        elif phase == "forward":
            self._release(loop.kept, n * d)

    def _release(self, keys: set, nbytes: int):
        """Take ``nbytes`` off the virtual bytes once the last of the
        storages ``keys`` is freed: a loop autograd does not record
        leaves nothing for its backward, and the left-out steps' live
        bytes (their outputs) die with the later middle step's."""
        left = set(keys)

        def freed(key):
            left.discard(key)
            if not left:
                self.virtual -= nbytes

        if not left:
            self.virtual -= nbytes
        for k in keys:
            self._on_free.setdefault(k, []).append(freed)

    def _outlived(self, loop: _Loop, n: int):
        """In a loop autograd records, each storage the later middle step
        left alive that is freed after the loop and before its backward
        (a step's output that no step saves, dropped once the stack has
        read it) takes its ``n`` left-out steps' copies off the virtual
        bytes: they die with it, as every step's does on the card, and
        no backward step gives them back.  A storage freed inside the
        loop (the carry, replaced by the next step) or in its backward is
        a step's own, counted in its live change."""
        for key in loop.kept:
            nbytes = self._new.get(key)
            if nbytes is None:
                continue

            def freed(_, nbytes=nbytes):
                if loop.done and not loop.unwound:
                    self.virtual -= n * nbytes

            self._on_free.setdefault(key, []).append(freed)

    def _seen(self, node):
        """The backward op about to run belongs to ``node`` (None: not a
        backward op, or the count's end).  Each middle step of a loop,
        from its first op to the next op that is not its own, is one
        probe.  A loop's window opens at its later middle step, whose
        backward the left-out steps' would precede, and closes at the
        first op past the earlier one: the left-out steps are added then,
        at the window's start, and the window's own peak is counted above
        them."""
        seg = None
        if node is not None:
            nr = node._sequence_nr()
            i = bisect.bisect_right(self._nodes, nr,
                                    key=lambda e: e[0]) - 1
            if i >= 0 and nr < self._nodes[i][1]:
                seg = self._nodes[i][2:]
        if seg is not None:
            seg[0].unwound = True
        if seg == self._seg:
            return
        if self._seg is not None and self._seg[1] in _MIDDLE:
            loop, t = self._seg
            loop.bwd[t] = self._close(self._bwd_probe)
        self._seg = seg
        if self._window is not None and (
                seg is None or seg[0] is not self._window[0]
                or seg[1] not in _MIDDLE):
            loop = self._window[0]
            self._add_steps(loop, loop.bwd, "backward")
            self._window = None
        if seg is None:
            return
        loop, t = seg
        if t not in _MIDDLE:
            return
        if t in loop.bwd:
            raise RuntimeError(
                f"loop {loop.name!r} (trip {loop.trip}): the backward of its "
                f"step {t} ran in two parts; it cannot be counted by its "
                f"trip count")
        if t == _MIDDLE[1]:
            live = self.live + self.virtual
            self._window = [loop, live, len(self.coll_log), live]
        self._bwd_probe = self._open(_Probe(self))

    def _touch(self):
        """The live bytes rose: the open probes' peaks, and the window's
        (which the left-out steps' backward will raise) or the count's."""
        for p in self._probes:
            p.top = max(p.top, self.live)
        if self._window is not None:
            self._window[3] = max(self._window[3], self.live + self.virtual)
        else:
            self.peak = max(self.peak, self.live + self.virtual)

    def _free(self, key):
        self.live -= self._new.pop(key)
        for f in self._on_free.pop(key, ()):
            f(key)

    def created(self, tree) -> int:
        """Bytes of the storages of ``tree``'s tensors that ops inside
        this counter created and that are still alive."""
        keys = {id(_local(t).untyped_storage()) for t in tree_leaves(tree)
                if isinstance(t, torch.Tensor)}
        return sum(self._new.get(k, 0) for k in keys)

    def _count_collective(self, func, outs) -> bool:
        """The collective a local op issues, if any; False for an op that
        moves no bytes."""
        name = func._schema.name
        coll = _COLLECTIVE_OPS.get(name)
        if coll is not None:
            n = sum(tensor_bytes(t) for t in outs)
            self.coll_bytes[coll] += n
            self.coll_counts[coll] += 1
            self.coll_log.append((coll, outs[0].dtype, n))
        elif name.startswith(("_c10d_functional::", "_dtensor::")) \
                and name not in _NO_BYTES:
            raise RuntimeError(f"{name}: a collective the dry-run does not "
                               f"count")
        return bool(outs) and name not in _NO_BYTES

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._nodes:
            self._seen(torch._C._current_autograd_node())
        if self.local:
            if any(is_dtensor(t) for t in tree_leaves((args, kwargs))):
                # DTensor dispatches it: its ops on the local shards
                # come back here
                return NotImplemented
            if _in_sharding_prop():
                return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if self.local and func._schema.name == _WAIT:
            # the card's wait returns its input; the meta kernel's returns
            # a new tensor, and the collective's output would count as
            # freed at its wait
            return args[0]
        if (self.local and func._schema.name == _WRAP
                and type(out) is torch.Tensor):
            # the card's wrapper holds its input (a collective's output);
            # the meta kernel's is a new tensor, which would free the
            # collective's output at once: the input lives while it does
            key = id(out.untyped_storage())
            self._held[key] = args[0]
            weakref.finalize(out.untyped_storage(), self._held.pop, key,
                             None)
            return out
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if func.is_view or func is torch.ops.aten._unsafe_view.default:
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if self.local and not self._count_collective(func, outs):
            return out
        mutated = _mutated(func, args, kwargs)
        if mutated:
            others = [t for t in ins if all(t is not m for m in mutated)]
            if any(w in func._schema.name for w in _INDEXED_WRITES):
                written = tensor_bytes(others[-1]) if others else 0
            else:
                written = sum(tensor_bytes(m) for m in mutated)
            self.bytes += sum(tensor_bytes(t) for t in others) + written
        else:
            self.bytes += sum(tensor_bytes(t) for t in ins + outs)
        seen = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in seen or key in self._new:
                continue
            # a local op's output counts its own bytes: the meta kernel
            # of DTensor's all-to-all returns a chunk of a group-sized
            # buffer, where the card allocates the chunk alone
            self._new[key] = (min(st.nbytes(), tensor_bytes(t))
                              if self.local else st.nbytes())
            self.live += self._new[key]
            for p in self._probes:
                p.created += self._new[key]
                p.keys.add(key)
            self._touch()
            weakref.finalize(st, self._free, key)
        return out


@dataclasses.dataclass
class Cell:
    """One cell's step: ``fn(*args)``, the logical specs of each arg, and
    what the step does (``kind``: train / prefill / decode)."""

    fn: object
    args: tuple
    specs: tuple
    kind: str
    accum: int = 1


def input_batch(api, shape: ShapeConfig, *, for_train: bool, device="meta"):
    cfg = api.cfg
    gb, seq = shape.global_batch, shape.seq_len

    def zeros(sh, dt):
        return torch.zeros(sh, dtype=dt, device=device)

    batch = dict(tokens=zeros((gb, seq), torch.int32))
    if for_train:
        batch["labels"] = zeros((gb, seq), torch.int32)
    if api.needs_ctx:
        batch["ctx"] = zeros((gb, cfg.n_ctx_tokens, cfg.d_model), cfg.dtype)
    return batch


def _without(tree: dict, paths: tuple, prefix: str = "") -> dict:
    """``tree`` without the subtrees at the "/"-joined ``paths``."""
    return {k: (_without(v, paths, f"{prefix}{k}/")
                if isinstance(v, dict) else v)
            for k, v in tree.items() if prefix + k not in paths}


def build_cell(api, shape: ShapeConfig, *, serving: bool = False,
               accum: int | None = None, device="meta",
               donate: bool = False) -> Cell:
    """The step of ``shape``'s kind on ``device`` (meta: shapes only; the
    card runs the same step in ``chip_smoke.py``).  ``accum`` overrides
    the arch's train accumulation factor; ``donate`` has the train step
    update the params and optimizer state in place (the reference
    donates both to its jitted step)."""
    cfg = api.cfg
    if cfg.use_flash_kernel:
        raise ValueError(
            f"{cfg.name}: use_flash_kernel is set, and the dry-run cannot "
            f"count the flash kernel's launch; count the chunked route "
            f"(use_flash_kernel=False)")
    params = api.init(0, device=device)
    if serving:
        # weight-stationary serving stores the parameters in bf16
        params = map_tree(lambda t: t.to(torch.bfloat16)
                          if t.dtype == torch.float32 else t, params)
    pspecs = api.param_specs()
    if shape.kind == "train":
        accum = accum or TRAIN_ACCUM.get(cfg.name, DEFAULT_ACCUM)
        ocfg = opt.AdamWConfig(
            state_dtype=(torch.bfloat16 if cfg.name in BF16_OPT_STATE
                         else torch.float32))
        batch = input_batch(api, shape, for_train=True, device=device)
        return Cell(build_train_step(api, ocfg, accum=accum, donate=donate),
                    (params, opt.init_state(ocfg, params), batch),
                    (pspecs, opt.state_specs(pspecs), batch_specs(api)),
                    "train", accum)
    if shape.kind == "prefill":
        batch = input_batch(api, shape, for_train=False, device=device)
        bspecs = {k: v for k, v in batch_specs(api).items() if k in batch}
        return Cell(api.forward, (params, batch), (pspecs, bspecs),
                    "prefill")
    # the reference's jit leaves the arguments its step never reads out
    # of the executable (``keep_unused=False``), and so does the cell
    params, pspecs = (_without(t, api.decode_unread)
                      for t in (params, pspecs))
    gb = shape.global_batch
    cache = api.init_cache(gb, shape.seq_len, device=device)
    tokens = torch.zeros((gb,), dtype=torch.int32, device=device)
    return Cell(api.decode, (params, cache, tokens),
                (pspecs, api.cache_specs(shard_seq=True), ("batch",)),
                "decode")


def count_step(cell: Cell, local: bool = False, _trips: bool = True) -> dict:
    """Run ``cell``'s step once under `StepCounter`: FLOPs, bytes, the
    peak of the bytes it creates (``temp``), the bytes of its outputs,
    the loops counted by their trip count (``loops``: each
    `models.common.scan` by name, its trip, the steps that ran and its
    calls) and the wall time of the count.  ``local``: the step runs on
    DTensors (`partitioned_cell`) and the counts are rank 0's,
    collectives included.  ``_trips=False`` runs every step of every
    loop op by op instead (the tests hold the two counts equal)."""
    grad = torch.enable_grad() if cell.kind == "train" else torch.no_grad()
    # implicit replication: the tensors a partitioned step makes itself
    # (the positions, masks and constants) are whole on every rank
    rep = implicit_replication() if local else contextlib.nullcontext()
    t0 = time.perf_counter()
    with grad, rep, StepCounter(local=local, trips=_trips) as counter:
        out = cell.fn(*cell.args)
        output = counter.created(out)
    del out
    rec = dict(flops=float(counter.flops), bytes=float(counter.bytes),
               temp=float(counter.peak), output=float(output),
               args=float(sum(tree_bytes(a) for a in cell.args)),
               loops=counter.loops, wall_s=time.perf_counter() - t0)
    if local:
        rec.update(collectives=dict(
            bytes_by_op=dict(counter.coll_bytes),
            counts=dict(counter.coll_counts),
            total_bytes=sum(counter.coll_bytes.values())),
            coll_log=counter.coll_log)
    return rec


def _splits(cell: Cell, mesh, rules) -> list:
    """The mesh axes each dim of ``cell``'s args, and of one train
    microbatch, is split over under ``rules`` (`resolve` of its shape:
    a microbatch too small for its rule's axes is split over those it
    divides, and replicated over the others), for
    `launch.mesh.device_mesh`'s ``splits``."""
    specs, shapes = list(cell.specs), list(cell.args)
    if cell.kind == "train":
        specs.append(cell.specs[2])
        shapes.append({k: (x.shape[0] // cell.accum, *x.shape[1:])
                       for k, x in cell.args[2].items()})
    with sharding_rules(mesh, rules):
        return [(e,) if isinstance(e, str) else tuple(e)
                for spec, sh in zip(specs, shapes)
                for p in leaves(resolve_tree(spec, sh)) for e in p if e]


@contextlib.contextmanager
def partitioned_cell(api, shape: ShapeConfig, mesh, *, serving: bool = False,
                     accum: int | None = None, device: str = "meta"):
    """``shape``'s step as rank 0 of the production mesh ``mesh`` (a
    `launch.mesh.Mesh`) runs it under DTensor, for the enclosed scope:
    the fake process group and the rules of `launch.mesh.rules_for` are
    installed, and every arg leaf is a DTensor whose local shard lies on
    ``device`` (``"meta"``: shapes only; ``"cuda"``: zeros on the card,
    where the step runs for real while its collectives move no data, so
    its values mean nothing).  The mesh is a CUDA mesh either way, so
    that DTensor issues the card's collectives (over a CPU mesh it would
    replace each all-to-all by an all-gather, gloo having none); a CUDA
    mesh over the fake group needs no card.  The train step donates its
    params and optimizer state (`build_cell`'s ``donate``)."""
    cell = build_cell(api, shape, serving=serving, accum=accum, donate=True)
    rules = rules_for(mesh, serving=serving)
    with device_mesh(mesh, "cuda", rules, _splits(cell, mesh, rules)) as dm, \
            sharding_rules(mesh, rules):
        args = tuple(distribute_tree(spec, a, dm, device)
                     for spec, a in zip(cell.specs, cell.args))
        yield dataclasses.replace(cell, args=args)


def _weight_collectives(cell: Cell, mesh) -> dict:
    """Per-card bytes of the weights' collectives under the installed
    rules (see the module docstring)."""
    by_op = {c: 0 for c in COLLECTIVES}
    counts = {c: 0 for c in COLLECTIVES}
    if serving_mode():         # weights resident, never gathered
        return dict(bytes_by_op=by_op, counts=counts, total_bytes=0)
    forwards = 2 * cell.accum if cell.kind == "train" else 1
    sizes = dict(zip(mesh.axis_names, mesh.shape))

    def leaf(names, t):
        spec = resolve(names, t.shape)
        axes = [ax for name, entry in zip(names, spec) if name in _GATHERED
                for ax in ((entry,) if isinstance(entry, str)
                           else entry or ())]
        g = math.prod(sizes[ax] for ax in axes)
        if g == 1:
            return
        local = math.prod(local_shape(spec, t.shape, mesh))
        by_op["all-gather"] += forwards * local * g * t.element_size()
        counts["all-gather"] += forwards
        if cell.kind == "train":
            by_op["reduce-scatter"] += cell.accum * local * 4
            counts["reduce-scatter"] += cell.accum

    def walk(spec, tree):
        if isinstance(spec, dict):
            for k in spec:
                walk(spec[k], tree[k])
        else:
            leaf(spec, tree)

    walk(cell.specs[0], cell.args[0])
    return dict(bytes_by_op=by_op, counts=counts,
                total_bytes=sum(by_op.values()))


def _local_args_bytes(cell: Cell, mesh) -> int:
    """Per-card bytes of every arg leaf under the installed rules."""
    total = 0
    for spec_tree, tree in zip(cell.specs, cell.args):
        specs = resolve_tree(spec_tree, tree)
        for s, t in zip(leaves(specs), leaves(tree)):
            total += math.prod(local_shape(s, t.shape, mesh)) \
                * t.element_size()
    return total


def _shape(shape) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def _counted(cfg, shape: ShapeConfig, serving: bool, accum: int | None):
    return _counted_under(cfg, shape, serving, accum,
                          tuple(knobs().values()))


@functools.lru_cache(maxsize=8)
def _counted_under(cfg, shape: ShapeConfig, serving: bool,
                   accum: int | None, _knobs: tuple):
    """`count_step` of the cell, kept per value of the knobs."""
    api = get_model(cfg)
    cell = build_cell(api, shape, serving=serving, accum=accum)
    return api, cell, count_step(cell)


def partitioned_count(cfg, shape: ShapeConfig, mesh: str, *,
                      serving: bool = False, accum: int | None = None):
    """The `count_step` of ``shape``'s step of the model ``cfg`` as rank 0
    of ``mesh`` (``"pod"`` / ``"multipod"``) runs it (`partitioned_cell`),
    collectives included, with the ``cell``, the mesh's ``chips`` and
    what it counted (``of``: cfg, shape, mesh, serving, accum and the
    knobs)."""
    m = make_production_mesh(multi_pod=mesh == "multipod")
    with partitioned_cell(get_model(cfg), shape, m, serving=serving,
                          accum=accum) as cell:
        try:
            c = count_step(cell, local=True)
        except Exception as e:
            raise RuntimeError(
                f"{cfg.name} x {shape.name} x {mesh}: DTensor could not "
                f"partition the step: {e}") from e
    return dict(c, cell=cell, chips=m.size,
                of=(cfg, shape, mesh, serving, accum, knobs()))


def cell_record(cfg, shape: ShapeConfig, mesh: str, *,
                variant: str = "baseline", accum: int | None = None,
                partition: str | None = None, counted=None) -> dict:
    """The record of ``shape``'s step of the model ``cfg`` (a full config
    or one cut in depth) on ``mesh``.  ``partition``: ``"dtensor"`` or
    ``"ideal"`` for a ``pod`` / ``multipod`` cell; by default
    ``"dtensor"`` for the families of ``PARTITIONED_FAMILIES``, else
    ``"ideal"``.  ``counted``: the cell's `partitioned_count`, already
    taken, for a ``"dtensor"`` record (not counted again; one of another
    cell raises)."""
    if partition is None:
        partition = ("dtensor" if cfg.family in PARTITIONED_FAMILIES
                     else "ideal")
    serving = variant == "opt" and shape.kind == "decode"
    if mesh != "host" and partition == "dtensor":
        of = (cfg, shape, mesh, serving, accum, knobs())
        c = counted or partitioned_count(cfg, shape, mesh, serving=serving,
                                         accum=accum)
        if c["of"] != of:
            raise ValueError(f"{cfg.name} x {shape.name} x {mesh}: the "
                             f"count given was taken for {c['of']}")
        cell, chips, args, coll = (c["cell"], c["chips"], c["args"],
                                   c["collectives"])
        cost = {"flops": c["flops"], "bytes accessed": c["bytes"]}
        temp, output = c["temp"], c["output"]
        partition, scope = "dtensor", "all"
    else:
        api, cell, c = _counted(cfg, shape, serving, accum)
        if mesh == "host":
            chips, args = 1, c["args"]
            coll = dict(bytes_by_op={k: 0 for k in COLLECTIVES},
                        counts={k: 0 for k in COLLECTIVES}, total_bytes=0)
            partition, scope = "exact", "none: one card"
        else:
            m = make_production_mesh(multi_pod=mesh == "multipod")
            chips = m.size
            with sharding_rules(m, rules_for(m, serving=serving)):
                args = float(_local_args_bytes(cell, m))
                coll = _weight_collectives(cell, m)
            partition, scope = "ideal", "weights"
        cost = {"flops": c["flops"] / chips,
                "bytes accessed": c["bytes"] / chips}
        temp, output = c["temp"] / chips, c["output"] / chips
    params = cell.args[0]
    n_active = roof.count_active_params(params, cfg.top_k, cfg.n_experts)
    tokens = (shape.global_batch * shape.seq_len
              if shape.kind in ("train", "prefill") else shape.global_batch)
    mflops = roof.model_flops(shape.kind, n_active, tokens)
    r = roof.make(cfg.name, shape.name, mesh, chips, cost=cost,
                  collectives=coll, model_flops=mflops,
                  bytes_per_device=temp + args)
    record = dict(r.as_dict(), compile_s=c["wall_s"],
                  collectives=coll,
                  cost_analysis_raw={"flops": c["flops"],
                                     "bytes accessed": c["bytes"]},
                  n_params=roof.count_params_struct(params),
                  n_active_params=n_active,
                  memory_analysis=dict(temp=temp, args=args, output=output),
                  partition=partition, collectives_scope=scope,
                  peak=dict(PEAK_FLOPS=roof.PEAK_FLOPS, HBM_BW=roof.HBM_BW,
                            LINK_BW=roof.LINK_BW[mesh]),
                  kind=shape.kind, global_batch=shape.global_batch,
                  seq_len=shape.seq_len, accum=cell.accum,
                  variant=variant, knobs=knobs(), loops=c["loops"])
    return record


def run_cell(arch: str, shape, mesh: str = "host", *,
             report_dir=REPORT_DIR, force: bool = False,
             verbose: bool = True, variant: str = "baseline",
             accum: int | None = None) -> dict:
    """The record of one cell: ``shape`` a name of ``SHAPES`` or a
    `ShapeConfig` (a cut shape), ``mesh`` one of ``MESHES``."""
    if mesh not in MESHES:
        raise ValueError(f"unknown mesh {mesh!r}; one of {MESHES}")
    shape = _shape(shape)
    outdir = (pathlib.Path(str(report_dir)
                           + ("_opt" if variant == "opt" else "")) / mesh)
    outdir.mkdir(parents=True, exist_ok=True)
    outfile = outdir / f"{arch}__{shape.name}.json"
    if outfile.exists() and not force:
        record = json.loads(outfile.read_text())
        if record.get("knobs", dict.fromkeys(KNOBS, "")) == knobs():
            return record

    record = cell_record(cfgs.get_config(arch), shape, mesh,
                         variant=variant, accum=accum)
    outfile.write_text(json.dumps(record, indent=1))
    if verbose:
        r = record
        print(f"[dryrun] {arch} x {shape.name} x {mesh} "
              f"({r['partition']}): count {r['compile_s']:.1f}s  "
              f"mem/dev {r['bytes_per_device'] / 2**30:.2f} GiB  "
              f"compute {r['compute_s'] * 1e3:.2f} ms  "
              f"memory {r['memory_s'] * 1e3:.2f} ms  "
              f"collective {r['collective_s'] * 1e3:.2f} ms  "
              f"-> {r['bottleneck']}", flush=True)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=tuple(SHAPES))
    # ``pod`` and ``multipod`` name the meshes as the records do
    ap.add_argument("--mesh", choices=("host", "single", "multi", "both",
                                       "pod", "multipod"),
                    default="host")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--report-dir", default=str(REPORT_DIR))
    ap.add_argument("--variant", choices=("baseline", "opt"),
                    default="baseline")
    args = ap.parse_args(argv)

    if args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    elif args.all or args.arch:     # --arch alone: its registered cells
        cells = [c for c in cfgs.cells()
                 if args.arch in (None, c[0])]
    else:
        ap.error("give --arch [--shape], or --all")

    meshes = {"host": ("host",), "single": ("pod",), "multi": ("multipod",),
              "both": ("pod", "multipod"), "pod": ("pod",),
              "multipod": ("multipod",)}[args.mesh]
    failures = []
    for arch, shape in cells:
        for mesh in meshes:
            try:
                run_cell(arch, shape, mesh, report_dir=args.report_dir,
                         force=args.force, variant=args.variant)
            except Exception as e:       # noqa: BLE001
                failures.append((arch, shape, mesh, repr(e)))
                print(f"[dryrun] FAIL {arch} x {shape} x {mesh}: {e}",
                      flush=True)
                traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run cells failed")
    print("[dryrun] all requested cells counted OK")


if __name__ == "__main__":
    main()
