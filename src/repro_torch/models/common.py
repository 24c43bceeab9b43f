"""Shared model machinery: config, norms, RoPE, GQA attention, FFN.

The reference's ``models/common.py`` in PyTorch: what every family
shares (the SwiGLU and GELU FFNs, attention, embeddings).

Conventions
-----------
* Params are nested dicts of tensors; per-layer groups are *stacked*
  along a leading ``L`` axis, exactly as the reference lays them out, so
  a parameter tree carries across leaf by leaf (`registry.params_from_numpy`).
* Compute dtype is ``cfg.dtype`` (bf16 by default); params stay fp32
  and are cast at each product, softmax statistics accumulate in fp32.
* Attention has two interchangeable implementations: the query-chunked
  online-softmax path (`_chunked_attention`) and the hand-written CUDA
  flash-attention kernel (`repro_torch.kernels.flash_attention`, whose
  plain version runs for CPU tensors).  ``cfg.use_flash_kernel`` selects.
  The flash route takes no logit softcap, so a config that sets both
  raises (the reference's flash route drops the softcap silently).
* A `ShapesOnly` stand-in for the generator builds a parameter tree of
  meta tensors: shapes without storage, how a full config is counted.
* The reference's SPMD annotations carry over onto DTensor
  (`parallel.axes`): `shard` at the reference's call sites (the
  projections' outputs, the FFN's hidden state, the embedding and the
  logits), `heads_tp_available` and the sequence-parallel branch of the
  attention, and `serving_matmul`, the weight-stationary product of the
  serving rules.  Where the reference leaves the plan to XLA's
  partitioner, the DTensor path states it: weights gathered over their
  ZeRO-3 dims before use, partial sums reduced where they arise (and
  their gradients'), the attention and the embedding lookup run per
  rank.  Where the reference's partitioner permutes a weight's shard
  between the pod's two axes (GQA's K/V weights, zamba2's ``w_cat``),
  the port moves it by one all-to-all (`transposed_product`).  Every
  family runs so in the partitioned dry-run; the cross-attention's
  products (`cross_q`, `cross_kv`, `cross_attention`) state theirs too.
  Around the sequence-parallel attention the plan follows what the code
  sees: rows longer than one attention chunk are projected whole
  (`_rows_whole`), and the weights' gradients come from the gathered
  rows where the batch splits over two mesh axes (`_gathered_grad`).
  On plain tensors, or with no rules installed, all of it is the
  identity and the products are the plain ones.  The logical axis names
  of each weight are kept as data (``*_specs``: one tuple of names per
  leaf, one name per dim), which `parallel.axes` resolves.
* Training recomputes each block's activations in the backward pass
  (`recompute`, the reference's ``jax.checkpoint`` around the same
  blocks); a forward that autograd does not record runs plainly.
* The reference's four A/B knobs are environment variables read at each
  call where the reference reads them while tracing: ``REPRO_NO_SP``
  (`heads_tp_available`: no sequence-parallel fallback, heads too few
  for the model axis whole on every model rank, each attention weight's
  shard moved to the model axis), ``REPRO_FP32_PROBS`` (`probs_dtype`),
  and, in `models.transformer`, ``REPRO_SP_RESIDUAL`` (the residual's
  rows split over ``model``) and ``REPRO_REMAT_POLICY=dots`` (`recompute`'s
  ``dots`` policy for the decoder-only layer loop).  Non-empty turns a
  knob on; the policy only where it equals ``dots``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Any

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.parallel.axes import (P, _mesh, _rules, all_to_all,
                                       axis_sizes, einsum, gather_fsdp,
                                       gather_share, gathered_out,
                                       in_no_batch_product,
                                       is_dtensor, placements,
                                       product_scope, reduce_grad_partial,
                                       reduce_partial, resolve, serving_mode,
                                       shard, sharding_rules, transpose_local,
                                       transpose_shard, transposable)
from repro_torch.tree import leaves


def _plain_product(eq: str, x, w):
    """``einsum(eq, x, w)`` for the projections' equations, as the plain
    products the port runs: x (..., d) @ w (d, *out), or for the
    attention output x (..., H, D) @ w (H, D, d).  Marked by its
    equation for the recompute policy (`product_scope`)."""
    with product_scope(eq):
        if eq == "bshk,hkd->bsd":
            return x.reshape(*x.shape[:-2], -1) @ w.reshape(-1, w.shape[-1])
        return _proj(x, w)


#: the attention's query chunk (`attention`'s default ``chunk``)
ATTN_CHUNK = 1024


def _rows_whole(rows: int, chunk: int = ATTN_CHUNK) -> bool:
    """True where ``rows`` of the sequence-parallel fallback are more than
    one query chunk of ``chunk`` rows and split over more than one rank:
    the reference's partitioner splits each chunk's query rows (its pin
    inside the chunk loop), a split that does not reach back through the
    chunking, so the projections around the loop run on the whole rows
    (`_whole_product`; xlstm's mLSTM and sLSTM, `models.xlstm`).  Measured
    on the decoder-only toy (8 heads on the 16-way ``model`` axis), on
    whisper's and on xlstm's (4 heads), all at 2,048 rows."""
    return rows > chunk and _seq_ranks() > 1


def _gathered_grad(x) -> dict:
    """`einsum`'s ``gathered_grad`` for a ``whole_forward`` product of the
    rows ``x`` split over ``model``: where the batch's rows split over
    two mesh axes (the multipod's ``pod`` and ``data``), the reference's
    partitioner computes the weight's gradient from the gathered rows
    (whole on every model rank); where they split over one (the pod's
    ``data``), from each rank's share (a partial sum), whatever the rows
    a rank.  Measured on the decoder-only and whisper toys at one and two
    rows a rank on both meshes."""
    if not is_dtensor(x):
        return {"gathered_grad": False}
    spec = resolve(("batch",), (x.shape[0],))
    return {"gathered_grad": bool(spec) and isinstance(spec[0], tuple)}


def _whole_product(x, w, eq: str, w_logical: tuple):
    """``einsum(eq, x, w)`` with ``x`` whole over ``model`` (its rows
    gathered) and the weight gathered over its ZeRO-3 dims: the product
    and the activation's gradient whole on every model rank, the weight's
    gradient on each rank's share (``share_grad``), as the reference's
    partitioner runs the projections around a chunked attention
    (`_rows_whole`)."""
    x = shard(x, "batch", *(None,) * (x.ndim - 1))
    return reduce_partial(einsum(eq, x, gather_fsdp(w, w_logical),
                                 _plain_product, share_grad="model"))


def splits_contraction(cfg) -> bool:
    """Whether a decode step's attention projections and logits split a
    small activation's contraction (`_split_contraction`).  Not where the
    step runs the sequence-parallel chunked attention: a cross attention
    (an encoder's or a vision context's) whose heads are too few to split
    ``model``.  The reference pins that attention's padded query chunk
    over ``seq`` (its ``_chunked_attention``), and from that pin its
    partitioner runs every projection of the step whole; a decoder-only
    step of the same widths, which reads its cache and pins no ``seq``,
    splits them (both measured on the toys)."""
    cross = cfg.n_encoder_layers > 0 or cfg.cross_attn_every > 0
    return not cross or heads_tp_available(cfg.n_heads)


def _split_contraction(x, w, eq: str):
    """``(x, w)``, where both leave a mesh dim whole (the K/V projection
    of KV heads too few to split the ``model`` axis) and the activation
    is the smaller (a decode step's), split over that dim along w's
    first dim, which ``eq`` contracts with one of x's: the product's
    partial sums are then reduced (`reduce_partial`), where DTensor
    would compute the whole product on every rank of that dim.  A larger
    activation (a prefill's) is left whole, the product computed on
    every rank, as the reference's partitioner chooses."""
    if not (is_dtensor(x) and is_dtensor(w)) or \
            x.to_local().numel() >= w.to_local().numel():
        return x, w
    mesh = w.device_mesh
    x_labels, w_labels = eq.split("->")[0].split(",")
    j = x_labels.index(w_labels[0])
    xp, wp = list(x.placements), list(w.placements)
    for i, (a, b) in enumerate(zip(xp, wp)):
        n = mesh.size(i)
        if (a == b == Replicate() and n > 1 and x.shape[j] % n == 0
                and Shard(j) not in xp and Shard(0) not in wp):
            xp[i], wp[i] = Shard(j), Shard(0)
    if xp == list(x.placements):
        return x, w
    return x.redistribute(mesh, xp), w.redistribute(mesh, wp)


def _model_dim(mesh) -> int:
    """The index of the ``model`` axis among a DeviceMesh's dims."""
    return list(mesh.mesh_dim_names).index("model")


def transposed_product(x, w, eq: str, product=None):
    """``einsum(eq, x, w)`` for a weight split over its ZeRO-3 dim on a
    mesh dim of the ``model`` axis's size and whole over ``model`` (on the
    pod: the K/V projection of KV heads too few to split it, zamba2's
    ``w_cat``), as the reference's partitioner runs it: the weight's
    shard is permuted to the ``model`` axis (`parallel.axes.
    transpose_shard`, one all-to-all of the shard), so that ``model``
    splits the contracted dim.  Where the rank's output is smaller than
    the weight, the activation is split there too and the partial sums
    reduced (``whole_grad``: the activation's gradient whole); else the
    weight is gathered over ``model`` and the product runs whole
    (``whole_forward``).  Either way the weight's gradient runs on each
    rank's own rows of it, is reduced over the batch ranks and permuted
    back.  ``None`` where the weight is not so laid out."""
    if not (is_dtensor(x) and is_dtensor(w)):
        return None
    mesh = w.device_mesh
    if "model" not in mesh.mesh_dim_names:
        return None
    m = _model_dim(mesh)
    src = [i for i, p in enumerate(w.placements) if isinstance(p, Shard)]
    if len(src) != 1 or not transposable(w, src[0], m):
        return None
    ins, out = eq.split("->")
    lx, lw = ins.split(",")
    sizes = dict(zip(lx, x.to_local().shape))
    sizes.update(zip(lw, w.shape))
    y = math.prod(sizes[c] for c in out)
    # a split the output keeps (the attention output's weight, its
    # ``embed`` dim last) runs whole forward, as the reference's does
    kept = lw[w.placements[src[0]].dim] in out
    mode = ("whole_grad" if y < w.numel() and not kept
            else "whole_forward")
    wt = transpose_shard(w, src[0], m)
    return reduce_partial(einsum(eq, x, wt, product or _plain_product,
                                 **{mode: "model"}))


def _serving_x_placements(x, w, eq: str, w_logical: tuple):
    """The placements of the activation ``x`` in the weight-stationary
    product (`serving_matmul`): split as the weight ``w`` on the labels
    they share, whole elsewhere."""
    w_spec = resolve(w_logical, w.shape)
    x_dims, w_dims = eq.split("->")[0].split(",")
    w_axes = {dim: (w_spec[i] if i < len(w_spec) else None)
              for i, dim in enumerate(w_dims)}
    return placements(P(*(w_axes.get(dim) for dim in x_dims)),
                      x.device_mesh)


def serving_input(x, w, eq: str, w_logical: tuple):
    """``x`` brought once to the layout `serving_matmul` multiplies it in
    against ``w``, for products that share it (the q/k/v projections,
    the FFN's gate and up), as the reference's partitioner moves a
    shared operand once.  The identity outside serving mode."""
    if not (is_dtensor(x) and is_dtensor(w) and serving_mode()
            and _mesh() is not None):
        return x
    return _relayout(x, _serving_x_placements(x, w, eq, w_logical))


def _relayout(x, want: list):
    """``x`` redistributed to ``want``.  An activation split on its rows
    over the data axis and on dim ``k`` over ``model`` (the FFN's hidden
    state) that must split ``k`` over both, data-major, moves as the
    reference's partitioner moves it on the pod: an all-to-all over data
    (its rows for shares of its ``k`` slice), then the shares permuted
    between the two axes; DTensor would gather it over ``model`` first."""
    pl = list(x.placements)
    if pl == want:
        return x
    mesh = x.device_mesh
    k = want[-1].dim if isinstance(want[-1], Shard) else 0
    if (mesh.mesh_dim_names == ("data", "model") and k > 0
            and pl == [Shard(0), Shard(k)] and want == [Shard(k)] * 2
            and mesh.size(0) == mesh.size(1)):
        n = mesh.size(0)
        chunks = x.to_local().unflatten(k, (n, -1)).movedim(k, 0)
        rows = all_to_all(chunks, None, None, mesh.get_group(0)).flatten(0, 1)
        return DTensor.from_local(transpose_local(rows, mesh, (0, 1)), mesh,
                                  want, run_check=False, shape=x.shape,
                                  stride=x.stride())
    return x.redistribute(mesh, want)


def serving_matmul(x, w, eq: str, w_logical: tuple, *,
                   transpose: bool = False, split: bool = True):
    """Weight-stationary projection for serving, the reference's.

    ``x @ w`` where the serving rules shard w's contraction dim(s) (they
    put ``embed`` / ``mlp`` on the data axis).  Left to itself the
    partitioner would all-gather the weights every step, the whole model
    per decode step.  Here x is redistributed to w's layout on the labels
    they share (decode activations are small; `serving_input` does it
    once for products that share ``x``), each rank contracts its local x
    against its resident weight shard, and the partial sums are
    all-reduced over the contraction axes: one ``Partial`` placement and
    one redistribute.  Outside serving mode, the plain product; on a mesh
    of the weight gathered over its ZeRO-3 dims (`gather_fsdp`), its
    partial sums reduced (`reduce_partial`), or, with ``transpose``, its
    shard permuted to the ``model`` axis where the reference's
    partitioner does so (`transposed_product`), and with ``split`` a small
    activation's contraction split (`_split_contraction`; `splits_contraction`
    says where the reference's partitioner does not).
    """
    if not is_dtensor(w):
        return _plain_product(eq, x, w)
    if not (serving_mode() and _mesh() is not None):
        if transpose:
            y = transposed_product(x, w, eq)
            if y is not None:
                return y
        w = gather_fsdp(w, w_logical)
        if split:
            x, w = _split_contraction(x, w, eq)
        return reduce_partial(einsum(eq, x, w, _plain_product))
    mesh = w.device_mesh
    names = list(mesh.mesh_dim_names)
    w_spec = resolve(w_logical, w.shape)
    ins, out = eq.split("->")
    x_dims, w_dims = ins.split(",")
    w_axes = {dim: (w_spec[i] if i < len(w_spec) else None)
              for i, dim in enumerate(w_dims)}
    # contraction = w dims absent from the output -> all-reduce there
    reduce_axes = [ax for dim in w_dims if dim not in out
                   for ax in ((w_axes[dim],) if isinstance(w_axes[dim], str)
                              else w_axes[dim] or ())]
    out_place = placements(P(*(w_axes.get(dim) for dim in out)), mesh)
    for ax in reduce_axes:
        out_place[names.index(ax)] = Partial()
    xl = _relayout(x, _serving_x_placements(x, w, eq, w_logical)).to_local()
    wl = w.redistribute(mesh, placements(w_spec, mesh)).to_local()
    y = DTensor.from_local(_plain_product(eq, xl, wl), mesh, out_place,
                           run_check=False)
    return y.redistribute(mesh, [Replicate() if isinstance(pl, Partial)
                                 else pl for pl in out_place])


def local_for(t, like):
    """``t``'s local shard, for a product per rank against the activation
    ``like``: over a mesh dim where ``like`` is split and ``t`` whole, its
    gradient is a partial sum (each rank's rows contribute)."""
    if not is_dtensor(t):
        return t
    grad = [Partial() if q == Replicate() and isinstance(a, Shard) else q
            for q, a in zip(t.placements, like.placements)]
    return t.to_local(grad_placements=grad)


def partial_over_model(t):
    """Grad placements of an activation that every ``model`` rank reads
    whole: a partial sum over ``model``."""
    names = t.device_mesh.mesh_dim_names
    return [Partial() if n == "model" else q
            for n, q in zip(names, t.placements)]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config type for every assigned architecture family."""

    name: str = "model"
    family: str = "dense"          # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 1024
    d_head: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False         # qwen2 uses QKV bias
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    use_flash_kernel: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 2
    dense_residual: bool = False   # arctic: dense FFN in parallel w/ MoE
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 64            # Mamba2 state size N
    ssm_expand: int = 2            # d_inner = expand * d_model
    ssm_head_dim: int = 64         # Mamba2 head dim P
    ssm_chunk: int = 128           # SSD chunk length
    conv_kernel: int = 4
    attn_every: int = 6            # zamba: shared attn block period
    slstm_every: int = 8           # xlstm: sLSTM block period
    # --- cross-attention (vlm) / encoder-decoder (audio) ---
    cross_attn_every: int = 0      # vlm: cross-attn layer period
    n_encoder_layers: int = 0      # whisper encoder depth
    n_ctx_tokens: int = 1500       # stub frontend tokens (frames/patches)
    # --- attention flavor ---
    attn_logit_softcap: float = 0.0   # grok-1 uses 30.0
    max_seq: int = 8192            # rope table length for training

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim


# ---------------------------------------------------------------------------
# primitives


def cast_params(cfg: ModelConfig, tree):
    """Cast the fp32 leaves of a param tree to the compute dtype."""
    if isinstance(tree, dict):
        return {k: cast_params(cfg, v) for k, v in tree.items()}
    if tree.dtype == torch.float32:
        return tree.to(cfg.dtype)
    return tree


#: the ops by which a product marked by `product_scope` computes its
#: output, and reduces its partial sums on a mesh: what the ``dots``
#: policy saves
_PRODUCT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default,
                torch.ops._c10d_functional.all_reduce.default)


def _save_dots(ctx, func, *args, **kwargs):
    """The ``dots`` policy: save the output of every product with no
    batch dims (marked by its equation, `product_scope`: not told by the
    aten op, since an einsum without batch dims may run as ``bmm`` over a
    batch of one), its partial sums reduced where it runs on a mesh (the
    reference saves the partitioned ``dot_general``'s result); recompute
    everything else."""
    if func in _PRODUCT_OPS and in_no_batch_product():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


#: recompute policies: the reference's plain ``jax.checkpoint`` and its
#: ``checkpoint_dots_with_no_batch_dims``
REMAT_POLICIES = ("full", "dots")


def recompute(fn, params, *args, policy: str = "full"):
    """``fn(*args)``; when autograd records it (grad mode on and a leaf
    of ``params``, the block's weights, requiring grad) its activations
    are dropped after the forward and recomputed in the backward pass,
    as the reference's ``jax.checkpoint`` does: the same values, one
    block's activations alive at a time.  ``policy="dots"`` keeps the
    outputs of the products with no batch dims (the projections and the
    FFN's) and recomputes the rest (the norms, the rotation, the
    attention), the reference's ``checkpoint_dots_with_no_batch_dims``
    (``torch.utils.checkpoint``'s selective mode)."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"recompute policy {policy!r}: one of "
                         f"{REMAT_POLICIES}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in leaves(params)):
        # the recompute may run on the autograd engine's device thread:
        # it re-installs the sharding rules (thread-local) of the forward
        mesh, rules = _mesh(), _rules()

        def rerun(*a):
            with sharding_rules(mesh, rules):
                return fn(*a)

        kw = {}
        if policy == "dots":
            kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _save_dots)
        return checkpoint(rerun, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)
    return fn(*args)


def recomputing() -> bool:
    """Whether the running code is a block's recompute in the backward
    pass (`recompute`: autograd runs the node that unpacks the block's
    activations), where the reference's partitioner may plan an op
    otherwise than in the forward."""
    return torch._C._current_autograd_node() is not None


def _loop_counter():
    """The innermost active dispatch mode that counts `scan` loops by
    their trip count (one with a ``loop`` method: the dry-run's
    ``StepCounter``), or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if hasattr(mode, "loop"):
            return mode
    return None


def scan(name: str, body, state, xs):
    """The reference's ``lax.scan`` over the leading dim of ``xs``:
    ``state, y = body(state, xs[t])`` for every step ``t`` in order;
    returns the last state and the steps' outputs, a list.

    Under a loop counter (`_loop_counter`) whose ``loop(name, trip)``
    gives a loop, only the steps it names run (``loop.steps``, each
    inside ``loop.step(t)``), the counter standing in for the others;
    each left-out step's output is a detached view of the last output
    that ran before it, so that what follows the loop runs at its full
    shape.  Otherwise every step runs."""
    trip = xs.shape[0]
    counter = _loop_counter()
    loop = counter.loop(name, trip) if counter is not None else None
    if loop is None:
        ys = []
        for t in range(trip):
            state, y = body(state, xs[t])
            ys.append(y)
        return state, ys
    ys = [None] * trip
    for t in loop.steps:
        with loop.step(t):
            state, ys[t] = body(state, xs[t])
    for t in range(1, trip):
        if ys[t] is None:
            ys[t] = ys[t - 1].detach()
    return state, ys


def rmsnorm(x, w, eps: float = 1e-5):
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def rope_table(positions, head_dim: int, theta: float):
    """positions (...,) -> cos/sin tables (..., head_dim//2)."""
    half = head_dim // 2
    freq = torch.pow(
        torch.tensor(theta, dtype=torch.float32, device=positions.device),
        -torch.arange(0, half, dtype=torch.float32,
                      device=positions.device) / half)
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (..., S, H, D); cos/sin (..., S, D//2) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def heads_tp_available(n: int) -> bool:
    """True if ``n`` heads can shard the ``model`` axis (divisibility)
    under the installed rules; False with no rules.  True where
    ``REPRO_NO_SP`` is set non-empty (the reference's A/B knob, read at
    each call: the sequence-parallel fallback off, the heads whole on
    every model rank where they do not divide it)."""
    if os.environ.get("REPRO_NO_SP"):
        return True
    spec = resolve(("heads",), (n,))
    return len(spec) > 0 and spec[0] is not None


def probs_dtype() -> torch.dtype:
    """The dtype probabilities and V are rounded to before the chunked
    route's P·V product (and the mLSTM's decay-weighted scores before
    theirs), which accumulate in fp32: bf16, or fp32 where
    ``REPRO_FP32_PROBS`` is set non-empty (the reference's
    ``_probs_dtype``, an A/B knob read at each call).  The flash routes
    do not read it: ``sm90_bf16`` rounds P to bf16 by design, and
    ``cuda_core`` is fp32."""
    return torch.float32 if os.environ.get("REPRO_FP32_PROBS") \
        else torch.bfloat16


def _chunked_attention(q, k, v, *, causal: bool, chunk: int,
                       softcap: float = 0.0, q_start: int | None = None):
    """Query-chunked online attention, fp32 softmax, grouped GQA.

    q (B,S,Hq,D); k,v (B,T,Hkv,D), Hq % Hkv == 0.  The GQA group dim is
    contracted by einsum, so the repeated KV is never materialized.
    Loops over query chunks so peak score memory is (B,Hkv,G,chunk,T).
    Probabilities are rounded to `probs_dtype()` (bf16 by default)
    before the PV product, which accumulates in fp32, as the reference's.
    ``q_start``: the position of q's first row among k's (default
    ``T - S``: q is the last S rows), for a slice of the rows.
    """
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / (d ** 0.5)
    chunk = min(chunk, max(-(-s // 128) * 128, 128))   # no padding waste
    nq = -(-s // chunk)
    qp = F.pad(q, (0, 0, 0, 0, 0, nq * chunk - s))
    qc = qp.reshape(b, nq, chunk, hkv, g, d)
    kf = k.float()
    pdt = probs_dtype()
    vb = v.to(pdt).float()
    kpos = torch.arange(t, device=q.device)[None, :]
    q_start = t - s if q_start is None else q_start
    outs = []
    for i in range(nq):
        sc = torch.einsum("bchgd,bthd->bchgt", qc[:, i].float(), kf) * scale
        if softcap > 0.0:
            sc = softcap * torch.tanh(sc / softcap)
        if causal:
            qpos = (i * chunk + torch.arange(chunk, device=q.device)[:, None]
                    + q_start)                    # (c,1)
            msk = (kpos <= qpos)[None, :, None, None, :]
            sc = torch.where(msk, sc, float("-inf"))
        m = sc.amax(-1, keepdim=True).detach()   # jax.lax.stop_gradient
        p = torch.exp(sc - torch.where(torch.isfinite(m), m, 0.0))
        l = p.sum(-1, keepdim=True).clamp_min(1e-30)
        o = torch.einsum("bchgt,bthd->bchgd",
                         p.to(pdt).float(), vb)
        outs.append((o / l).to(q.dtype))
    o = torch.stack(outs, 1).reshape(b, nq * chunk, hq, d)
    return o[:, :s]


def _attention_by_rank(fn, q, k, v):
    """``fn(q, k, v, q_start)`` on each rank's shards of DTensors q
    (B,S,Hq,D) and k, v (B,T,Hkv,D), as the reference's partitioner
    splits the attention: over a mesh dim that splits the batch, K/V
    split alike; one that splits the query heads takes the KV heads they
    group with (split alike where the KV heads divide, else each rank
    slices its group's heads from the whole K/V: GQA with fewer KV heads
    than the dim's ranks); one that splits the query rows (the
    sequence-parallel branch) takes the whole K/V and its rows'
    positions.  The output keeps q's placements; the K/V gradients are
    partial sums over the dims whose ranks share K/V, reduced at once
    (`reduce_grad_partial`).  Run per rank, no DTensor view of a split
    dim is needed."""
    mesh, pl = q.device_mesh, list(q.placements)
    kv_pl, grad_pl, sliced = [], [], False
    for i, p in enumerate(pl):
        if p == Shard(0) or (p == Shard(2) and k.placements[i] == Shard(2)):
            kv_pl.append(p), grad_pl.append(p)
        else:
            sliced |= p == Shard(2)
            kv_pl.append(Replicate())
            grad_pl.append(Partial() if isinstance(p, Shard) else p)
    ql = q.to_local()
    _, offset = compute_local_shape_and_global_offset(q.shape, mesh, pl)
    kl, vl = (reduce_grad_partial(x).redistribute(mesh, kv_pl).to_local(
        grad_placements=grad_pl) for x in (k, v))
    if sliced:
        g = q.shape[2] // k.shape[2]
        k0 = offset[2] // g
        k1 = (offset[2] + ql.shape[2] - 1) // g + 1
        kl, vl = kl[:, :, k0:k1], vl[:, :, k0:k1]
    q_start = offset[1] + k.shape[1] - q.shape[1]
    return DTensor.from_local(fn(ql, kl, vl, q_start), mesh, pl,
                              run_check=False)


def attention(cfg: ModelConfig, q, k, v, *, causal: bool,
              chunk: int = ATTN_CHUNK):
    """GQA attention dispatch (chunked path or the flash kernel).

    q (B,S,Hq,D); k,v (B,T,Hkv,D).  Returns (B,S,Hq,D).  The flash
    kernel takes no logit softcap: with ``cfg.attn_logit_softcap`` set
    the flash route raises rather than drop it.  On DTensors the chunked
    path runs per rank (`_attention_by_rank`).
    """
    if cfg.use_flash_kernel:
        if cfg.attn_logit_softcap > 0.0:
            raise ValueError(
                f"{cfg.name}: the flash kernel does not apply the attention "
                f"logit softcap ({cfg.attn_logit_softcap}); set "
                f"use_flash_kernel=False to take the chunked route, which "
                f"does")
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal)
        return o.transpose(1, 2)

    rows = q.shape[1]

    def chunked(q, k, v, q_start=None):
        # the reference's chunk of the whole sequence; a rank holding a
        # share of the query rows (seq-parallel) takes that share of each
        # chunk, padding nothing the reference does not
        c = min(chunk, max(-(-rows // 128) * 128, 128)) * q.shape[1] // rows
        return _chunked_attention(q, k, v, causal=causal, chunk=max(c, 1),
                                  softcap=cfg.attn_logit_softcap,
                                  q_start=q_start)

    if not is_dtensor(q):
        return chunked(q, k, v)
    if heads_tp_available(q.shape[2]):
        return _attention_by_rank(chunked, q, k, v)
    # sequence-parallel fallback, the reference's: heads that cannot
    # split the model axis would replicate the scores across it, so the
    # query rows split over ``seq`` instead (K/V shared); the output's
    # rows stay split for `attn_out`, which gathers them as the
    # reference's partitioner does before the output projection.  Rows
    # too few to split (a decode step's one): the reference splits the
    # chunk it pads them to (``chunked`` reads ``rows`` when it runs),
    # and the real rows' output is reduced from the ranks that hold them
    s = q.shape[1]
    if s % _seq_ranks():
        c = min(chunk, max(-(-s // 128) * 128, 128))
        rows = -(-s // c) * c
        q = _pad_rows(q, rows)
    o = _attention_by_rank(chunked, shard(q, "batch", "seq", None, None),
                           k, v)
    return o if rows == s else _leading_rows(o, s)


def _pad_rows(q, n: int):
    """The DTensor ``q`` (B,S,...), its rows whole on every rank, padded
    with zero rows to ``n``, each rank on its shard (DTensor's own pad
    plans a redistribution some torch versions cannot build)."""
    if Shard(1) in q.placements:
        raise ValueError("the rows to pad are split")
    pad = [0, 0] * (q.ndim - 2) + [0, n - q.shape[1]]
    shape = (q.shape[0], n, *q.shape[2:])
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(F.pad(q.to_local(), pad), q.device_mesh,
                              q.placements, run_check=False, shape=shape,
                              stride=stride)


def _seq_ranks() -> int:
    """The ranks the ``seq`` axis splits a dim over, under the installed
    rules and mesh."""
    spec = resolve(("seq",))
    if not spec or _mesh() is None:
        return 1
    sizes = axis_sizes(_mesh())
    axes = (spec[0],) if isinstance(spec[0], str) else spec[0]
    return math.prod(sizes[a] for a in axes)


def _leading_rows(o, n: int):
    """The first ``n`` rows (dim 1) of the DTensor ``o``, whose rows are
    split: each rank keeps those of its slice and the ranks' shares are
    summed (one all-reduce of the ``n`` rows), the dims ``o`` splits
    otherwise kept."""
    mesh, pl = o.device_mesh, list(o.placements)
    _, offset = compute_local_shape_and_global_offset(o.shape, mesh, pl)
    local = o.to_local()
    out = local.new_zeros((local.shape[0], n, *local.shape[2:]))
    lo, hi = offset[1], min(offset[1] + local.shape[1], n)
    if hi > lo:
        out[:, lo:hi] = local[:, :hi - lo]
    return reduce_partial(DTensor.from_local(
        out, mesh, [Partial() if p == Shard(1) else p for p in pl],
        run_check=False))


# ---------------------------------------------------------------------------
# attention + FFN layers (param dicts)


class ShapesOnly:
    """Stands in for a `torch.Generator`: the init functions then build
    meta tensors (shapes and dtypes, no storage or values)."""

    device = torch.device("meta")


def _normal(gen, shape, scale):
    draw = None if isinstance(gen, ShapesOnly) else gen
    return torch.randn(shape, generator=draw, dtype=torch.float32,
                       device=gen.device) * scale


def _zeros(gen, shape):
    return torch.zeros(shape, dtype=torch.float32, device=gen.device)


def init_attn(cfg: ModelConfig, gen: torch.Generator, scale: float,
              lead: tuple = ()):
    """Attention weights drawn from ``gen`` on its device; ``lead``
    prepends stacking axes (the layer axis)."""
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = dict(
        wq=_normal(gen, (*lead, d, hq, dh), scale),
        wk=_normal(gen, (*lead, d, hkv, dh), scale),
        wv=_normal(gen, (*lead, d, hkv, dh), scale),
        wo=_normal(gen, (*lead, hq, dh, d), scale),
    )
    if cfg.qkv_bias:
        p["bq"] = _zeros(gen, (*lead, hq, dh))
        p["bk"] = _zeros(gen, (*lead, hkv, dh))
        p["bv"] = _zeros(gen, (*lead, hkv, dh))
    return p


def attn_specs(cfg: ModelConfig):
    # 'embed' == 'fsdp' under training rules; under serving rules it
    # keeps the d_model dim data-sharded (resident weights) instead of
    # replicating when the head count does not divide the model axis.
    p = dict(wq=("embed", "heads", None), wk=("embed", "kv_heads", None),
             wv=("embed", "kv_heads", None), wo=("heads", None, "embed"))
    if cfg.qkv_bias:
        p.update(bq=("heads", None), bk=("kv_heads", None),
                 bv=("kv_heads", None))
    return p


def _proj(x, w):
    """x (..., d) @ w (d, *out) -> (..., *out)."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1],
                                                   *w.shape[1:])


def attn_qkv(cfg: ModelConfig, p, x, positions):
    """Project + rope.  x (B,S,d) -> q (B,S,Hq,D), k/v (B,S,Hkv,D)."""
    dt = cfg.dtype
    specs = attn_specs(cfg)
    eq = "bsd,dhk->bshk"
    if (_rows_split(x) and not serving_mode()
            and heads_tp_available(cfg.n_heads)):
        return _qkv_split_rows(cfg, p, x, positions)
    x = reduce_grad_partial(x)
    if is_dtensor(x) and not heads_tp_available(cfg.n_heads):
        if _rows_whole(x.shape[1]):
            q, k, v = (_whole_product(x, p[w].to(dt), eq, specs[w])
                       for w in ("wq", "wk", "wv"))
            return _qkv_rotated(cfg, p, q, k, v, positions)
        # the sequence-parallel fallback, as the reference's partitioner
        # propagates it back from the attention: the projections run on
        # each model rank's rows, and the pins below gather q, k and v
        x = shard(x, "batch", "seq", None)
    x = serving_input(x, p["wq"], eq, specs["wq"])
    # weights whose heads cannot split the model axis outside the
    # sequence-parallel fallback (GQA's K/V; every weight under
    # ``REPRO_NO_SP``): the reference's partitioner permutes their ZeRO-3
    # shards to the model axis (`transposed_product`; a weight split over
    # ``model`` is left as it is)
    q, k, v = (serving_matmul(x, p[w].to(dt), eq, specs[w],
                              transpose=heads_tp_available(cfg.n_heads),
                              split=splits_contraction(cfg))
               for w in ("wq", "wk", "wv"))
    return _qkv_rotated(cfg, p, q, k, v, positions)


def _qkv_split_rows(cfg: ModelConfig, p, x, positions):
    """`attn_qkv` of normed rows ``x`` split over ``model`` (the residual
    under ``REPRO_SP_RESIDUAL``), heads that split the ``model`` axis:
    the rows all-gathered, and the projections as without the knob, but
    for K/V heads too few to split it (GQA), whose projections run on
    each rank's rows against the weights gathered whole, their outputs'
    rows then gathered, and the input's gradient computed whole from the
    outputs' (`parallel.axes.gathered_out`): the reference's partitioner
    runs them so under the knob, where without it it runs their forward
    whole on every model rank (measured at full size on tinyllama-1.1b's
    pod ``train_4k``)."""
    dt, specs, eq = cfg.dtype, attn_specs(cfg), "bsd,dhk->bshk"
    whole = reduce_grad_partial(shard(x, "batch", None, None))
    q = serving_matmul(whole, p["wq"].to(dt), eq, specs["wq"])
    if heads_tp_available(cfg.n_kv_heads):
        k, v = (serving_matmul(whole, p[w].to(dt), eq, specs[w])
                for w in ("wk", "wv"))
    else:
        k, v = (gathered_out(eq, x, gather_fsdp(p[w].to(dt), specs[w]),
                             "model", _plain_product) for w in ("wk", "wv"))
    return _qkv_rotated(cfg, p, q, k, v, positions)


def _qkv_rotated(cfg: ModelConfig, p, q, k, v, positions):
    """`attn_qkv`'s biases, rotation and layout pins."""
    dt = cfg.dtype
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta)
    q = shard(apply_rope(q, cos, sin), "batch", None, "heads", None)
    k = shard(apply_rope(k, cos, sin), "batch", None, "kv_heads", None)
    return q, k, shard(v, "batch", None, "kv_heads", None)


def attn_out(cfg: ModelConfig, p, o):
    """o (B,S,Hq,D) -> (B,S,d).  The sequence-parallel fallback's rows
    (split over ``model``) are gathered and the projection runs whole on
    every model rank, its backward on each rank's own rows, as the
    reference's partitioner runs it (``whole_forward``)."""
    wo, names = p["wo"].to(cfg.dtype), attn_specs(cfg)["wo"]
    if (is_dtensor(o) and not serving_mode() and _rows_whole(o.shape[1])
            and not heads_tp_available(cfg.n_heads)):
        return _whole_product(o, wo, "bshk,hkd->bsd", names)
    if not serving_mode() and _rows_split(o):
        return reduce_partial(einsum("bshk,hkd->bsd", o,
                                     gather_fsdp(wo, names), _plain_product,
                                     whole_forward="model",
                                     **_gathered_grad(o)))
    return serving_matmul(o, wo, "bshk,hkd->bsd", names,
                          transpose=heads_tp_available(cfg.n_heads),
                          split=splits_contraction(cfg))


def _rows_split(t) -> bool:
    """Whether the DTensor ``t``'s rows (dim 1) split over ``model``."""
    return (is_dtensor(t) and "model" in t.device_mesh.mesh_dim_names
            and t.placements[_model_dim(t.device_mesh)] == Shard(1))


def add_attn_out(cfg: ModelConfig, p, x, o):
    """The residual ``x`` (B,S,d) plus `attn_out` of ``o``.  Where both
    split their rows over ``model`` (the sequence-parallel fallback's
    output into a residual whose rows stay split), the projection runs on
    each rank's rows and the sum stays split, as the reference's
    partitioner runs it; otherwise as `attn_out`."""
    if (not serving_mode() and _rows_split(o) and _rows_split(x)
            and not _rows_whole(o.shape[1])):
        wo, names = p["wo"].to(cfg.dtype), attn_specs(cfg)["wo"]
        return x + reduce_partial(einsum("bshk,hkd->bsd", o,
                                         gather_fsdp(wo, names),
                                         _plain_product))
    return x + attn_out(cfg, p, o)


def cross_q(cfg: ModelConfig, p, h):
    """The query (B,S,Hq,D) of a cross-attention from the states h
    (B,S,d): the attention's ``wq`` projection, no bias and no rotation.
    States whose rows are split over ``model`` (whisper's decoder, the
    sequence-parallel fallback) are gathered and the projection runs
    whole on every model rank, its backward on each rank's rows, as the
    reference's partitioner runs it (``whole_forward``)."""
    wq, names = p["wq"].to(cfg.dtype), attn_specs(cfg)["wq"]
    h = reduce_grad_partial(h)
    if (is_dtensor(h) and not serving_mode() and _rows_whole(h.shape[1])
            and not heads_tp_available(cfg.n_heads)):
        return _whole_product(h, wq, "bsd,dhk->bshk", names)
    if not serving_mode() and _rows_split(h):
        return reduce_partial(einsum("bsd,dhk->bshk", h,
                                     gather_fsdp(wq, names), _plain_product,
                                     whole_forward="model",
                                     **_gathered_grad(h)))
    return serving_matmul(h, wq, "bsd,dhk->bshk", names,
                          transpose=heads_tp_available(cfg.n_heads),
                          split=splits_contraction(cfg))


def cross_kv(cfg: ModelConfig, p, ctx):
    """K/V of a cross-attention over context states ctx (B,T,d): the
    attention's ``wk``/``wv`` projections, no bias and no rotation.  On
    DTensors, with heads too few to split the ``model`` axis, the
    context's rows split over it, as the reference's partitioner
    propagates the sequence-parallel fallback back from the attention
    (which then gathers the K/V)."""
    specs = attn_specs(cfg)
    ctx = reduce_grad_partial(ctx)
    if is_dtensor(ctx) and not heads_tp_available(cfg.n_heads):
        if not serving_mode() and _rows_whole(ctx.shape[1]):
            return tuple(_whole_product(ctx, p[w].to(cfg.dtype),
                                        "btd,dhk->bthk", specs[w])
                         for w in ("wk", "wv"))
        ctx = shard(ctx, "batch", "seq", None)
    return tuple(serving_matmul(ctx, p[w].to(cfg.dtype), "btd,dhk->bthk",
                                specs[w],
                                transpose=heads_tp_available(cfg.n_heads))
                 for w in ("wk", "wv"))


def cross_attention(cfg: ModelConfig, p, q, ctx):
    """q's attention (B,S,Hq,D) over the K/V of the context states ctx
    (B,T,d), not causal.  On DTensors, with query heads that split the
    ``model`` axis over KV heads too few to (GQA), each rank projects
    only the KV heads its query heads group with (`_grouped_cross`), as
    the reference's partitioner splits that product."""
    if (is_dtensor(q) and not cfg.use_flash_kernel
            and heads_tp_available(cfg.n_heads)
            and not heads_tp_available(cfg.n_kv_heads)):
        return _grouped_cross(cfg, p, q, ctx)
    return attention(cfg, q, *cross_kv(cfg, p, ctx), causal=False)


def _grouped_cross(cfg: ModelConfig, p, q, ctx):
    """`cross_attention` per rank for GQA: each rank slices the KV heads
    its query heads group with from its ZeRO-3 shard of the K/V weights
    (whole over ``model``) and gathers that slice over the batch ranks,
    and projects its batch share of the context's rows.  The weights'
    gradients are partial sums over ``model`` (each rank's slice)."""
    mesh, pl = q.device_mesh, list(q.placements)
    ql = q.to_local()
    _, offset = compute_local_shape_and_global_offset(q.shape, mesh, pl)
    g = cfg.n_heads // cfg.n_kv_heads
    k0, k1 = offset[2] // g, (offset[2] + ql.shape[2] - 1) // g + 1
    ctx_l = reduce_grad_partial(ctx).redistribute(mesh, [
        x if x == Shard(0) else Replicate() for x in pl])
    ctx_l = local_for(ctx_l, q)

    def heads(w):
        grad = [Partial() if x == Replicate() else x for x in w.placements]
        out = w.to_local(grad_placements=grad)[:, k0:k1]
        for i, x in enumerate(w.placements):
            if x == Shard(0):
                out = gather_share(out, 0, mesh, mesh.mesh_dim_names[i])
        return out

    k, v = (_proj(ctx_l, heads(p[w].to(cfg.dtype))) for w in ("wk", "wv"))
    rows = q.shape[1]
    chunk = min(1024, max(-(-rows // 128) * 128, 128))
    o = _chunked_attention(ql, k, v, causal=False, chunk=chunk,
                           softcap=cfg.attn_logit_softcap)
    return DTensor.from_local(o, mesh, pl, run_check=False)


def self_attention(cfg: ModelConfig, p, x, positions, *, causal=True):
    q, k, v = attn_qkv(cfg, p, x, positions)
    o = attention(cfg, q, k, v, causal=causal)
    return attn_out(cfg, p, o)


def init_mlp(cfg: ModelConfig, gen: torch.Generator, scale: float,
             lead: tuple = (), kind: str = "swiglu",
             d_ff: int | None = None):
    """FFN weights drawn from ``gen``: SwiGLU, or ``kind="gelu"`` (with
    biases, whisper's); ``d_ff`` overrides ``cfg.d_ff``."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if kind == "swiglu":
        return dict(
            w_gate=_normal(gen, (*lead, d, f), scale),
            w_up=_normal(gen, (*lead, d, f), scale),
            w_down=_normal(gen, (*lead, f, d), scale),
        )
    return dict(
        w_up=_normal(gen, (*lead, d, f), scale),
        b_up=_zeros(gen, (*lead, f)),
        w_down=_normal(gen, (*lead, f, d), scale),
        b_down=_zeros(gen, (*lead, d)),
    )


def mlp_specs(kind: str = "swiglu"):
    if kind == "swiglu":
        return dict(w_gate=("embed", "mlp"), w_up=("embed", "mlp"),
                    w_down=("mlp", "embed"))
    return dict(w_up=("embed", "mlp"), b_up=("mlp",),
                w_down=("mlp", "embed"), b_down=(None,))


def mlp(cfg: ModelConfig, p, x, kind: str = "swiglu"):
    """SwiGLU FFN, (silu(x Wg) * x Wu) Wd; or ``kind="gelu"``,
    gelu(x Wu + bu) Wd + bd with the tanh approximation, which is
    ``jax.nn.gelu``'s default."""
    dt = cfg.dtype
    specs = mlp_specs(kind)

    def mm(a, name, eq="bsd,df->bsf"):
        return serving_matmul(a, p[name].to(dt), eq, specs[name])

    x = serving_input(reduce_grad_partial(x), p["w_up"], "bsd,df->bsf",
                      specs["w_up"])
    if kind == "swiglu":
        h = shard(F.silu(mm(x, "w_gate")) * mm(x, "w_up"),
                  "batch", None, "mlp")
        return mm(h, "w_down", "bsf,fd->bsd")
    h = F.gelu(mm(x, "w_up") + p["b_up"].to(dt), approximate="tanh")
    h = shard(h, "batch", None, "mlp")
    return mm(h, "w_down", "bsf,fd->bsd") + p["b_down"].to(dt)


def init_embedding(cfg: ModelConfig, gen: torch.Generator):
    p = dict(tok=_normal(gen, (cfg.vocab, cfg.d_model), 0.02),
             norm_f=torch.ones((cfg.d_model,), dtype=torch.float32,
                               device=gen.device))
    if not cfg.tie_embeddings:
        p["head"] = _normal(gen, (cfg.d_model, cfg.vocab), 0.02)
    return p


def embedding_specs(cfg: ModelConfig):
    p = dict(tok=("vocab", "embed"), norm_f=(None,))
    if not cfg.tie_embeddings:
        p["head"] = ("embed", "vocab")
    return p


def _embed_by_rank(tok, ids):
    """``tok[ids]`` for a DTensor table, each rank on its shards, as the
    reference's partitioner plans it: over a mesh dim that splits the
    embed dim every rank takes every id (its slice of each row); over
    one that splits the vocab, for fewer ids than vocab rows (a decode
    step), every rank looks every id up in its own slice of the vocab (0
    outside it) and the rows are partial sums; for more ids the table is
    gathered whole and the ids are split along the sequence (where it
    divides), so no rank looks up another's rows; elsewhere the rows
    follow the ids.  (DTensor's own indexing strategy fails in its
    backward on some torch versions.)  The table's gradient is partial
    where the ids were split and the table not."""
    mesh = tok.device_mesh
    t_pl, g_pl, i_pl, r_pl = [], [], [], []
    masked = False
    for m, (tp, ip) in enumerate(zip(tok.placements, ids.placements)):
        if tp == Shard(1):
            t_pl.append(tp), g_pl.append(tp), i_pl.append(Replicate())
            r_pl.append(Shard(ids.ndim))
            continue
        if tp == Shard(0) and ids.numel() < tok.shape[0]:
            masked = True
            t_pl.append(tp), g_pl.append(tp), i_pl.append(Replicate())
            r_pl.append(Partial())
            continue
        if tp == Shard(0) and ids.shape[1] % mesh.size(m) == 0:
            ip = Shard(1)
        t_pl.append(Replicate()), i_pl.append(ip), r_pl.append(ip)
        g_pl.append(Partial() if isinstance(ip, Shard) else Replicate())
    table = tok.redistribute(mesh, t_pl).to_local(grad_placements=g_pl)
    idx = ids.redistribute(mesh, i_pl).to_local().long()
    if masked:
        _, offset = compute_local_shape_and_global_offset(tok.shape, mesh,
                                                          t_pl)
        idx = idx - offset[0]
        inside = (idx >= 0) & (idx < table.shape[0])
        rows = torch.where(inside[..., None],
                           table[idx.clamp(0, table.shape[0] - 1)], 0.0)
    else:
        rows = table[idx]
    return DTensor.from_local(rows, mesh, r_pl, run_check=False)


def embed(cfg: ModelConfig, p, tokens):
    """tokens (B,S) -> (B,S,d) in the compute dtype (gather, then cast:
    the same values as casting the table first)."""
    if is_dtensor(p["tok"]):
        x = _embed_by_rank(p["tok"], tokens)
    else:
        x = p["tok"][tokens.long()]
    return shard(x.to(cfg.dtype), "batch", None, None)


def logits(cfg: ModelConfig, p, x):
    """x (B,S,d) -> (B,S,V).  On DTensors, a vocab too small for the
    ``model`` axis (whisper's 51,866: the head whole over it) makes the
    product whole on every model rank, whose backward, as the
    reference's partitioner runs it, takes each rank's share of the rows
    (``whole_forward``; rows that do not split run whole)."""
    x = reduce_grad_partial(rmsnorm(x, p["norm_f"], cfg.norm_eps))
    w = (p["tok"].T if cfg.tie_embeddings else p["head"]).to(cfg.dtype)
    if (_rows_split(x) and not serving_mode()
            and resolve(("vocab",), (w.shape[1],)) != P()):
        # a residual whose rows stay split (``REPRO_SP_RESIDUAL``): the
        # normed rows gathered for the vocab-split product (the gradient
        # reduce-scattered back onto them)
        x = shard(x, "batch", None, None)
    # the sequence-parallel attention's plan reaches the logits of a vocab
    # too small for the model axis (whisper's)
    seq_par = not heads_tp_available(cfg.n_heads)
    if (is_dtensor(w) and not serving_mode() and _rows_whole(x.shape[1])
            and resolve(("vocab",), (w.shape[1],)) == P() and seq_par):
        y = _whole_product(x, w, "bsd,dv->bsv", ("embed", "vocab"))
    elif (is_dtensor(w) and not serving_mode() and seq_par
            and "model" in w.device_mesh.mesh_dim_names
            and resolve(("vocab",), (w.shape[1],)) == P()
            and x.shape[1] % _seq_ranks() == 0 and _seq_ranks() > 1):
        x = shard(x, "batch", "seq", None)
        y = einsum("bsd,dv->bsv", x, gather_fsdp(w, ("embed", "vocab")),
                   _plain_product, whole_forward="model", **_gathered_grad(x))
    elif is_dtensor(w) and serving_mode() and _mesh() is not None:
        # the reference's logits are a plain product, not its
        # weight-stationary one: under the serving rules its partitioner
        # gathers the head's embed shards
        y = einsum("bsd,dv->bsv", x,
                   gather_fsdp(w, ("embed", "vocab"),
                               gather_in_serving=True),
                   _plain_product)
    else:
        y = serving_matmul(x, w, "bsd,dv->bsv", ("embed", "vocab"),
                           transpose=not seq_par,
                           split=splits_contraction(cfg))
    return shard(y, "batch", None, "vocab")
