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
* Projections are plain products: the port runs on one card, so the
  reference's weight-stationary mesh schedule (``serving_matmul``) and
  its ``shard`` annotations have no counterpart here.  The logical axis
  names of each weight are kept as data (``*_specs``: one tuple of names
  per leaf, one name per dim), which `parallel.axes` resolves to price
  the production meshes (`launch.dryrun`).
* Training recomputes each block's activations in the backward pass
  (`recompute`, the reference's ``jax.checkpoint`` around the same
  blocks); a forward that autograd does not record runs plainly.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.tree import leaves


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


def recompute(fn, params, *args):
    """``fn(*args)``; when autograd records it (grad mode on and a leaf
    of ``params``, the block's weights, requiring grad) its activations
    are dropped after the forward and recomputed in the backward pass,
    as the reference's ``jax.checkpoint`` does: the same values, one
    block's activations alive at a time."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in leaves(params)):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


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


#: the dtype probabilities and V are rounded to before the chunked
#: route's P·V product (and the mLSTM's decay-weighted scores before
#: theirs), which accumulate in fp32: bf16, the reference's default (its
#: ``_probs_dtype``)
PROBS_DTYPE = torch.bfloat16


def _chunked_attention(q, k, v, *, causal: bool, chunk: int,
                       softcap: float = 0.0):
    """Query-chunked online attention, fp32 softmax, grouped GQA.

    q (B,S,Hq,D); k,v (B,T,Hkv,D), Hq % Hkv == 0.  The GQA group dim is
    contracted by einsum, so the repeated KV is never materialized.
    Loops over query chunks so peak score memory is (B,Hkv,G,chunk,T).
    Probabilities are rounded to `PROBS_DTYPE` (bf16) before the PV
    product, which accumulates in fp32, as the reference does by default.
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
    vb = v.to(PROBS_DTYPE).float()
    kpos = torch.arange(t, device=q.device)[None, :]
    outs = []
    for i in range(nq):
        sc = torch.einsum("bchgd,bthd->bchgt", qc[:, i].float(), kf) * scale
        if softcap > 0.0:
            sc = softcap * torch.tanh(sc / softcap)
        if causal:
            qpos = (i * chunk + torch.arange(chunk, device=q.device)[:, None]
                    + (t - s))                    # (c,1)
            msk = (kpos <= qpos)[None, :, None, None, :]
            sc = torch.where(msk, sc, float("-inf"))
        m = sc.amax(-1, keepdim=True).detach()   # jax.lax.stop_gradient
        p = torch.exp(sc - torch.where(torch.isfinite(m), m, 0.0))
        l = p.sum(-1, keepdim=True).clamp_min(1e-30)
        o = torch.einsum("bchgt,bthd->bchgd",
                         p.to(PROBS_DTYPE).float(), vb)
        outs.append((o / l).to(q.dtype))
    o = torch.stack(outs, 1).reshape(b, nq * chunk, hq, d)
    return o[:, :s]


def attention(cfg: ModelConfig, q, k, v, *, causal: bool, chunk: int = 1024):
    """GQA attention dispatch (chunked path or the flash kernel).

    q (B,S,Hq,D); k,v (B,T,Hkv,D).  Returns (B,S,Hq,D).  The flash
    kernel takes no logit softcap: with ``cfg.attn_logit_softcap`` set
    the flash route raises rather than drop it.
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
    return _chunked_attention(q, k, v, causal=causal, chunk=chunk,
                              softcap=cfg.attn_logit_softcap)


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
    q = _proj(x, p["wq"].to(dt))
    k = _proj(x, p["wk"].to(dt))
    v = _proj(x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def attn_out(cfg: ModelConfig, p, o):
    """o (B,S,Hq,D) -> (B,S,d)."""
    wo = p["wo"].to(cfg.dtype)
    return o.reshape(*o.shape[:-2], -1) @ wo.reshape(-1, wo.shape[-1])


def cross_kv(cfg: ModelConfig, p, ctx):
    """K/V of a cross-attention over context states ctx (B,T,d): the
    attention's ``wk``/``wv`` projections, no bias and no rotation."""
    return _proj(ctx, p["wk"].to(cfg.dtype)), _proj(ctx, p["wv"].to(cfg.dtype))


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
    if kind == "swiglu":
        h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
        return h @ p["w_down"].to(dt)
    h = F.gelu(x @ p["w_up"].to(dt) + p["b_up"].to(dt), approximate="tanh")
    return h @ p["w_down"].to(dt) + p["b_down"].to(dt)


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


def embed(cfg: ModelConfig, p, tokens):
    """tokens (B,S) -> (B,S,d) in the compute dtype (gather, then cast:
    the same values as casting the table first)."""
    return p["tok"][tokens.long()].to(cfg.dtype)


def logits(cfg: ModelConfig, p, x):
    x = rmsnorm(x, p["norm_f"], cfg.norm_eps)
    w = (p["tok"].T if cfg.tie_embeddings else p["head"]).to(cfg.dtype)
    return x @ w
