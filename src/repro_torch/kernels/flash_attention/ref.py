"""Plain PyTorch version of the flash-attention kernel."""
from __future__ import annotations

import torch


def default_scale(d: int) -> float:
    """``1/sqrt(d)`` rounded to fp32, the kernel's default scale."""
    return float(torch.tensor(1.0 / (d ** 0.5), dtype=torch.float32))


def mha_plain(q, k, v, *, causal: bool = False, scale: float | None = None):
    """Multi-head attention, O(S^2) materialized: the kernel's plain version.

    q: (B, Hq, Sq, D);  k, v: (B, Hkv, Sk, D) with Hq % Hkv == 0 (GQA).
    Returns (B, Hq, Sq, D) in q.dtype; softmax in float32.  Under
    ``causal`` query i sits at absolute position Sk - Sq + i.  A row that
    sees no key (causal with Sq > Sk) is 0, the kernel's convention.
    """
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if hkv != hq:
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    if scale is None:
        scale = default_scale(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kpos = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(kpos <= qpos, s, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    den = p.sum(-1, keepdim=True)
    p = p / torch.where(den == 0, 1.0, den)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype)
