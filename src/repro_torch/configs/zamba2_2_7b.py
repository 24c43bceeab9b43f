"""zamba2-2.7b [hybrid] — Mamba2 + shared attn blocks [arXiv:2411.15242].

54L d_model=2560 32H (kv=32) d_ff=10240, ssm_state=64.  54 Mamba2
blocks with one SHARED attention+MLP transformer block applied every
6 layers (params shared, per-application KV caches).  Mamba2 state is
O(1) in sequence length -> runs the 500k cell; the shared block's KV
cache at 500k is sequence-sharded over the data axis
(flash-decoding-style partial-softmax combine).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000, ssm_state=64, ssm_expand=2,
    ssm_head_dim=64, attn_every=6, d_head=80,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, ssm_state=8, ssm_expand=2,
    ssm_head_dim=16, ssm_chunk=8, attn_every=2, d_head=16,
)

SKIP_SHAPES: set = set()     # SSM backbone -> long_500k runs
