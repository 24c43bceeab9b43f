"""arctic-480b [moe] — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base].

35L d_model=7168 56H (GQA kv=8) d_ff=4864, MoE 128e top-2 with a dense
SwiGLU residual in parallel (Arctic's dense-MoE hybrid).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000, n_experts=128, top_k=2,
    dense_residual=True, rope_theta=1e4,
)

SMOKE = ModelConfig(
    name="arctic-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab=256, n_experts=4, top_k=2, dense_residual=True,
)

SKIP_SHAPES = {"long_500k"}   # full-attention MoE
