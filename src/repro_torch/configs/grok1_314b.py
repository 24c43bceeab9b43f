"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1].

64L d_model=6144 48H (GQA kv=8) d_ff=32768, MoE 8e top-2,
vocab=131072, 30.0 attention-logit softcap (grok's tanh capping).
8 experts do not divide the 16-way 'model' axis -> the sharding rules
fall back to TP *within* experts (d_ff 32768/16) automatically.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072, n_experts=8, top_k=2,
    attn_logit_softcap=30.0, rope_theta=1e4,
)

SMOKE = ModelConfig(
    name="grok1-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=192, vocab=256, n_experts=4, top_k=2,
    attn_logit_softcap=30.0,
)

SKIP_SHAPES = {"long_500k"}   # full-attention MoE
