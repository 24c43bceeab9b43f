"""llama-3.2-vision-11b [vlm] — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision].

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256; every 5th
layer is a gated cross-attention layer over precomputed image patch
embeddings (vision frontend is a STUB per the assignment:
input_specs() provides the patch embeddings).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256, cross_attn_every=5,
    n_ctx_tokens=1600, rope_theta=5e5,
)

SMOKE = ModelConfig(
    name="llama32v-smoke", family="vlm",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=160, vocab=256, cross_attn_every=2, n_ctx_tokens=8,
)

SKIP_SHAPES = {"long_500k"}   # full self-attention backbone
