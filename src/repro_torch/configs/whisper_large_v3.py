"""whisper-large-v3 [audio] — enc-dec, conv frontend (stub)
[arXiv:2212.04356].

32L (decoder; 32-layer encoder) d_model=1280 20H (MHA kv=20)
d_ff=5120 vocab=51866.  The conv frontend is a STUB: input_specs()
provides precomputed frame embeddings (B, 1500, d).  20 heads do not
divide the 16-way 'model' axis -> heads replicate, the 5120-wide FFN
carries the TP (divisibility fallback, DESIGN.md §Arch-applicability).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866, n_encoder_layers=32, n_ctx_tokens=1500,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, n_encoder_layers=2, n_ctx_tokens=8,
)

SKIP_SHAPES = {"long_500k"}   # enc-dec full attention
