"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

48L d_model=2048 4H (kv=4) d_ff=0 (projections live inside the
m/sLSTM blocks) vocab=50304.  Segment layout: 7 mLSTM + 1 sLSTM per
8 layers.  O(1)-state decode -> runs the 500k-token cell.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, slstm_every=8, ssm_expand=2,
)

SMOKE = ModelConfig(
    name="xlstm-smoke", family="ssm",
    n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
    d_ff=0, vocab=256, slstm_every=2, ssm_expand=2,
)

SKIP_SHAPES: set = set()     # recurrent decode -> long_500k runs
