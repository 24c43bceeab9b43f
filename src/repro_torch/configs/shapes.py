"""The assigned input-shape set (same four for every LM arch).

``train_*`` lowers train_step; ``prefill_*`` lowers the forward pass;
``decode_*`` / ``long_*`` lower serve_step (one new token against a KV
cache / recurrent state of ``seq_len``).  ``long_500k`` requires
sub-quadratic attention — pure full-attention archs skip it (recorded
per arch in its config module and in DESIGN.md §Arch-applicability).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

SHAPE_ORDER = tuple(SHAPES)
