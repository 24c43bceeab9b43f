"""HLO-text analysis: collective bytes per category.

`compiled.cost_analysis()` has no collective accounting, so we parse
the post-partitioning HLO: every ``all-gather`` / ``all-reduce`` /
``reduce-scatter`` / ``all-to-all`` / ``collective-permute`` op's
output bytes are summed per category.  Async pairs are counted once
(the ``-start`` op carries the shape; ``-done`` is skipped).

The numbers are *per-device* bytes (the partitioned module is the
per-device program), which is what the roofline's collective term
wants: per-chip collective bytes / per-chip link bandwidth.
"""
from __future__ import annotations

import re

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter",
               "all-to-all", "collective-permute")

_OP_RE = re.compile(
    r"=\s*(?P<shape>\([^=]*?\)|[\w\[\],{}:#\s]*?)\s*"
    r"(?P<op>" + "|".join(COLLECTIVES) + r")(?P<suffix>-start)?\(")
_ARR_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dt, dims in _ARR_RE.findall(shape_str):
        if dt not in DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> dict:
    """Per-category and total collective output bytes in the module."""
    out = {c: 0 for c in COLLECTIVES}
    counts = {c: 0 for c in COLLECTIVES}
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if not m:
            continue
        op = m.group("op")
        out[op] += _shape_bytes(m.group("shape"))
        counts[op] += 1
    return dict(bytes_by_op=out, counts=counts,
                total_bytes=sum(out.values()))


# While-loop awareness: collectives inside a while body execute
# trip-count times.  XLA names scan loops `while`; trip counts appear
# in the loop condition against a constant.  We conservatively scale
# body collectives by the trip count when it is statically recoverable.
_WHILE_TRIP_RE = re.compile(
    r"while\(.*?\).*?condition=.*?body=", re.S)


def collective_bytes_scaled(hlo_text: str) -> dict:
    """Like `collective_bytes`, scaling ops inside while bodies by the
    loop trip count (scan-over-layers!).

    HLO post-optimization text lists computations sequentially; ops in
    a while body computation appear under its definition.  We detect
    computations referenced as `body=%name` together with a constant
    trip count pattern `s32[] constant(N)` compared in the matching
    `condition=%cond` computation.
    """
    # map computation name -> text block
    blocks = {}
    cur = None
    for line in hlo_text.splitlines():
        m = re.match(r"^\s*%?([\w.\-]+)\s*\([^)]*\)\s*->", line)
        if m and ("{" in line or line.rstrip().endswith("{")):
            cur = m.group(1)
            blocks[cur] = []
        elif line.startswith("ENTRY"):
            cur = "__entry__"
            blocks[cur] = []
        if cur is not None:
            blocks[cur].append(line)

    # find while ops: body=%B condition=%C ; trip count from C's constant
    trip_of_body = {}
    for name, lines in blocks.items():
        for line in lines:
            m = re.search(r"while\(", line)
            if not m:
                continue
            mb = re.search(r"body=%?([\w.\-]+)", line)
            mc = re.search(r"condition=%?([\w.\-]+)", line)
            if not mb or not mc:
                continue
            trip = None
            cond_lines = blocks.get(mc.group(1), [])
            for cl in cond_lines:
                mt = re.search(r"constant\((\d+)\)", cl)
                if mt:
                    trip = int(mt.group(1))
            if trip:
                trip_of_body[mb.group(1)] = trip

    out = {c: 0 for c in COLLECTIVES}
    counts = {c: 0 for c in COLLECTIVES}
    for name, lines in blocks.items():
        scale = trip_of_body.get(name, 1)
        for line in lines:
            m = _OP_RE.search(line)
            if not m:
                continue
            op = m.group("op")
            out[op] += _shape_bytes(m.group("shape")) * scale
            counts[op] += 1
    return dict(bytes_by_op=out, counts=counts,
                total_bytes=sum(out.values()))
