"""Trip-count-aware cost model over post-optimization HLO text.

``compiled.cost_analysis()`` reports while-loop bodies ONCE — a
scan-over-layers train step is undercounted ~n_layers x.  This module
re-derives FLOPs / HBM bytes / collective bytes from the partitioned
HLO with loop trip counts applied:

* computations are split into blocks; ``while`` ops are matched to
  their body computations and trip counts (the loop-bound constant in
  the condition computation);
* scales nest: a scan inside a grad-accumulation scan multiplies;
* FLOPs: 2 x output_elements x contraction_size per ``dot`` (operand
  shapes resolved through a global name->type map);
* HBM bytes: for every *materializing* op (fusion, dot, copy,
  reduce, scatter/gather, dynamic slicing, convert, transpose,
  custom-call) output bytes + operand bytes — post-fusion HLO is
  fusion-level, so this approximates actual HBM traffic;
* collective bytes: as in `hlo.py`, per category.

Only ENTRY and while-body computations are walked (fusion bodies are
counted at their callsites).  All numbers are per-device (the
partitioned module is the per-device program).
"""
from __future__ import annotations

import re

from repro_torch.perfmodel.hlo import COLLECTIVES, DTYPE_BYTES

_HEADER_RE = re.compile(r"^(ENTRY\s+)?%?([\w.\-]+)\s*\(.*->.*\{")
_OP_RE = re.compile(r"^\s+(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.+)$")
_ARR_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_WHILE_RE = re.compile(
    r"while\(.*?\), condition=%?([\w.\-]+), body=%?([\w.\-]+)")
_CONST_RE = re.compile(r"s32\[\]\s+constant\((\d+)\)")
_COLL_RE = re.compile(
    r"(" + "|".join(COLLECTIVES) + r")(-start)?\(")

#: ops whose inputs/outputs hit HBM (post-fusion granularity)
_MATERIALIZING = (
    "fusion(", "dot(", "copy(", "reduce(", "reduce-window(",
    "scatter(", "gather(", "dynamic-slice(", "dynamic-update-slice(",
    "convert(", "transpose(", "custom-call(", "select-and-scatter(",
    "broadcast(", "iota(", "concatenate(", "slice(", "pad(", "reverse(",
    "reshape(", "sort(", "rng(", "cholesky(", "triangular-solve(",
)
_SKIP_BYTES = ("bitcast(", "tuple(", "get-tuple-element(", "parameter(",
               "constant(", "after-all(", "partition-id(")


def _split_blocks(text: str):
    blocks, cur, name = {}, None, None
    for line in text.splitlines():
        m = _HEADER_RE.match(line)
        if m:
            name = m.group(2)
            if m.group(1):          # ENTRY
                name = "__entry__"
            cur = []
            blocks[name] = cur
        elif cur is not None:
            cur.append(line)
    return blocks


def _first_array_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _ARR_RE.findall(type_str):
        if dt not in DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * DTYPE_BYTES[dt]
    return total


def _shape_dims(type_str: str):
    """dims of the FIRST array in a type string (dot outputs are arrays)."""
    m = _ARR_RE.search(type_str)
    if not m:
        return None, []
    dt, dims = m.group(1), m.group(2)
    return dt, [int(d) for d in dims.split(",")] if dims else []


_TYPE_RE = re.compile(
    r"^(\([^()]*\)|\w+\[[\d,]*\](?:\{[^}]*\})?)")


def _leading_type(rest: str) -> str:
    m = _TYPE_RE.match(rest)
    return m.group(1) if m else ""


def _build_type_map(text: str) -> dict:
    types = {}
    for line in text.splitlines():
        m = _OP_RE.match(line)
        if m:
            types[m.group(1)] = _leading_type(m.group(2))
        else:
            # computation params: "name: f32[...]," inside headers
            for pm in re.finditer(r"%?([\w.\-]+):\s*(\w+\[[\d,]*\])", line):
                types.setdefault(pm.group(1), pm.group(2))
    return types


def _dot_flops(line: str, types: dict) -> float:
    out_m = re.search(r"=\s*(\w+\[[\d,]*\])", line)
    if not out_m:
        return 0.0
    _, out_dims = _shape_dims(out_m.group(1))
    out_elems = 1
    for d in out_dims:
        out_elems *= d
    # contraction size from the lhs operand; newer XLA prints operand
    # types inline — "dot(f32[..]{..} %lhs, ...)" — older prints bare
    # "%lhs".  Accept both, preferring the inline type.
    ops_m = re.search(
        r"dot\(\s*(?:(\w+\[[\d,]*\])(?:\{[^}]*\})?\s+)?%?([\w.\-]+),",
        line)
    cd_m = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", line)
    if not ops_m or not cd_m:
        return 2.0 * out_elems        # fallback
    lhs_t = ops_m.group(1) or types.get(ops_m.group(2), "")
    _, lhs_dims = _shape_dims(lhs_t)
    contract = 1
    for i in cd_m.group(1).split(","):
        if i and int(i) < len(lhs_dims):
            contract *= lhs_dims[int(i)]
    return 2.0 * out_elems * contract


def _fusion_param_charges(body_lines: list, types: dict) -> dict:
    """Per-parameter byte charges for a fusion computation.

    A parameter consumed ONLY by a dynamic-slice (scan slicing stacked
    layer weights, fused into the loop body) is charged at the slice
    size, not the full stacked array — otherwise every scanned-weights
    cell is overcharged by ~n_layers x.
    Returns {param_index: bytes or None (= charge full size)}.
    """
    param_of = {}
    for ln in body_lines:
        pm = re.match(r"\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*.*?"
                      r"parameter\((\d+)\)", ln)
        if pm:
            param_of[pm.group(1)] = int(pm.group(2))
    charges = {}
    for name, idx in param_of.items():
        uses = []
        for ln in body_lines:
            if f"%{name}" in ln and f"%{name} =" not in ln \
                    and f"%{name}," not in ln.split("=")[0]:
                uses.append(ln)
        if len(uses) == 1 and ("dynamic-slice(" in uses[0]
                               or " slice(" in uses[0]):
            om = _OP_RE.match(uses[0])
            if om:
                charges[idx] = _first_array_bytes(
                    _leading_type(om.group(2)))
    return charges


def _line_bytes(line: str, types: dict, blocks: dict | None = None) -> int:
    """Output + operand bytes of one materializing op line."""
    m = _OP_RE.match(line)
    if not m:
        return 0
    rest = m.group(2)
    if any(s in rest for s in _SKIP_BYTES):
        return 0
    if not any(s in rest for s in _MATERIALIZING):
        return 0
    out_b = _first_array_bytes(_leading_type(rest))
    # Slice-family ops move only the slice, not the operand: a scan
    # slicing stacked layer weights reads L x less than the operand
    # size (counting operands here inflated memory terms ~100x).
    if "dynamic-slice(" in rest or " gather(" in rest \
            or " slice(" in rest:
        return 2 * out_b                       # read slice + write out
    if "dynamic-update-slice(" in rest or " scatter(" in rest:
        # traffic ~ read+write of the update region (operand 1/2)
        am = re.search(r"[\w\-]+\((.*?)\)(,|$| )", rest)
        refs = re.findall(r"%([\w.\-]+)", am.group(1)) if am else []
        upd = refs[1] if len(refs) > 1 else None
        upd_b = _first_array_bytes(types.get(upd, "")) if upd else 0
        return 2 * upd_b
    # operands: %refs inside the op's (...) argument list
    am = re.search(r"[\w\-]+\((.*?)\)(,|$| )", rest)
    in_b = 0
    if am:
        refs = re.findall(r"%([\w.\-]+)", am.group(1))
        charges = {}
        if blocks is not None and "fusion(" in rest:
            cm_ = re.search(r"calls=%?([\w.\-]+)", rest)
            if cm_ and cm_.group(1) in blocks:
                charges = _fusion_param_charges(blocks[cm_.group(1)],
                                                types)
        for i, ref in enumerate(refs):
            if i in charges:
                in_b += charges[i]
            else:
                in_b += _first_array_bytes(types.get(ref, ""))
    return out_b + in_b


def analyze(text: str) -> dict:
    """Trip-scaled per-device flops / bytes / collective bytes."""
    blocks = _split_blocks(text)
    types = _build_type_map(text)

    # while graph: parent computation -> [(body, cond, trip)]
    body_info = {}          # body -> (parent, trip)
    for parent, lines in blocks.items():
        for line in lines:
            m = _WHILE_RE.search(line)
            if not m:
                continue
            cond, body = m.group(1), m.group(2)
            trip = 1
            for cl in blocks.get(cond, []):
                cm = _CONST_RE.search(cl)
                if cm:
                    trip = max(trip, int(cm.group(1)))
            body_info[body] = (parent, trip)

    def scale_of(comp: str, _depth=0) -> int:
        if comp == "__entry__" or _depth > 16:
            return 1
        if comp in body_info:
            parent, trip = body_info[comp]
            return trip * scale_of(parent, _depth + 1)
        return 1  # not entry/while-body: handled at callsite

    walk = ["__entry__"] + list(body_info)
    flops = 0.0
    byts = 0.0
    coll = {c: 0 for c in COLLECTIVES}
    coll_counts = {c: 0 for c in COLLECTIVES}
    for comp in walk:
        sc = scale_of(comp)
        for line in blocks.get(comp, []):
            if " dot(" in line:
                flops += _dot_flops(line, types) * sc
            cb = _COLL_RE.search(line)
            if cb and not cb.group(2) == "-done":
                out_m = re.search(r"=\s*(\([^=]*?\)|[\w\[\],{} ]+?)\s*"
                                  + cb.group(1), line)
                if out_m:
                    coll[cb.group(1)] += _first_array_bytes(
                        out_m.group(1)) * sc
                    coll_counts[cb.group(1)] += 1
            byts += _line_bytes(line, types, blocks) * sc
    return dict(flops=flops, bytes=byts,
                bytes_by_op=coll, counts=coll_counts,
                total_bytes=sum(coll.values()))
