"""DAMOV-style synthetic application kernels as trace generators.

Each generator is a pure function ``(n_accesses, footprint_lines, seed)
-> Trace`` emitting the per-access line-delta / write-flag / dependency
stream of one application class from the DAMOV taxonomy:

* ``stream``        — DRAM-bandwidth-bound streaming (STREAM triad):
                      unit-stride, 2 reads : 1 write, no dependencies.
* ``gups``          — random-access update (HPCC RandomAccess): uniform
                      random lines, read-modify-write pairs.
* ``stencil3d``     — 7-point 3-D stencil sweep: unit stride plus plane
                      /row neighbour strides, 7 reads : 1 write.
* ``spmv``          — sparse matrix-vector product (CSR): streaming row
                      and column-index reads interleaved with irregular
                      gathers of the dense vector.
* ``pointer_chase`` — linked-list traversal: every access depends on
                      the previous one (latency-bound by construction).
* ``bfs_frontier``  — BFS frontier expansion: streaming frontier reads,
                      each followed by a dependent burst of irregular
                      neighbour reads (mixed latency/bandwidth).
* ``mess_traffic``  — the Mess traffic-generator pattern itself
                      (64-line sequential segments at random bases) as a
                      trace, used to cross-validate the trace frontend
                      against the native pace generator on identical
                      traffic.

Generation is host-side numpy (deterministic PCG64 per kernel+seed),
the same arrays as the JAX package's generators element for element;
the emitted `Trace` holds CPU tensors the replay engine batches.
Kernels registered in `KERNELS` are picked up by
`repro_torch.bench.app_validation` and can be combined into
multiprogrammed per-core mixes (`repro_torch.traces.mix.assign_traces`).
"""
from __future__ import annotations

import zlib

import numpy as np

from repro_torch.core.workload import SEGMENT_LINES
from repro_torch.traces.trace import Trace, make_trace

DEFAULT_FOOTPRINT = 1 << 20          # 64 MB per core (1 Mi lines)


def _rng(name: str, seed: int) -> np.random.Generator:
    # stable across processes (hash() is salted per interpreter run)
    return np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([seed, zlib.crc32(name.encode())])))


def _to_trace(lines, is_write, dep, footprint: int) -> Trace:
    lines = np.asarray(lines, np.int64) % footprint
    delta = np.diff(lines, prepend=0).astype(np.int32)
    return make_trace(delta, is_write, dep, footprint)


def stream(n: int = 4096, footprint: int = DEFAULT_FOOTPRINT,
           seed: int = 0) -> Trace:
    """STREAM triad: a[i] = b[i] + s*c[i] — 2 streaming reads, 1 write."""
    i = np.arange(n)
    elem = i // 3
    which = i % 3                     # 0: read b, 1: read c, 2: write a
    lines = (which * (footprint // 3) + elem) % footprint
    return _to_trace(lines, which == 2, np.zeros(n), footprint)


def gups(n: int = 4096, footprint: int = DEFAULT_FOOTPRINT,
         seed: int = 0) -> Trace:
    """Random-access updates: read a random line, write it back."""
    r = _rng("gups", seed)
    target = r.integers(0, footprint, size=(n + 1) // 2)
    lines = np.repeat(target, 2)[:n]
    m = lines.shape[0]
    is_write = (np.arange(m) % 2).astype(np.int32)   # read then write
    return _to_trace(lines, is_write, np.zeros(m), footprint)


def stencil3d(n: int = 4096, footprint: int = DEFAULT_FOOTPRINT,
              seed: int = 0) -> Trace:
    """7-point stencil over an nx*ny*nz grid (one line per 8 points)."""
    nx = max(int(round(footprint ** (1 / 3))), 4)
    ny, nz = nx, max(footprint // (nx * nx), 1)
    pts = n // 8
    i = np.arange(pts)
    center = (i * 7919) % (nx * ny * max(nz - 2, 1)) + nx * ny
    offs = np.array([0, -1, +1, -nx, +nx, -nx * ny, +nx * ny])
    reads = (center[:, None] + offs[None, :]) >> 3    # 8 points / line
    writes = (center >> 3) + footprint // 2           # output grid
    lines = np.concatenate(
        [reads, writes[:, None]], axis=1).reshape(-1)[:n]
    is_write = np.zeros(lines.shape[0], np.int32)
    is_write[7::8] = 1
    return _to_trace(lines, is_write, np.zeros(lines.shape[0]), footprint)


def spmv(n: int = 4096, footprint: int = DEFAULT_FOOTPRINT,
         seed: int = 0, nnz_per_row: int = 6) -> Trace:
    """CSR SpMV: per row, stream col-index+value lines, gather x, write y."""
    r = _rng("spmv", seed)
    per_row = nnz_per_row + 2         # nnz gathers + 1 stream + 1 write
    rows = n // per_row + 1
    lines, is_write = [], []
    vec_base = footprint // 2
    for row in range(rows):
        lines.append(row)                              # col_idx/val stream
        lines.extend(vec_base
                     + r.integers(0, footprint // 4, size=nnz_per_row))
        lines.append(3 * footprint // 4 + row)         # y[row] write
        is_write.extend([0] * (nnz_per_row + 1) + [1])
    lines = np.asarray(lines[:n])
    return _to_trace(lines, np.asarray(is_write[:n]),
                     np.zeros(lines.shape[0]), footprint)


def pointer_chase(n: int = 2048, footprint: int = DEFAULT_FOOTPRINT,
                  seed: int = 0) -> Trace:
    """Linked-list traversal: every load depends on the previous one."""
    r = _rng("pointer_chase", seed)
    lines = r.integers(0, footprint, size=n)
    dep = np.ones(n, np.int32)
    dep[0] = 0
    return _to_trace(lines, np.zeros(n), dep, footprint)


def bfs_frontier(n: int = 4096, footprint: int = DEFAULT_FOOTPRINT,
                 seed: int = 0, degree: int = 4) -> Trace:
    """BFS frontier expansion: stream a vertex, then dependent gathers."""
    r = _rng("bfs", seed)
    verts = n // (degree + 1) + 1
    lines, dep = [], []
    for v in range(verts):
        lines.append(v)                                # frontier stream
        dep.append(0)
        lines.extend(footprint // 2
                     + r.integers(0, footprint // 2, size=degree))
        dep.extend([1] + [0] * (degree - 1))           # burst waits on v
    lines = np.asarray(lines[:n])
    return _to_trace(lines, np.zeros(lines.shape[0]),
                     np.asarray(dep[:n]), footprint)


def mess_traffic(n: int = 4096, footprint: int = DEFAULT_FOOTPRINT,
                 seed: int = 0, write_num: int = 0) -> Trace:
    """The Mess generator loop as a trace: 64-line segments, hashed bases.

    Matches `workload.generate`'s traffic pattern (segmented sequential
    runs at scattered bases, deterministic write interleave at
    ``write_num/64``) so the trace frontend can be validated against the
    native pace frontend on statistically identical traffic.
    """
    r = _rng("mess", seed)
    segs = n // SEGMENT_LINES + 1
    bases = r.integers(0, footprint // SEGMENT_LINES,
                       size=segs) * SEGMENT_LINES
    k = np.arange(segs * SEGMENT_LINES)[:n]
    lines = bases[k // SEGMENT_LINES] + k % SEGMENT_LINES
    is_write = ((k + 1) * write_num) // 64 - (k * write_num) // 64 > 0
    return _to_trace(lines, is_write, np.zeros(n), footprint)


#: the application suite replayed by `benchmarks/app_validation.py`
KERNELS = {
    "stream": stream,
    "gups": gups,
    "stencil3d": stencil3d,
    "spmv": spmv,
    "pointer_chase": pointer_chase,
    "bfs_frontier": bfs_frontier,
}


def make_suite(n: int = 4096, footprint: int = DEFAULT_FOOTPRINT,
               seed: int = 0, names=None):
    """Generate the named kernels (all by default) as a list of traces."""
    names = tuple(names or KERNELS)
    unknown = [k for k in names if k not in KERNELS]
    if unknown:
        raise ValueError(
            f"unknown kernel(s) {unknown}; one of {sorted(KERNELS)}")
    return names, [KERNELS[k](n, footprint, seed) for k in names]
