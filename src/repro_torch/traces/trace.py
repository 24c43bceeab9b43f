"""Compact application-trace representation (the application perspective).

A `Trace` is a fixed-shape, batchable encoding of one application's
memory behaviour:

* ``delta``    — per-access cache-line delta from the previous access
  (one trace shards across the traffic cores by per-core base offsets;
  footprint wrapping is one modulo).
* ``is_write`` — read/write flag per access.
* ``dep``      — 1 where the access needs the previous access's response
  before it can issue (a pointer-chase edge): the replay frontend prices
  it at the bound-phase load-to-use latency.

Fields are int32 tensors: (L,) per access plus two per-trace scalars, or
with a leading application axis after `stack_traces` — the replay
frontend takes the batched form.  Streams are padded by one bound-phase
slice (`CAP_DEMAND`) beyond ``length`` so windowed reads never clamp
into valid data.  `make_trace` builds CPU tensors; `to` moves a trace
(or a `repro_torch.traces.mix.TraceMix`) to a device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.workload import CAP_DEMAND

#: traffic-core trace regions must stay below the chase-probe region
#: (bit 31) — 24 cores x footprint must fit in 2^31 lines.
MAX_FOOTPRINT_LINES = 1 << 26


class Trace(NamedTuple):
    """One application's access trace (or a batch, with a leading axis)."""

    delta: torch.Tensor            # (L,) int32 line delta vs previous
    is_write: torch.Tensor         # (L,) int32 0/1
    dep: torch.Tensor              # (L,) int32 0/1 depends-on-previous
    length: torch.Tensor           # ()  int32 valid prefix
    footprint_lines: torch.Tensor  # ()  int32 per-core footprint (mod wrap)

    @property
    def n_slots(self) -> int:
        return self.delta.shape[-1]


def make_trace(delta, is_write, dep, footprint_lines: int) -> Trace:
    """Build a `Trace` of CPU tensors from host arrays, padding for
    windowed slicing."""
    delta = np.asarray(delta, np.int32)
    is_write = np.asarray(is_write, np.int32)
    dep = np.asarray(dep, np.int32)
    if not (delta.shape == is_write.shape == dep.shape) or delta.ndim != 1:
        raise ValueError("delta/is_write/dep must be equal-length 1-D")
    if not 0 < footprint_lines <= MAX_FOOTPRINT_LINES:
        raise ValueError(
            f"footprint_lines must be in (0, {MAX_FOOTPRINT_LINES}]")
    n = delta.shape[0]

    def z(a):
        return torch.from_numpy(np.pad(a, (0, CAP_DEMAND)))

    return Trace(
        delta=z(delta), is_write=z(is_write), dep=z(dep),
        length=torch.tensor(n, dtype=torch.int32),
        footprint_lines=torch.tensor(footprint_lines, dtype=torch.int32),
    )


def stack_traces(traces: list[Trace]) -> Trace:
    """Stack per-app traces to a batch, right-padding to a common L.

    The batch replays as one batched `run_frontend` call over the
    application axis; per-app ``length`` keeps short traces honest.
    """
    L = max(t.n_slots for t in traces)

    def padded(t: Trace):
        pad = L - t.n_slots
        return t._replace(**{f: torch.nn.functional.pad(getattr(t, f),
                                                        (0, pad))
                             for f in ("delta", "is_write", "dep")})

    return Trace(*(torch.stack(xs) for xs in zip(*map(padded, traces))))


def to(trace, device):
    """The `Trace` or `TraceMix` with every field on ``device``."""
    return type(trace)(*(x.to(device) for x in trace))


def trace_stats(trace: Trace) -> dict:
    """Host-side summary of one (unbatched) trace."""
    n = int(trace.length)
    wr = trace.is_write.cpu().numpy()[:n]
    dep = trace.dep.cpu().numpy()[:n]
    return dict(
        accesses=n,
        write_frac=float(wr.mean()) if n else 0.0,
        dep_frac=float(dep.mean()) if n else 0.0,
        footprint_mb=float(trace.footprint_lines) * 64 / 2**20,
    )
