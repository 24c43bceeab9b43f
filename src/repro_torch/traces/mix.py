"""Per-core trace assignment: multiprogrammed (mixed) workloads.

A solo `Trace` is sharded data-parallel across every traffic core (a
multi-threaded kernel).  A `TraceMix` is a ``(n_cores,)``-indexed batch
of traces padded to one static shape, so each core replays its own
stream with its own cursor: the regime where a latency-bound app that
shares the memory system with a streaming app sees queueing delay the
decoupled bound phase never prices.

Construction is host-side numpy (`assign_traces`); the result holds CPU
tensors, and a stack of mixes (`stack_mixes`) replays as one batched
`run_frontend` call over the mix axis, as solo suites do.

Per-core fields:

* ``length``    — valid prefix of the core's stream; 0 marks an idle
  core (partial-occupancy mixes and the chase core).
* ``pos0`` / ``line_cum0`` — the core's phase offset: the cursor starts
  ``pos0`` accesses into the stream, with the int32 delta prefix sum at
  that point, so absolute lines equal a core's that replayed from 0.
* ``app_id``    — the application the core runs (-1 = idle); the replay
  engine reduces per-core completion windows to per-app runtimes by it.
* ``region_lines`` — per-core address-region stride: core ``c`` replays
  inside ``[c * region_lines, (c+1) * region_lines)``.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.workload import CAP_DEMAND
from repro_torch.traces.trace import MAX_FOOTPRINT_LINES, Trace


class TraceMix(NamedTuple):
    """A per-core trace batch (or a stack of them, with a leading axis)."""

    delta: torch.Tensor            # (n_cores, L) int32
    is_write: torch.Tensor         # (n_cores, L) int32 0/1
    dep: torch.Tensor              # (n_cores, L) int32 0/1
    length: torch.Tensor           # (n_cores,) int32; 0 = idle core
    footprint_lines: torch.Tensor  # (n_cores,) int32 per-core mod wrap
    pos0: torch.Tensor             # (n_cores,) int32 phase offset
    line_cum0: torch.Tensor        # (n_cores,) int32 delta sum at pos0
    app_id: torch.Tensor           # (n_cores,) int32; -1 = idle
    region_lines: torch.Tensor     # ()  int32 per-core address stride

    @property
    def n_cores(self) -> int:
        return self.delta.shape[-2]

    @property
    def n_slots(self) -> int:
        return self.delta.shape[-1]


def assign_traces(traces: Sequence[Trace], assignment: Sequence[int],
                  phase_offsets: Sequence[int] | None = None,
                  wrap: bool = True) -> TraceMix:
    """Build a `TraceMix` from an app list and a per-core assignment.

    Args:
        traces: the applications of the mix (unbatched `Trace`s).
        assignment: per-core app index, one entry per frontend core
            (24 per socket); -1 marks an idle core.  The chase-probe
            core (the last one) must be idle.
        phase_offsets: optional per-core start offsets into the assigned
            stream (accesses).  Default: all zero.
        wrap: with ``True`` (default) an offset core replays the rotated
            stream ``[off, length) ++ [0, off)`` (offsets modulo the
            length): every core replays all ``length`` accesses, and the
            running delta sum continues past the end of the stream as a
            looping replay would.  With ``False`` the offset core plays
            the truncated suffix ``[off, length)`` (offsets clipped to the
            length) and finishes earlier.
    Returns:
        A `TraceMix` of CPU tensors padded to one static shape: per-core
        arrays of length ``max(trace length) + CAP_DEMAND``.
    """
    assignment = list(assignment)
    n_cores = len(assignment)
    if phase_offsets is None:
        phase_offsets = [0] * n_cores
    if len(phase_offsets) != n_cores:
        raise ValueError("phase_offsets must have one entry per core")
    if assignment[-1] != -1:
        raise ValueError("the last core is the chase probe; it must be "
                         "idle (app_id -1)")
    for a in assignment:
        if not -1 <= a < len(traces):
            raise ValueError(f"assignment entry {a} out of range for "
                             f"{len(traces)} traces")
    used = {a for a in assignment if a >= 0}
    missing = set(range(len(traces))) - used
    if missing:
        raise ValueError(f"traces {sorted(missing)} have no cores assigned")

    L = max(int(t.length) for t in traces) + CAP_DEMAND
    delta = np.zeros((n_cores, L), np.int32)
    is_write = np.zeros((n_cores, L), np.int32)
    dep = np.zeros((n_cores, L), np.int32)
    length = np.zeros(n_cores, np.int32)
    footprint = np.ones(n_cores, np.int32)
    pos0 = np.zeros(n_cores, np.int32)
    cum0 = np.zeros(n_cores, np.int32)

    host = [Trace(*(x.cpu().numpy() for x in t)) for t in traces]
    for c, a in enumerate(assignment):
        if a < 0:
            continue
        t = host[a]
        n = int(t.length)
        delta[c, :t.delta.shape[0]] = t.delta
        is_write[c, :t.is_write.shape[0]] = t.is_write
        dep[c, :t.dep.shape[0]] = t.dep
        length[c] = n
        footprint[c] = int(t.footprint_lines)
        if wrap:
            # steady-state pipeline: rotate the stream so the cursor
            # starts at 0 and the core replays all n accesses
            off = int(phase_offsets[c]) % n if n else 0
            if off:
                for dst, src in ((delta, t.delta), (is_write, t.is_write),
                                 (dep, t.dep)):
                    dst[c, :n] = np.concatenate([src[off:n], src[:off]])
            pos0[c] = 0
        else:
            off = min(max(int(phase_offsets[c]), 0), n)
            pos0[c] = off
        # int32 wraparound on purpose: matches the frontend's running
        # line_cum, so an offset core addresses the same lines a
        # from-zero core would at the same position
        cum0[c] = np.asarray(t.delta[:off], np.int32).sum(dtype=np.int32)

    region = int(max(footprint.max(), 1))
    if region > MAX_FOOTPRINT_LINES:
        raise ValueError(
            f"footprint {region} exceeds {MAX_FOOTPRINT_LINES}")
    # per-core regions must stay below the chase-probe region (bit 31):
    # with two sockets (48 cores) large footprints can reach it
    if n_cores * region > 1 << 31:
        raise ValueError(
            f"{n_cores} cores x footprint {region} lines overflows the "
            f"2^31-line traffic address space (the chase-probe region "
            f"starts at bit 31); shrink the footprint")
    t = torch.from_numpy
    return TraceMix(
        delta=t(delta), is_write=t(is_write), dep=t(dep), length=t(length),
        footprint_lines=t(footprint), pos0=t(pos0), line_cum0=t(cum0),
        app_id=t(np.asarray(assignment, np.int32)),
        region_lines=torch.tensor(region, dtype=torch.int32),
    )


def split_cores(n_apps: int, n_cores: int) -> list[int]:
    """An even per-core assignment of ``n_apps`` over the traffic cores.

    Traffic cores (all but the last, which is the chase probe) are split
    into ``n_apps`` contiguous, near-equal blocks — app 0 on the first
    block and so on; the chase core is idle.
    """
    if n_apps < 1 or n_apps > n_cores - 1:
        raise ValueError(f"need 1..{n_cores - 1} apps, got {n_apps}")
    traffic = n_cores - 1
    out = []
    for c in range(traffic):
        out.append(min(c * n_apps // traffic, n_apps - 1))
    return out + [-1]


def stack_mixes(mixes: Sequence[TraceMix]) -> TraceMix:
    """Stack mixes to a batch, right-padding streams to a common L.

    All mixes must share one core count; the result replays as one
    batched `run_frontend` call over the mix axis.
    """
    if len({m.n_cores for m in mixes}) != 1:
        raise ValueError("all mixes must have the same core count")
    L = max(m.n_slots for m in mixes)

    def padded(m: TraceMix):
        pad = L - m.n_slots
        return m._replace(**{f: torch.nn.functional.pad(getattr(m, f),
                                                        (0, pad))
                             for f in ("delta", "is_write", "dep")})

    return TraceMix(*(torch.stack(xs) for xs in zip(*map(padded, mixes))))


def mix_stats(mix: TraceMix) -> dict:
    """Host-side summary of one (unbatched) mix."""
    app_id = mix.app_id.cpu().numpy()
    length = mix.length.cpu().numpy()
    apps = sorted(int(a) for a in set(app_id[app_id >= 0]))
    return dict(
        n_cores=mix.n_cores,
        n_apps=len(apps),
        cores_per_app={a: int((app_id == a).sum()) for a in apps},
        accesses_per_core={a: int(length[app_id == a].max(initial=0))
                           for a in apps},
        idle_cores=int((app_id < 0).sum()),
    )
