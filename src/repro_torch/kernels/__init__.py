"""Hand-written Hopper kernels of the port, each beside its plain version.

* `weave_window.weave_window` — one whole window of the weave phase
  (every step's refresh, drain, FR-FCFS select, command apply and
  stats; dense or event-horizon) in one launch: the card's weave route
  (``csrc/weave_window.cu``), with the telemetry planes and the
  command record in its recording instances.
* `bank_timing.frfcfs_select` — FR-FCFS eligibility + select, the body
  of every step of the stepwise weave route (``csrc/bank_timing.cu``).
* `window_inject.window_inject` — one whole window's bound phase and
  interface hand-off (generate, decode under every mapping, admission,
  queue scatter, frontend update) in one launch: the card's route for
  the Mess frontend (``csrc/window_inject.cu``); its trace instance,
  `window_inject.window_inject_trace`, the card's route for the trace
  frontend (a `Trace` or a `TraceMix`).
* `addr_decode.decode_packed` — Skylake XOR address decode on the DDR4
  geometry, ``addrmap.decode``'s card route (``csrc/addr_decode.cu``;
  its body, ``csrc/addr_decode.cuh``, is shared with `window_inject`);
  on no main path (the eager bound phase, the kernels' plain version,
  reaches it on card tensors).
* `flash_attention.flash_attention` — block-wise online-softmax GQA
  attention of the LM prefill forward: bf16 at head dim 64, 80 or 128 on
  the tensor cores (``csrc/flash_attention_sm90.cu``), everything else
  on the CUDA cores (``csrc/flash_attention.cu``).

All build on first use (`_build`) and count their launches (and
`flash_attention` its launches per route, `weave_window` its steps and
its launches per instance: with the recorders or without).
"""
from repro_torch.kernels.addr_decode import decode_packed
from repro_torch.kernels.bank_timing import frfcfs_select
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.weave_window import weave_window
from repro_torch.kernels.window_inject import (window_inject,
                                              window_inject_trace)

WRAPPERS = {"weave_window": weave_window, "window_inject": window_inject,
            "window_inject_trace": window_inject_trace,
            "frfcfs_select": frfcfs_select, "decode_packed": decode_packed,
            "flash_attention": flash_attention}


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last `reset_launch_counts`,
    and ``weave_window_recording``: those of `weave_window` that ran a
    recording instance."""
    counts = {name: fn.launches for name, fn in WRAPPERS.items()}
    by = weave_window.launches_by_instance
    counts["weave_window_recording"] = sum(by.values()) - by["plain"]
    return counts


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
        if hasattr(fn, "steps"):
            fn.steps = 0
        for by in ("launches_by_route", "launches_by_instance"):
            if hasattr(fn, by):
                setattr(fn, by, dict.fromkeys(getattr(fn, by), 0))
