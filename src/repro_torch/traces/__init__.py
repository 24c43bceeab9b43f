"""Trace-driven application workloads — the paper's third perspective.

Public API (the same as the JAX reference's ``repro.traces``):

* `Trace`, `make_trace`, `stack_traces`, `trace_stats`, `to` — compact
                                          traces of CPU tensors.
* `TraceMix`, `assign_traces`, `stack_mixes`, `split_cores`,
  `mix_stats`                           — per-core multiprogrammed mixes.
* `KERNELS`, `make_suite`               — DAMOV-style app generators.
* `TraceFrontend`, `TraceState`         — per-core bound-phase replay
                                          frontend (solo trace or mix).
* `replay_suite`, `replay_stages`, `replay_grid` — batched replay.
* `replay_mix`, `replay_mixes`          — multiprogrammed replay with
                                          per-app-in-mix runtimes.
* `anchor_runtime_ms`, `anchor_suite_ms`, `anchor_mix_ms`, `mape` —
                                          per-preset runtime anchors.
* `decode_hlo`, `decode_cost`, `lower_decode`, `serving_terms`,
  `ServeScenario`, `simulate_schedule`, `lower_serving`,
  `lower_scenario`, `request_latencies_ms` — LLM-serving traffic
                                          lowered from the HLO cost
                                          model (`repro_torch.traces.llm`).

Replay entry points take ``device=None`` (the card); ``device="cpu"``
runs the same code on the CPU.
"""
from repro_torch.traces.anchors import (anchor_mix_ms, anchor_runtime_ms,
                                        anchor_suite_ms, mape)
from repro_torch.traces.frontend import TraceFrontend, TraceState
from repro_torch.traces.kernels import KERNELS, make_suite
from repro_torch.traces.llm import (ServeScenario, decode_cost, decode_hlo,
                                    lower_decode, lower_scenario,
                                    lower_serving, request_latencies_ms,
                                    serving_terms, simulate_schedule)
from repro_torch.traces.mix import (TraceMix, assign_traces, mix_stats,
                                    split_cores, stack_mixes)
from repro_torch.traces.replay import (replay_grid, replay_mix, replay_mixes,
                                       replay_stages, replay_suite)
from repro_torch.traces.trace import (Trace, make_trace, stack_traces, to,
                                      trace_stats)

__all__ = [
    "Trace", "make_trace", "stack_traces", "trace_stats", "to",
    "TraceMix", "assign_traces", "stack_mixes", "split_cores", "mix_stats",
    "KERNELS", "make_suite",
    "TraceFrontend", "TraceState",
    "replay_suite", "replay_stages", "replay_grid",
    "replay_mix", "replay_mixes",
    "anchor_runtime_ms", "anchor_suite_ms", "anchor_mix_ms", "mape",
    "decode_hlo", "decode_cost", "lower_decode", "serving_terms",
    "ServeScenario", "simulate_schedule", "lower_serving",
    "lower_scenario", "request_latencies_ms",
]
