"""Benchmarks of the port: drivers that run the paper's experiments on
the card and write their results under ``reports/torch/``.

* `app_validation` — the application perspective's per-app runtime MAPE
  ladder (solo suite and multiprogrammed mixes).
* `perspectives`, `cmd_oracle` — the three-perspective divergence
  ladder and the command-stream oracle.
* `serving` — LLM-serving traffic replayed through the presets.
* `fig2_baseline` ... `fig7_portability` (over `util.run_sweep`) — the
  paper's figure sweeps; `weave_bench` — dense vs event weave engine.
"""
