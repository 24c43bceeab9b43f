"""Benchmarks of the port: drivers that run the paper's experiments on
the card and write their results under ``reports/torch/``.

* `app_validation` — the application perspective's per-app runtime MAPE
  ladder (solo suite and multiprogrammed mixes).
"""
