"""One window's bound phase and interface hand-off in one kernel launch."""
from repro_torch.kernels.window_inject.ops import (MAPPINGS, MAX_Q,
                                                   PARAM_NAMES, pack_params,
                                                   prepare, prepare_trace,
                                                   window_inject,
                                                   window_inject_trace)

__all__ = ["MAPPINGS", "MAX_Q", "PARAM_NAMES", "pack_params", "prepare",
           "prepare_trace", "window_inject", "window_inject_trace"]
