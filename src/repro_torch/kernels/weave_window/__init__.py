"""One window of the Mess platform's weave phase in one kernel launch."""
from repro_torch.kernels.weave_window.ops import (MAX_Q, MAX_RANKS, MAX_RB,
                                                  PARAM_NAMES, pack_inputs,
                                                  pack_params, weave_window)

__all__ = ["MAX_Q", "MAX_RANKS", "MAX_RB", "PARAM_NAMES", "pack_inputs",
           "pack_params", "weave_window"]
