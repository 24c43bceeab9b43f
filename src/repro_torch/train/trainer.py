"""The training loop: step + checkpoint + fault tolerance, assembled.

Single entry point used by `launch/train.py` (the reference's
``train/trainer.py`` on one card).  The step runs eagerly where the
reference jits it; the batch moves to the Trainer's device, and the
step time the straggler watchdog sees includes the sync that reads the
loss back, as the reference's does.

``state()`` is ``dict(params, opt=dict(m, v, step), step)``, the
reference's tree, so that each package resumes from the other's
checkpoints.  With ``compress_grads`` the int8 round trip runs as the
step's ``compress_grads`` hook, after the accumulation over ``accum``
microbatches (the reference's compressed step takes the whole batch at
once and ignores ``accum``).  The error-feedback state is not
checkpointed, as in the reference.  `fit` returns the reference's
``losses`` and ``final_step`` and each step's pre-clip ``grad_norms``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch.models.registry import ModelApi
from repro_torch.parallel import compression
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import fault_tolerance as ft
from repro_torch.train import optimizer as opt
from repro_torch.train.step import build_train_step
from repro_torch.tree import leaves


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str | None = None
    ckpt_keep: int = 3
    accum: int = 1
    z_loss: float = 0.0
    compress_grads: bool = False
    log_every: int = 10
    straggler_factor: float = 5.0


class Trainer:
    """``seed``: an int, or a `torch.Generator` whose device the params
    are drawn on; ``device``: the card unless the caller asks for the
    CPU (with a generator, its device if not given)."""

    def __init__(self, api: ModelApi, opt_cfg: opt.AdamWConfig,
                 tcfg: TrainerConfig, *, seed=0, device=None,
                 log_fn: Callable[[str], None] = print):
        self.api = api
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.log = log_fn
        self.params = api.init(seed, device=device)
        self.device = next(leaves(self.params)).device
        self.opt_state = opt.init_state(opt_cfg, self.params)
        self.step_idx = 0

        hook = None
        if tcfg.compress_grads:
            self._ef = compression.init_error_feedback(self.params)

            def hook(grads):
                grads, self._ef = compression.compress_decompress(grads,
                                                                  self._ef)
                return grads
        self._step = build_train_step(api, opt_cfg, accum=tcfg.accum,
                                      z_loss=tcfg.z_loss,
                                      compress_grads=hook)

    # -- checkpoint / resume -------------------------------------------------

    def state(self):
        return dict(params=self.params, opt=self.opt_state,
                    step=torch.tensor(self.step_idx, dtype=torch.int32))

    def maybe_resume(self) -> bool:
        d = self.tcfg.ckpt_dir
        if not d:
            return False
        if ckpt.latest_step(d) is None:
            return False
        state, _ = ckpt.restore(d, self.state())
        self.params = state["params"]
        self.opt_state = state["opt"]
        self.step_idx = int(state["step"])
        self.log(f"[trainer] resumed from step {self.step_idx}")
        return True

    def save(self):
        if not self.tcfg.ckpt_dir:
            return
        ckpt.save(self.tcfg.ckpt_dir, self.step_idx, self.state())
        ckpt.prune(self.tcfg.ckpt_dir, self.tcfg.ckpt_keep)

    # -- loop ----------------------------------------------------------------

    def fit(self, batches: Iterable[dict]) -> dict:
        tcfg = self.tcfg
        watchdog = ft.StragglerWatchdog(timeout_factor=tcfg.straggler_factor)
        losses, grad_norms = [], []
        it = iter(batches)
        with ft.PreemptionGuard() as guard:
            while self.step_idx < tcfg.total_steps:
                batch = {k: (v if isinstance(v, torch.Tensor)
                             else torch.from_numpy(np.asarray(v)))
                         .to(self.device) for k, v in next(it).items()}
                t0 = time.monotonic()
                self.params, self.opt_state, metrics = self._step(
                    self.params, self.opt_state, batch)
                loss = float(metrics["loss"])
                dt = time.monotonic() - t0
                losses.append(loss)
                grad_norms.append(float(metrics["grad_norm"]))
                self.step_idx += 1
                if watchdog.observe(dt):
                    self.log(f"[trainer] straggling at step "
                             f"{self.step_idx}; checkpoint + restart")
                    self.save()
                    break
                if self.step_idx % tcfg.log_every == 0:
                    self.log(f"[trainer] step {self.step_idx:5d} "
                             f"loss {loss:.4f} "
                             f"({dt * 1e3:.0f} ms/step)")
                if tcfg.ckpt_every and self.step_idx % tcfg.ckpt_every == 0:
                    self.save()
                if guard.preempted:
                    self.log("[trainer] preemption requested; "
                             "checkpointing and exiting")
                    self.save()
                    break
        return dict(losses=losses, grad_norms=grad_norms,
                    final_step=self.step_idx)
