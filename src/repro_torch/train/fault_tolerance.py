"""Fault tolerance for long runs on many nodes.

Three mechanisms, all exercised by tests on one host and designed to
scale by construction (the reference's ``train/fault_tolerance.py``,
which imports no JAX, kept as it is):

* **Preemption hook** — SIGTERM/SIGINT set a flag; the training loop
  checkpoints at the next step boundary and exits cleanly (a cloud
  maintenance event or a scheduler's preemption).
* **Straggler detection** — per-step wall-clock watchdog.  A step that
  exceeds ``timeout_factor x`` the trailing-median step time is flagged;
  after ``max_flags`` consecutive flags the runner requests a restart
  (on a real cluster: evict the slow host and re-mesh).  Detection is
  host-side and free — it never blocks the device stream.
* **Elastic re-mesh** — `plan_elastic_mesh` recomputes the largest
  usable (data, model) mesh from the devices that remain after a
  failure (keeping 'model' intact, shrinking 'data'), so training
  resumes from the last checkpoint with a smaller data-parallel width
  instead of dying.
"""
from __future__ import annotations

import dataclasses
import signal
import statistics
import time


class PreemptionGuard:
    """Signal-driven graceful-shutdown flag."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._requested = False
        self._prev = {}
        self._signals = signals

    def __enter__(self):
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        return False

    def _handler(self, signum, frame):
        self._requested = True

    @property
    def preempted(self) -> bool:
        return self._requested


@dataclasses.dataclass
class StragglerWatchdog:
    timeout_factor: float = 3.0
    max_flags: int = 3
    window: int = 32
    _times: list = dataclasses.field(default_factory=list)
    _flags: int = 0

    def observe(self, step_seconds: float) -> bool:
        """Record a step time; True if a restart should be requested."""
        if len(self._times) >= 8:
            med = statistics.median(self._times[-self.window:])
            if step_seconds > self.timeout_factor * med:
                self._flags += 1
            else:
                self._flags = 0
        self._times.append(step_seconds)
        del self._times[:-self.window]
        return self._flags >= self.max_flags

    def timer(self):
        return _StepTimer(self)


class _StepTimer:
    def __init__(self, dog):
        self.dog = dog

    def __enter__(self):
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.flagged = self.dog.observe(time.monotonic() - self.t0)
        return False


def plan_elastic_mesh(n_alive: int, model_size: int,
                      pod_size: int | None = None) -> tuple:
    """Largest (pod, data, model) shape from `n_alive` devices.

    Keeps the 'model' axis intact (TP groups must be complete) and
    shrinks 'data' (losing data-parallel replicas only).  Returns the
    mesh shape tuple; raises if not even one model group survives.
    """
    if n_alive < model_size:
        raise RuntimeError(
            f"only {n_alive} devices alive; need >= one model group "
            f"of {model_size}")
    data = n_alive // model_size
    if pod_size is not None and data * model_size > pod_size:
        pods = (data * model_size) // pod_size
        data_per_pod = pod_size // model_size
        return (pods, data_per_pod, model_size)
    return (data, model_size)
