"""The storages a partitioned count holds at its peak, by the op and the
model code that made each.

Run as ``PYTHONPATH=src python tests/_peak_live_set.py ARCH SHAPE MESH
[LAYERS] [KNOB=VALUE ...] [--card]`` (``MESH``: ``pod`` or
``multipod``; ``LAYERS`` cuts the config's depth, 0 or none for full
depth; the knobs set in the environment around the count): prints the
count's ``temp``, the live and ``virtual`` bytes at its peak, and the
live storages there grouped by the op that created each, whether a
backward node ran it, and the first three frames of `repro_torch` code
on its stack (the counter's own frames and the collective helpers' left
out), largest first.  Two trees or two knobs set side by side show which
storages a change added to the peak; ``virtual`` is the trip count's
left-out steps'.  With ``--card`` the step is counted once more on the
card (its local shards CUDA tensors over the fake group, as
``chip_smoke.py``'s phase 17 (b) runs it) and the groups that differ
between the two counts are printed (a backward op run on the card's
autograd thread shows no frames).  A full xlstm-1.3b ``train_4k`` count
takes about a minute on a CPU.
"""
import collections
import dataclasses
import os
import sys

import torch

from repro_torch.configs.registry import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun


def _site() -> str:
    f, out = sys._getframe(2), []
    while f is not None and len(out) < 3:
        name = f.f_code.co_filename
        if "repro_torch" in name and not name.endswith(
                ("dryrun.py", "axes.py")):
            out.append(f"{os.path.basename(name)}:{f.f_lineno}:"
                       f"{f.f_code.co_name}")
        f = f.f_back
    return " < ".join(out)


class PeakCounter(dryrun.StepCounter):
    """`launch.dryrun.StepCounter` that notes, for each storage it
    counts, the op and the code that made it, and keeps the live set
    each time the peak rises outside a loop's backward window."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.made, self.at_peak, self._func = {}, None, None
        counter = self

        class Noted(dict):
            def __setitem__(self, key, nbytes):
                node = torch._C._current_autograd_node()
                counter.made[key] = (str(counter._func), _site(),
                                     "backward" if node else "forward")
                dict.__setitem__(self, key, nbytes)

        self._new = Noted()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._func = func
        return super().__torch_dispatch__(func, types, args, kwargs)

    def _touch(self):
        before = self.peak
        super()._touch()
        if self.peak > before and self._window is None:
            self.at_peak = (self.live, self.virtual, {
                k: self.made[k] + (n,) for k, n in self._new.items()})


def count(cfg, shape, mesh: str, device: str):
    """The step's count on ``device`` (``meta`` or ``cuda``) and the live
    storages at its peak grouped as ``{(phase, op, site): [bytes, n]}``."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.registry import get_model

    counters = []

    class Kept(PeakCounter):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            counters.append(self)

    dryrun.StepCounter = Kept
    m = make_production_mesh(multi_pod=mesh == "multipod")
    with dryrun.partitioned_cell(get_model(cfg), SHAPES[shape], m,
                                 device=device) as cell:
        c = dryrun.count_step(cell, local=True)
    live, virtual, items = counters[-1].at_peak
    print(f"{device}: temp {c['temp']:.0f}  at the peak: live {live}  "
          f"virtual {virtual}")
    groups = collections.defaultdict(lambda: [0, 0])
    for op, site, phase, nbytes in items.values():
        g = groups[(phase, op, site)]
        g[0] += nbytes
        g[1] += 1
    return groups


def show(groups):
    for (phase, op, site), (nbytes, n) in sorted(
            groups.items(), key=lambda kv: -abs(kv[1][0])):
        print(f"{nbytes:>14,d} B {n:>5d}  {phase:8s} {op:38s} {site}")


def main(argv):
    card = "--card" in argv
    argv = [a for a in argv if a != "--card"]
    arch, shape, mesh = argv[:3]
    layers = int(argv[3]) if len(argv) > 3 and "=" not in argv[3] else 0
    os.environ.update(a.split("=", 1) for a in argv[3:] if "=" in a)
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    meta = count(cfg, shape, mesh, "meta")
    if not card:
        show(meta)
        return
    on_card = count(cfg, shape, mesh, "cuda")
    print("card less meta, the groups that differ:")
    show({k: [on_card.get(k, [0, 0])[0] - meta.get(k, [0, 0])[0],
              on_card.get(k, [0, 0])[1] - meta.get(k, [0, 0])[1]]
          for k in set(meta) | set(on_card)
          if on_card.get(k) != meta.get(k)})


if __name__ == "__main__":
    main(sys.argv[1:])
