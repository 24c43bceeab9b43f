"""The platform's batch axis over several devices of one host.

`run_frontend` is batched along its first axis (Mess pace points or
stacked application traces), and every kernel and op it runs is
independent along that axis (no cross-row reduction, no collective).
`sharded_vmap` splits the axis into contiguous chunks, runs each chunk
on its own device and concatenates the results in order, so the result
is **bit-identical** to the unsplit call: the reference's argument
(``repro.core.shard``), which maps the axis with ``shard_map``.  The
port's functions are already batched, so there is no ``vmap`` to wrap:
``fn(chunk, device)`` runs one chunk on one device.

Where a batch runs is one argument, ``device``, on every entry point
(`mess.sweep`, the ``replay_*`` functions and the drivers over them),
read by `resolve_devices`: ``None`` is the card, an explicit device that
device, a list of devices the batch spread over them.  Spreading is
asked for, not the default (the reference's default is every device):
one host thread enqueues the chunks one after another, each chunk's
whole window loop, and a chunk costs the host about what the whole
batch does.  A card starts on its chunk while the host enqueues the
next one, and nothing is read back before the last chunk is enqueued
(the window loop never waits on the device), but the host's work is
not shared out, so on these host-bound paths several cards are not
expected to beat one; no run on several cards has measured it.  Each
kernel wrapper launches under ``torch.cuda.device`` of its tensors, so a
chunk on ``cuda:1`` launches on ``cuda:1`` whatever the current device.

A batch that does not divide the device count is split into near-equal
chunks, the first ones a row longer; no chunk is empty, so 3 rows on 4
devices run on the first 3.  Nothing is padded: no kernel needs equal
chunks.  The reference's ``n_devices`` is the length of the device
list, and a list naming a card that is not there raises.  Its
``donate`` has no torch counterpart and none is needed: the port's
callers (`mess.sweep`, `replay`) rebuild their inputs per call and
never hand a buffer over.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.platform import resolve_device


def device_count() -> int:
    """Cards on the host (0 without one)."""
    return torch.cuda.device_count()


def _check_device(dev: torch.device) -> torch.device:
    """``dev`` as given; a card that is not there raises."""
    dev = resolve_device(dev)
    if dev.type == "cuda" and dev.index is not None \
            and dev.index >= device_count():
        raise ValueError(f"{dev} is not present: this host has "
                         f"{device_count()} CUDA devices")
    return dev


def resolve_devices(device=None) -> list[torch.device]:
    """The devices an entry point runs its batch on.

    ``None`` means the card (`platform.resolve_device`: the current
    CUDA device); an explicit device (``"cuda:k"``, ``"cpu"``) means
    that device alone; a list or tuple of devices spreads the batch over
    them, used as given (a device may repeat: chunks on one card).  A
    card that is not there raises; nothing falls back to the CPU.
    """
    if isinstance(device, (list, tuple)):
        devs = [_check_device(d) for d in device]
        if not devs:
            raise ValueError("the device list is empty")
        return devs
    return [_check_device(device)]


def _rows(tree) -> int:
    if isinstance(tree, dict):
        return _rows(next(iter(tree.values())))
    if isinstance(tree, tuple):
        return _rows(tree[0])
    return tree.shape[0]


def _slice(tree, a: int, b: int):
    """Rows ``a:b`` of every leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _slice(v, a, b) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_slice(v, a, b) for v in tree))
    if isinstance(tree, tuple):
        return tuple(_slice(v, a, b) for v in tree)
    return tree[a:b]


def _concat(parts):
    """The chunks' outputs joined along the leading axis, in order.

    Tensors on one device join there; tensors on several devices are
    read back to the host (in chunk order, after every chunk has been
    enqueued) and join there.  Numpy arrays join as numpy arrays.
    """
    first = parts[0]
    if isinstance(first, dict):
        return {k: _concat([p[k] for p in parts]) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_concat(list(col)) for col in zip(*parts)))
    if isinstance(first, tuple):
        return tuple(_concat(list(col)) for col in zip(*parts))
    if isinstance(first, torch.Tensor):
        if len({p.device for p in parts}) > 1:
            parts = [p.cpu() for p in parts]
        return torch.cat(parts)
    if isinstance(first, np.ndarray):
        return np.concatenate(parts)
    raise TypeError(f"sharded_vmap joins tensors and numpy arrays, "
                    f"not {type(first).__name__}")


def chunk_bounds(n: int, n_devices: int) -> list[tuple[int, int]]:
    """``(start, stop)`` of near-equal contiguous chunks of ``n`` rows
    over at most ``n_devices`` devices, none empty (the first chunks a
    row longer)."""
    k = max(min(n, n_devices), 1)
    sizes = [n // k + (i < n % k) for i in range(k)]
    stops = np.cumsum(sizes).tolist()
    return list(zip([0] + stops[:-1], stops))


def sharded_vmap(fn, devices):
    """``fn`` over the leading axis, split across ``devices``.

    Args:
        fn: ``fn(chunk, device)`` runs rows of the batch (a tensor, a
            numpy array, or a dict / tuple / NamedTuple of them) on one
            device and returns a dict, tuple or NamedTuple of tensors or
            numpy arrays with the same leading axis; it must be
            independent along that axis.
        devices: the devices to spread over (`resolve_devices`'s list:
            it may repeat a device, ``[cpu] * 4`` in the tests).  Used
            as given, never replaced or cut, but no chunk is empty; a
            card that is not there raises.
    Returns:
        ``batched(tree)``: with one device, ``fn(tree, device)`` on the
        whole batch (no split); otherwise the chunks' outputs joined in
        order, one row per input row, bit-identical to the unsplit
        call.
    """
    devices = resolve_devices(list(devices))
    if len(devices) == 1:
        return functools.wraps(fn)(lambda tree: fn(tree, devices[0]))

    @functools.wraps(fn)
    def batched(tree):
        bounds = chunk_bounds(_rows(tree), len(devices))
        # enqueue every chunk before any result is read back
        parts = [fn(_slice(tree, a, b), dev)
                 for (a, b), dev in zip(bounds, devices)]
        return parts[0] if len(parts) == 1 else _concat(parts)

    return batched
