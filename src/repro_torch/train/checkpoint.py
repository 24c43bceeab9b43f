"""Atomic, durable, resumable checkpointing.

Layout (the reference's ``train/checkpoint.py``, file for file, so that
each package restores the other's checkpoints)::

    <dir>/step_00000100/
        manifest.json          # step, leaf paths, shapes, dtypes
        arrays/<flat.key>.npy  # one file per tree leaf
    <dir>/LATEST               # text file naming the newest complete step

Keys flatten with sorted dict keys (``a.b.0``).  bf16 and fp8 leaves,
which ``np.save`` cannot write, are stored as their raw bits (``uint16``
/ ``uint8``) under the logical dtype name numpy's ``ml_dtypes`` uses
(``"bfloat16"``, never ``"torch.bfloat16"``).

Write protocol (crash-safe): write into ``step_N.tmp/``, fsync every
array file, the manifest and the directories, atomic-rename to
``step_N/``, fsync the parent, then rewrite LATEST.  A partially written
checkpoint can never be named by LATEST.  Unlike the reference, every
``.npy`` and the directory entries are fsynced (the reference fsyncs
only the manifest and LATEST), and `prune` refuses ``keep < 1`` (the
reference's ``steps[:-0]`` deletes nothing).
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

#: dtypes ``np.save`` cannot write, stored as their raw bits: the logical
#: name and the numpy type of the bits on disk (the reference's)
_BITCAST = {torch.bfloat16: ("bfloat16", np.uint16),
            torch.float8_e4m3fn: ("float8_e4m3fn", np.uint8),
            torch.float8_e5m2: ("float8_e5m2", np.uint8)}
_BY_NAME = {name: dt for dt, (name, _) in _BITCAST.items()}
#: the integer type of each width that both numpy and torch hold
_BITS = {2: (np.int16, torch.int16), 1: (np.uint8, torch.uint8)}


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = tree
    return out


def _subtree(flat, key):
    """Entries of `flat` under `key.` (or the exact `key` -> '')."""
    out = {}
    for kk, v in flat.items():
        if kk == key:
            out[""] = v
        elif kk.startswith(key + "."):
            out[kk[len(key) + 1:]] = v
    return out


def _unflatten_into(template, flat):
    if isinstance(template, dict):
        return {k: _unflatten_into(template[k], _subtree(flat, k))
                for k in template}
    if isinstance(template, (list, tuple)):
        typ = type(template)
        return typ(_unflatten_into(v, _subtree(flat, str(i)))
                   for i, v in enumerate(template))
    return flat[""]


def _to_numpy(val):
    """A leaf as (numpy array to write, logical dtype name)."""
    if isinstance(val, torch.Tensor):
        t = val.detach().cpu()
        if t.dtype in _BITCAST:
            name, on_disk = _BITCAST[t.dtype]
            bits = t.view(_BITS[t.element_size()][1]).numpy()
            return bits.view(on_disk), name
        arr = t.numpy()
    else:
        arr = np.asarray(val)
    return arr, str(arr.dtype)


def _fsync_path(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(directory: str, step: int, state) -> str:
    """Atomically and durably save a tree `state` for `step`.  Returns
    the final path."""
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    arrays_dir = os.path.join(tmp, "arrays")
    os.makedirs(arrays_dir)
    manifest = dict(step=step, leaves={})
    for key, val in _flatten(state).items():
        arr, logical = _to_numpy(val)
        with open(os.path.join(arrays_dir, key + ".npy"), "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        manifest["leaves"][key] = dict(shape=list(arr.shape), dtype=logical)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_path(arrays_dir)
    _fsync_path(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_path(directory)
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(name)
        f.flush()
        os.fsync(f.fileno())
    os.replace(os.path.join(directory, "LATEST.tmp"),
               os.path.join(directory, "LATEST"))
    _fsync_path(directory)
    return final


def latest_step(directory: str) -> int | None:
    latest = os.path.join(directory, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(directory, name)):
        return None
    return int(name.split("_")[1])


def _load(path, meta):
    arr = np.load(path)
    if meta["dtype"] in _BY_NAME:
        bits = arr.view(_BITS[arr.itemsize][0])
        return torch.from_numpy(bits.copy()).view(_BY_NAME[meta["dtype"]])
    return torch.from_numpy(arr.copy())


def restore(directory: str, template, step: int | None = None):
    """Restore into the structure of `template`: each leaf takes its
    template leaf's dtype and device, and must have its shape.  Returns
    ``(state, step)``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {key: _load(os.path.join(path, "arrays", key + ".npy"), meta)
            for key, meta in manifest["leaves"].items()}
    restored = _unflatten_into(template, flat)

    def place(t, v, key=""):
        if isinstance(t, dict):
            return {k: place(t[k], v[k], f"{key}{k}.") for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(place(a, b, f"{key}{i}.")
                           for i, (a, b) in enumerate(zip(t, v)))
        t = torch.as_tensor(t)
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint leaf {key[:-1]} has shape "
                             f"{tuple(v.shape)}, the template "
                             f"{tuple(t.shape)}")
        return v.to(device=t.device, dtype=t.dtype)

    return place(template, restored), step


def prune(directory: str, keep: int = 3):
    """Delete all but the newest `keep` (at least 1) complete
    checkpoints."""
    if keep < 1:
        raise ValueError(f"prune keeps at least one checkpoint, got "
                         f"keep={keep}")
    if not os.path.isdir(directory):
        return
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
