"""Atomic, async checkpoints of a state tree (port of
`repro.runtime.checkpoint`).

Layout, the reference's:

  <dir>/step_<N>/
     meta.json            (step, shard count, each leaf's shape and dtype)
     shard_<i>.npz        (flattened leaves, chunked by size)
  <dir>/LATEST            (atomic pointer file)

A leaf's key joins its path with "||" (dict keys, list indices), as the
reference's does.  Writes go to a `.tmp` directory that is renamed into
place, so a crash mid-save never corrupts the latest checkpoint.
`AsyncSaver.save` copies the state to host memory before it returns
(the optimizer updates the device state in place) and serializes on a
background thread.  `restore` loads into a target tree's structure, each
leaf onto its target's device and dtype.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.core.tree import (flatten_with_paths, tree_map,
                                   tree_map_with_path)

FLAT_SEP = "||"


def _host(leaf):
    """A leaf as a numpy array that owns its memory."""
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _flatten(tree) -> dict:
    return {FLAT_SEP.join(path): leaf
            for path, leaf in flatten_with_paths(tree)}


def save(state, step: int, ckpt_dir: str, *, shard_mb: int = 512) -> str:
    """Write `state` as step `step` under ckpt_dir -> the step's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = {k: v if isinstance(v, np.ndarray) else _host(v)
            for k, v in _flatten(state).items()}
    shards, cur, cur_bytes = [], {}, 0
    for k, v in flat.items():
        cur[k] = v
        cur_bytes += v.nbytes
        if cur_bytes >= shard_mb * (1 << 20):
            shards.append(cur)
            cur, cur_bytes = {}, 0
    if cur:
        shards.append(cur)
    meta = {"step": step, "n_shards": len(shards),
            "keys": {k: [list(v.shape), str(v.dtype)]
                     for k, v in flat.items()}}
    for i, sh in enumerate(shards):
        np.savez(os.path.join(tmp, f"shard_{i}.npz"), **sh)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    ptr_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(os.path.basename(final))
    os.replace(ptr_tmp, os.path.join(ckpt_dir, "LATEST"))
    return final


class AsyncSaver:
    """One in-flight save at a time; join() before exit."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None

    def save(self, state, step: int, ckpt_dir: str):
        self.join()
        host_state = tree_map(_host, state)      # device -> host now
        self._thread = threading.Thread(
            target=save, args=(host_state, step, ckpt_dir), daemon=True)
        self._thread.start()

    def join(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(ckpt_dir: str) -> Optional[int]:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[-1])


def load_flat(ckpt_dir: str, step: Optional[int] = None):
    """-> ({key: numpy array} of a checkpoint, its step); the latest one
    when step is None."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    data = {}
    for i in range(meta["n_shards"]):
        with np.load(os.path.join(d, f"shard_{i}.npz")) as z:
            data.update({k: z[k] for k in z.files})
    return data, step


def restore(ckpt_dir: str, target, *, step: Optional[int] = None):
    """Load into the structure of `target` (a tree of tensors) -> (state,
    step): new tensors on each target leaf's device and dtype, keeping
    its requires_grad.  A missing leaf raises KeyError, a shape that
    differs ValueError."""
    data, step = load_flat(ckpt_dir, step)

    def load(path, leaf):
        key = FLAT_SEP.join(path)
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = data[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {tuple(leaf.shape)}")
        t = torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
        return t.requires_grad_(leaf.requires_grad)

    return tree_map_with_path(load, target), step
