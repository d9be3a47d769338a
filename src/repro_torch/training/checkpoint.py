"""Atomic, async checkpointing: the JAX package's
``training/checkpoint.py`` on one device.

Layout:  <dir>/step_<N>/manifest.json + arrays-<shard>.npz
* atomic commit: written to ``step_<N>.tmp`` then ``os.replace``d, so a
  crash mid-save never corrupts the latest checkpoint;
* async: saves run on a background thread off the host's critical path
  (device→host copies happen synchronously, serialisation doesn't).

A tree is nested dicts of tensors (or numpy arrays); its keys are the
port's own names joined by dots (``params.layers.0.attn.wq``,
``v.layers.0.norm1.scale.row``).  npz cannot store bfloat16: such an
array is stored as its uint16 bits with the dtype tag ``bfloat16`` in the
manifest, the JAX package's encoding, and read back through
``Tensor.view(torch.bfloat16)`` (no ``ml_dtypes``).  ``load`` puts the
arrays on a device; restoring onto another topology (the JAX package's
elastic restore) waits for the port's sharding.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import device as devmod


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _flatten(v, f"{prefix}{k}.")
        return out
    return [(prefix[:-1], tree)]


def _unflatten(like: Any, values: Dict[str, Any], prefix: str = "") -> Any:
    if isinstance(like, dict):
        return {k: _unflatten(v, values, f"{prefix}{k}.")
                for k, v in like.items()}
    return values[prefix[:-1]]


def to_host(tree: Any) -> Any:
    """A copy of ``tree`` on the host: every tensor copied to the CPU
    (a CPU tensor too, so later in-place updates leave it as it is)."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree)


def _encode(v: Any) -> Tuple[np.ndarray, str]:
    """(the array npz stores, its dtype tag)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        v = v.numpy()
    v = np.asarray(v)
    if v.dtype.name == "bfloat16":
        return v.view(np.uint16), "bfloat16"
    return v, str(v.dtype)


def _decode(a: np.ndarray, tag: Optional[str]) -> torch.Tensor:
    if tag == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save(path: str, tree: Any, *, step: int, extra: Optional[Dict] = None,
         shard_arrays: int = 1) -> None:
    """Synchronous atomic save of a tree of (device or host) arrays."""
    tmp = f"{path}.tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    host, dtypes = [], {}
    for k, v in _flatten(tree):
        arr, dtypes[k] = _encode(v)
        host.append((k, arr))
    per = max(1, -(-len(host) // shard_arrays))
    files = []
    for i in range(0, len(host), per):
        fname = f"arrays-{i // per:05d}.npz"
        np.savez(os.path.join(tmp, fname),
                 **{f"a{j}": v for j, (_, v) in enumerate(host[i:i + per])})
        files.append((fname, [k for k, _ in host[i:i + per]]))
    manifest = {
        "step": step,
        "keys": [k for k, _ in host],
        "dtypes": dtypes,
        "files": files,
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def load(path: str, like: Any, *, device=None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``like`` (its values are read for
    their shapes only; meta tensors do) on ``device`` (None: the card).
    Returns (tree, manifest); a missing key raises ``KeyError``, a shape
    that differs ``ValueError``."""
    dev = devmod.resolve(device)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    arrays: Dict[str, np.ndarray] = {}
    for fname, keys in manifest["files"]:
        with np.load(os.path.join(path, fname)) as z:
            for j, k in enumerate(keys):
                arrays[k] = z[f"a{j}"]
    vals = {}
    for k, ref in _flatten(like):
        if k not in arrays:
            raise KeyError(f"checkpoint missing {k}")
        a = arrays[k]
        if tuple(a.shape) != tuple(ref.shape):
            raise ValueError(f"{k}: shape {a.shape} != {tuple(ref.shape)}")
        vals[k] = _decode(a, manifest.get("dtypes", {}).get(k)).to(dev)
    return _unflatten(like, vals), manifest


class AsyncSaver:
    """One background save at a time; join() before the next."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def submit(self, fn: Callable[[], None]) -> None:
        self.wait()

        def run():
            try:
                fn()
            except BaseException as e:  # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
