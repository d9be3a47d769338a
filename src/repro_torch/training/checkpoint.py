"""Atomic, async checkpointing: the JAX package's
``training/checkpoint.py``.

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
arrays on a device.

A sharded state (each leaf the rank's block under its spec in
``shardings``, on ``mesh``) is saved whole: every leaf is gathered on
every rank, rank 0 writes the manifest a single process would write (the
same keys, shapes and dtypes), and the ranks meet at a barrier.  ``load``
with ``shardings`` and ``mesh`` hands each rank its block of each whole
array (``sharding.local_slice``), whatever mesh saved it: the JAX
package's elastic restore.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import device as devmod
from repro_torch.distributed import sharding as shd


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


def gather_to_host(tree: Any, shardings: Any, mesh) -> Optional[Any]:
    """A sharded ``tree``'s whole leaves on the host of the writer (rank
    0), gathered one leaf at a time so that no rank holds more than one
    whole leaf on its device; None on the other ranks (a collective)."""
    writer = is_writer()

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        whole = shd.gather_slices(t.detach().contiguous(), s, mesh)
        return whole.to("cpu", copy=True) if writer else None
    out = walk(tree, shardings)
    return out if writer else None


def is_writer() -> bool:
    """Whether this process writes the checkpoint: rank 0, or a process
    in no group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def save(path: str, tree: Any, *, step: int, extra: Optional[Dict] = None,
         shard_arrays: int = 1, shardings: Any = None, mesh=None) -> None:
    """Synchronous atomic save of a tree of (device or host) arrays; with
    ``mesh``, of the whole arrays of a sharded tree (gathered, written by
    rank 0, the ranks meeting at a barrier)."""
    if mesh is not None:
        whole = gather_to_host(tree, shardings, mesh)
        if whole is not None:
            save(path, whole, step=step, extra=extra,
                 shard_arrays=shard_arrays)
        dist.barrier()
        return
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


def _members(path: str) -> Dict[str, Any]:
    """Each array of an ``.npz`` file by member name, as an ``np.memmap``
    over the file where the member is stored uncompressed
    (``np.savez`` stores so), else read whole: a rank that needs a block
    of a stored array reads the block's pages, not the array."""
    import zipfile
    out: Dict[str, Any] = {}
    with zipfile.ZipFile(path) as z, open(path, "rb") as f:
        for info in z.infolist():
            name = info.filename[:-4] if info.filename.endswith(".npy") \
                else info.filename
            if info.compress_type != zipfile.ZIP_STORED:
                with z.open(info) as m:
                    out[name] = np.lib.format.read_array(m)
                continue
            # the member's data follows its local header (30 bytes, the
            # name and the extra field), then the .npy header
            f.seek(info.header_offset + 26)
            n_name, n_extra = np.frombuffer(f.read(4), "<u2")
            f.seek(info.header_offset + 30 + int(n_name) + int(n_extra))
            header = (np.lib.format.read_array_header_1_0
                      if np.lib.format.read_magic(f) == (1, 0)
                      else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = header(f)
            # copy-on-write: torch takes it as writable; the file stays
            out[name] = np.memmap(path, dtype=dtype, mode="c",
                                  offset=f.tell(), shape=shape,
                                  order="F" if fortran else "C")
    return out


def load(path: str, like: Any, *, device=None, shardings: Any = None,
         mesh=None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``like`` (its values are read for
    their shapes only; meta tensors do) on ``device`` (None: the card).
    With ``shardings`` (a tree of specs parallel to ``like``) and
    ``mesh``, each leaf is this rank's block of the saved array, and
    ``like`` holds the blocks' shapes.  Returns (tree, manifest); a
    missing key raises ``KeyError``, a shape that differs
    ``ValueError``."""
    dev = devmod.resolve(device)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    where = {k: (fname, j) for fname, keys in manifest["files"]
             for j, k in enumerate(keys)}
    specs = dict(_flatten(shardings)) if mesh is not None else {}
    files: Dict[str, Any] = {}
    vals = {}
    for k, ref in _flatten(like):
        if k not in where:
            raise KeyError(f"checkpoint missing {k}")
        fname, j = where[k]
        if fname not in files:
            files[fname] = _members(os.path.join(path, fname))
        a = files[fname][f"a{j}"]
        t = _decode(a, manifest.get("dtypes", {}).get(k))
        if mesh is not None:
            t = shd.local_slice(t, specs[k], mesh)
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{k}: shape {tuple(t.shape)} != "
                             f"{tuple(ref.shape)}")
        # a copy: the pages of a mapped array are read here, once
        vals[k] = t.to(dev, copy=True).contiguous()
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
