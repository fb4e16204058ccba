"""Fault-tolerant checkpointing of a dict of tensors and numpy arrays (torch
twin of ``repro.checkpoint.checkpointer``, which saves a JAX pytree).

Layout:  <dir>/step_<N>/
           manifest.json   {"step": N, "complete": true, "leaves": {key: meta}}
           arrays.npz      one array per leaf, keyed by its "/"-joined path

Guarantees:
  * atomicity     -- written to ``step_<N>.tmp``, then ``os.rename``
  * durability    -- the arrays and the manifest are fsync'd, then the
                     directory and its parent, so a torn save cannot survive
                     a power loss as a complete-looking checkpoint
  * completeness  -- the manifest is written last; restore ignores a
                     directory without one (or with ``complete: false``) and
                     falls back to the previous step, also past a directory
                     whose arrays are unreadable despite a valid manifest
  * exactness     -- numpy has no bfloat16: a bf16 tensor is saved as its
                     ``uint16`` bit pattern with its dtype in the manifest,
                     so a restore is bit-exact (never through fp32)
  * async         -- ``save(..., blocking=False)`` copies to host memory at
                     once, then writes on a daemon thread
  * retention     -- keeps the newest ``keep`` checkpoints
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zipfile
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["Checkpointer"]

_TORCH_DTYPES = {
    str(d).split(".")[-1]: d
    for d in (torch.float32, torch.float64, torch.float16, torch.bfloat16,
              torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8,
              torch.bool)
}


def _fsync_path(path: str) -> None:
    """fsync a file or a directory by path (a rename is atomic but not
    durable until its directory is synced)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _flatten(tree: Any, prefix: str = "") -> dict:
    """``{"a/b": leaf}`` for a (nested) dict of tensors and arrays."""
    if isinstance(tree, dict):
        flat = {}
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}{k}/"))
        return flat
    return {prefix[:-1]: tree}


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, leaf in flat.items():
        node = tree
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def _to_host(leaf: Any) -> tuple[np.ndarray, dict]:
    """(the array to save, its manifest entry)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        dtype = str(t.dtype).split(".")[-1]
        if t.dtype == torch.bfloat16:
            arr = t.view(torch.int16).numpy().view(np.uint16)
        else:
            arr = t.numpy()
        return arr.copy(), {"kind": "tensor", "dtype": dtype}
    arr = np.asarray(leaf)
    return arr.copy(), {"kind": "numpy", "dtype": str(arr.dtype)}


def _from_host(arr: np.ndarray, meta: dict, like: Any = None) -> Any:
    if meta.get("kind") != "tensor":
        return arr
    dtype = _TORCH_DTYPES[meta["dtype"]]
    arr = np.ascontiguousarray(arr).reshape(arr.shape)  # a 0-d array stays 0-d
    if dtype == torch.bfloat16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if isinstance(like, torch.Tensor):
        t = t.to(like.device)
    return t


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save -----------------------------------------------------------
    def save(self, step: int, tree: dict, blocking: bool = True) -> None:
        self.wait()  # one in-flight async save at a time
        host = {k: _to_host(v) for k, v in _flatten(tree).items()}  # device -> host here

        def _write():
            final = os.path.join(self.directory, f"step_{step:08d}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            arrays = os.path.join(tmp, "arrays.npz")
            np.savez(arrays, **{k: arr for k, (arr, _) in host.items()})
            _fsync_path(arrays)  # the arrays are durable before the manifest exists
            manifest = os.path.join(tmp, "manifest.json")
            with open(manifest, "w") as f:
                json.dump({"step": step, "complete": True,
                           "leaves": {k: meta for k, (_, meta) in host.items()}}, f)
                f.flush()
                os.fsync(f.fileno())
            _fsync_path(tmp)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            _fsync_path(self.directory)  # make the rename durable
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- restore --------------------------------------------------------
    def _manifest(self, step: int) -> dict:
        with open(os.path.join(self.directory, f"step_{step:08d}", "manifest.json")) as f:
            return json.load(f)

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            full = os.path.join(self.directory, name)
            if (name.startswith("step_") and not name.endswith(".tmp")
                    and os.path.exists(os.path.join(full, "manifest.json"))):
                with open(os.path.join(full, "manifest.json")) as f:
                    m = json.load(f)
                if m.get("complete"):
                    steps.append(int(m["step"]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Optional[dict] = None,
                step: Optional[int] = None) -> tuple[dict, int]:
        """``(tree, step)`` of the newest readable checkpoint at or before
        ``step``.  With a ``template`` (a dict of the saved structure) only
        its keys are read and a tensor leaf comes back on the template
        leaf's device; without one, every saved leaf, tensors on the CPU.
        Torn saves are skipped for the previous valid step."""
        candidates = self.all_steps()
        if step is not None:
            candidates = [s for s in candidates if s <= step]
        if not candidates:
            raise FileNotFoundError(
                f"no restorable checkpoint in {self.directory}"
                + (f" at or before step {step}" if step is not None else "")
            )
        errors: list[str] = []
        for s in reversed(candidates):
            path = os.path.join(self.directory, f"step_{s:08d}", "arrays.npz")
            try:
                leaves = self._manifest(s).get("leaves")
                if not isinstance(leaves, dict):
                    raise ValueError("the manifest lists no leaves")
                like = _flatten(template) if template is not None else None
                keys = list(like) if like is not None else list(leaves)
                with np.load(path) as data:
                    flat = {
                        k: _from_host(data[k], leaves.get(k, {}),
                                      None if like is None else like[k])
                        for k in keys
                    }
            except (OSError, KeyError, ValueError, zipfile.BadZipFile) as e:
                errors.append(f"step {s}: {e}")
                continue  # torn or corrupt: fall back to the previous step
            return _unflatten(flat), s
        raise FileNotFoundError(
            f"every candidate checkpoint in {self.directory} is unreadable: "
            f"{'; '.join(errors)}"
        )

    # -- retention ------------------------------------------------------
    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)
