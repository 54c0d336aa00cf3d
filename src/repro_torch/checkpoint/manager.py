"""Checkpoints with atomic commits (port of `repro/checkpoint/manager.py`).

Layout (one directory per step, committed atomically by rename), the
reference's:

    <root>/step_00000100.tmp/        # written here ...
    <root>/step_00000100/            # ... then renamed (atomic on POSIX)
        manifest.json                # tree paths, shapes, dtypes, extra
        <leaf-path>.npy              # one array per leaf (np.save)

A tree is nested dicts, lists, tuples and named tuples (`OptState`) of
tensors; a leaf's path joins its keys, indices and field names with "/",
as the reference's does.  bfloat16 is
stored as a raw 16-bit view (npy has no bf16 dtype) beside its logical
dtype in the manifest.

  * ``save_async`` copies every leaf to host memory synchronously, then
    writes the files on a background thread: the train loop never blocks
    on disk, and in-place updates after the call do not reach the files.
  * ``keep_n`` bounds disk usage; the newest N step directories survive.
  * Restoring writes the stored values **into** the target tree's tensors
    in place (on their devices), so a restore needs no second copy of the
    state on the card.  A leaf missing from the checkpoint raises
    `KeyError`; a shape or dtype that differs from the target's raises
    `ValueError`.  Target leaves that are not tensors come back as CPU
    tensors.
  * A DTensor leaf (sharded training, ``train --mesh``) is written whole
    (`full_tensor`, a collective every rank joins) and restored into its
    shards.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

__all__ = ["CheckpointManager", "load_pytree", "save_pytree"]

_MANIFEST = "manifest.json"


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _map_with_paths(fn: Callable[[str, Any], Any], tree: Any,
                    prefix: Tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over the leaves, keeping the tree's structure."""
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, v, prefix + (str(k),)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_map_with_paths(fn, v, prefix + (name,))
                            for name, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_paths(fn, v, prefix + (str(i),)) for i, v in enumerate(tree))
    return fn("/".join(prefix), tree)


def _leaf_filename(key: str) -> str:
    return key.replace("/", ".") + ".npy"


def _whole(leaf: Any) -> Any:
    """A DTensor leaf gathered whole (every rank calls this together)."""
    return leaf.detach().full_tensor() if isinstance(leaf, DTensor) else leaf


def _to_host(leaf: Any) -> Any:
    """A host copy of a leaf that later in-place updates cannot reach."""
    if isinstance(leaf, torch.Tensor):
        return _whole(leaf).detach().to("cpu", copy=True)
    return np.array(leaf)


def _as_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    """(array to write, logical dtype name) of a leaf."""
    if isinstance(leaf, torch.Tensor):
        t = _whole(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:  # npy can't store bf16: a 16-bit view
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_pytree(directory: str, tree: Any, *, extra: Optional[Dict] = None) -> None:
    """Write a tree of tensors into ``directory`` (replaced if it exists)."""
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    entries = {}

    def write(key, leaf):
        arr, dtype = _as_numpy(leaf)
        fname = _leaf_filename(key)
        np.save(os.path.join(tmp, fname), arr)
        entries[key] = {"file": fname, "dtype": dtype, "shape": list(arr.shape)}

    _map_with_paths(write, tree)
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump({"entries": entries, "extra": extra or {}}, f, indent=1)
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.replace(tmp, directory)  # atomic commit


def _read_leaf(directory: str, meta: Dict[str, Any]) -> torch.Tensor:
    raw = np.load(os.path.join(directory, meta["file"]))
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(raw)


def load_pytree(directory: str, target_tree: Any) -> Tuple[Any, Dict]:
    """Restore into the structure, and the tensors, of ``target_tree``;
    returns (tree, the manifest's extra)."""
    with open(os.path.join(directory, _MANIFEST)) as f:
        manifest = json.load(f)
    entries = manifest["entries"]

    def restore(key, ref):
        if key not in entries:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        value = _read_leaf(directory, entries[key])
        want = tuple(ref.shape) if isinstance(ref, torch.Tensor) else np.shape(ref)
        if tuple(value.shape) != tuple(want):
            raise ValueError(f"leaf {key!r}: checkpoint shape {tuple(value.shape)} != target "
                             f"{tuple(want)}")
        if not isinstance(ref, torch.Tensor):
            return value
        if value.dtype != ref.dtype:
            raise ValueError(f"leaf {key!r}: checkpoint dtype {value.dtype} != target {ref.dtype}")
        with torch.no_grad():
            if isinstance(ref, DTensor):
                value = distribute_tensor(value.to(ref.device), ref.device_mesh, ref.placements)
            ref.copy_(value)
        return ref

    return _map_with_paths(restore, target_tree), manifest["extra"]


@dataclasses.dataclass
class CheckpointManager:
    """Step-indexed checkpoints with keep-N retention and async writes."""

    root: str
    keep_n: int = 3

    def __post_init__(self) -> None:
        os.makedirs(self.root, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- paths ---------------------------------------------------------------

    def step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name[len("step_"):]))
                except ValueError:
                    continue
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save ----------------------------------------------------------------

    def save(self, step: int, tree: Any, *, extra: Optional[Dict] = None) -> None:
        save_pytree(self.step_dir(step), tree, extra=(extra or {}) | {"step": step})
        self._gc()

    def save_async(self, step: int, tree: Any, *, extra: Optional[Dict] = None) -> None:
        """Snapshot to host now; write on a background thread."""
        self.wait()  # one in-flight save at a time
        host_tree = _map_with_paths(lambda _, leaf: _to_host(leaf), tree)

        def _work():
            try:
                self.save(step, host_tree, extra=extra)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore -------------------------------------------------------------

    def restore(self, target_tree: Any, *, step: Optional[int] = None) -> Tuple[Any, Dict]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        return load_pytree(self.step_dir(step), target_tree)

    # -- retention -----------------------------------------------------------

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: max(len(steps) - self.keep_n, 0)]:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)
