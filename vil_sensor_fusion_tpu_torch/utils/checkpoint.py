"""Checkpoint / resume for estimator state.

Port of ``vil_sensor_fusion_tpu/utils/checkpoint.py``. Every estimator
state is a tree (NamedTuples, tuples, lists, dicts) of fixed-shape
tensors, so checkpointing is generic:

- :func:`save` / :func:`restore` — one tree ↔ one ``.npz`` file. Restore
  takes a *template* tree (e.g. a freshly ``init()``-ed state) so the
  structure, dtypes, devices and NamedTuple classes round-trip exactly.
- :class:`CheckpointManager` — numbered step checkpoints with retention,
  atomic rename, and ``latest_step()`` discovery for resume-after-crash.

The ``.npz`` keys are the JAX package's: ``jax.tree_util``'s key path of
each leaf, its entries joined by ``//`` — ``.name`` for a NamedTuple
field, ``[i]`` for a tuple or list index, ``['key']`` (the key's repr)
for a dict key, with dict keys in sorted order and ``None`` holding no
leaf. So a checkpoint written by either package restores into the other's
template of the same state.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Optional

import numpy as np
import torch

_SEP = "//"


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree: Any):
    """(key-path entry, child) pairs of a tree node, or None for a leaf."""
    if tree is None:
        return []
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(f"[{i}]", x) for i, x in enumerate(tree)]
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    return None


def _leaves_with_keys(tree: Any, path: tuple = ()):
    kids = _children(tree)
    if kids is None:
        yield _SEP.join(path), tree
        return
    for entry, child in kids:
        yield from _leaves_with_keys(child, path + (entry,))


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _rebuild(tree: Any, leaves) -> Any:
    """``tree``'s structure with its leaves taken in order from ``leaves``."""
    kids = _children(tree)
    if kids is None:
        return next(leaves)
    if tree is None:
        return None
    new = [_rebuild(child, leaves) for _, child in kids]
    if _is_namedtuple(tree):
        return type(tree)(*new)
    if isinstance(tree, (tuple, list)):
        return type(tree)(new)
    return dict(zip(sorted(tree), new))


def save(path: str, tree: Any) -> None:
    """Write a tree of tensors to ``path`` (.npz), atomically."""
    flat = {k: _to_numpy(v) for k, v in _leaves_with_keys(tree)}
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def restore(path: str, template: Any) -> Any:
    """Load a tree saved by :func:`save` (or by the JAX package) into
    ``template``'s structure: each tensor leaf comes back with the
    template leaf's dtype on its device, any other leaf as a numpy array.

    Leaf shapes and dtype kinds are checked against the template, so a
    config change between save and resume fails loudly instead of
    mis-assembling state."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    new_leaves = []
    for key, leaf in _leaves_with_keys(template):
        if key not in flat:
            raise KeyError(f"checkpoint {path!r} missing leaf {key!r}")
        arr = flat[key]
        tleaf = _to_numpy(leaf)
        if arr.shape != tleaf.shape:
            raise ValueError(
                f"checkpoint leaf {key!r} shape {arr.shape} != template "
                f"{tleaf.shape}")
        if arr.dtype.kind != tleaf.dtype.kind:
            raise ValueError(
                f"checkpoint leaf {key!r} dtype {arr.dtype} is a different "
                f"kind than template {tleaf.dtype} — refusing the lossy cast")
        arr = arr.astype(tleaf.dtype)
        if isinstance(leaf, torch.Tensor):
            arr = torch.as_tensor(arr, device=leaf.device)
        new_leaves.append(arr)
    return _rebuild(template, iter(new_leaves))


class CheckpointManager:
    """Numbered step checkpoints with retention.

    >>> mgr = CheckpointManager(dir, keep=3)
    >>> mgr.save(step, state)          # ckpt_000000123.npz (atomic)
    >>> step = mgr.latest_step()       # resume discovery
    >>> state = mgr.restore(step, template)
    """

    _PAT = re.compile(r"^ckpt_(\d{9})\.npz$")

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = int(keep)
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:09d}.npz")

    def steps(self):
        out = []
        for name in os.listdir(self.directory):
            m = self._PAT.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any) -> str:
        path = self._path(step)
        save(path, tree)
        if self.keep > 0:
            for old in self.steps()[: -self.keep]:
                os.unlink(self._path(old))
        return path

    def restore(self, step: int, template: Any) -> Any:
        return restore(self._path(step), template)

    def restore_latest(self, template: Any):
        """(step, state) of the newest checkpoint, or (None, template)."""
        step = self.latest_step()
        if step is None:
            return None, template
        return step, self.restore(step, template)
