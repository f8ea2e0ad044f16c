"""Carry state between the JAX package and the port.

:func:`to_torch` turns a tree of the JAX package's NamedTuples (configs,
states, maps, sweeps, worlds, timelines) holding numpy or JAX arrays into
the port's type of the same name, with tensor leaves on a given device.
The counterpart type is found by module path
(``vil_sensor_fusion_tpu.X.Y.Name`` → ``vil_sensor_fusion_tpu_torch.X.Y.Name``)
and fields are matched by name: a field the port's type lacks is dropped,
one it adds keeps its default. Nothing here imports ``jax``: array leaves
are read through the ``__array__`` protocol. Python and numpy scalars are
static config values and come out as Python scalars.

:func:`to_numpy` goes the other way: the same structure, numpy leaves.
"""

from __future__ import annotations

import importlib
from typing import Any

import numpy as np
import torch

from . import DEFAULT_DEVICE

_JAX_PACKAGE = "vil_sensor_fusion_tpu"
_PORT_PACKAGE = __name__.rsplit(".", 1)[0]


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _port_type(cls: type) -> type:
    """The port's NamedTuple type matching ``cls`` (a JAX-package or port
    type)."""
    mod = cls.__module__
    if mod == _PORT_PACKAGE or mod.startswith(_PORT_PACKAGE + "."):
        return cls
    if mod == _JAX_PACKAGE or mod.startswith(_JAX_PACKAGE + "."):
        port_mod = importlib.import_module(_PORT_PACKAGE
                                           + mod[len(_JAX_PACKAGE):])
        port_cls = getattr(port_mod, cls.__name__, None)
        if port_cls is None:
            raise TypeError(f"{mod}.{cls.__name__} has no counterpart in "
                            f"the port")
        return port_cls
    return cls


def _leaf_to_torch(x: Any, device, dtype) -> Any:
    if isinstance(x, np.generic):
        # A numpy scalar is a config value (e.g. ``pose_ic`` given as
        # ``tuple(np.asarray(...))``): it becomes a Python scalar.
        return x.item()
    if isinstance(x, (bool, int, float, str)) or x is None:
        return x                               # static config value
    if isinstance(x, torch.Tensor):
        t = x.to(device)
    elif isinstance(x, np.ndarray) or hasattr(x, "__array__"):
        t = torch.as_tensor(np.array(x), device=device)
    else:
        return x
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def to_torch(tree: Any, device=DEFAULT_DEVICE,
             dtype: torch.dtype | None = None) -> Any:
    """JAX-package tree (numpy/JAX leaves) → port tree (tensor leaves on
    ``device``); floating leaves are cast to ``dtype`` when given."""
    if _is_namedtuple(tree):
        cls = _port_type(type(tree))
        kw = {f: to_torch(getattr(tree, f), device, dtype)
              for f in cls._fields if f in tree._fields}
        return cls(**kw)
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_torch(x, device, dtype) for x in tree)
    if isinstance(tree, dict):
        return {k: to_torch(v, device, dtype) for k, v in tree.items()}
    return _leaf_to_torch(tree, device, dtype)


def to_numpy(tree: Any) -> Any:
    """Port tree → the same structure with numpy leaves."""
    if _is_namedtuple(tree):
        return type(tree)(*(to_numpy(x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(x) for x in tree)
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree
