"""What the stages that replay captured CUDA graphs share: when a call may
replay (:func:`graph_device`), the side stream captures run on, and the
least-recently-used table of captured keys.

A call replays only when every input is a tensor on one CUDA device and
nothing around it would see the replay differently from the eager ops: a
functorch transform (a caller's ``vmap``, ``grad`` or ``jvp``), a capture
already under way, or inputs that record autograd. Every other call runs
the eager ops.
"""

from __future__ import annotations

import collections
import functools
from typing import Callable

import torch

from . import _tree


def plain_call(leaves: list) -> bool:
    """No functorch transform wraps the call or its inputs, no capture is
    under way on the current stream, and no input records autograd. Asks
    the current CUDA device."""
    F = torch._C._functorch
    return (F.maybe_current_level() is None
            and not any(F.is_functorch_wrapped_tensor(x) for x in leaves)
            and not (torch.is_grad_enabled()
                     and any(x.requires_grad for x in leaves))
            and not torch.cuda.is_current_stream_capturing())


def graph_device(*trees) -> torch.device | None:
    """The card on which a call replays captured graphs, or ``None`` for
    the eager ops: every input is a tensor on one CUDA device and the call
    is plain (:func:`plain_call`)."""
    leaves = _tree.tree_leaves(trees)
    if not leaves or not all(isinstance(x, torch.Tensor) for x in leaves):
        return None
    dev = leaves[0].device
    if dev.type != "cuda" or any(x.device != dev for x in leaves):
        return None
    with torch.cuda.device(dev):
        return dev if plain_call(leaves) else None


@functools.cache
def capture_stream(dev: torch.device) -> torch.cuda.Stream:
    return torch.cuda.Stream(dev)


def shape_key(leaves: list) -> tuple:
    """Every leaf's shape and dtype, the part of a key the inputs give."""
    return tuple((tuple(x.shape), x.dtype) for x in leaves)


def lookup(table: collections.OrderedDict, key, make: Callable, keep: int):
    """``table[key]``, made by ``make()`` when absent; the least recently
    used entry is dropped past ``keep``."""
    value = table.pop(key, None)
    if value is None:
        value = make()
    table[key] = value
    if len(table) > keep:
        table.popitem(last=False)
    return value
