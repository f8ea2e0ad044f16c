"""Failure detection and elastic recovery.

Port of ``vil_sensor_fusion_tpu/utils/health.py``: finiteness probes over a
tree of tensors, the estimator health verdict, and ``guarded_update``, which
selects the new state where healthy and the previous one otherwise. The
verdict and the select both stay on the device (``torch.where``), so a
guarded step makes no host round trip.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from .._tree import tree_leaves, tree_map


def _float_leaves(tree: Any) -> list[torch.Tensor]:
    return [l for l in tree_leaves(tree)
            if isinstance(l, torch.Tensor) and l.is_floating_point()]


def finite_fraction(tree: Any) -> torch.Tensor:
    """Fraction of finite scalars across all floating leaves (1.0 = healthy)."""
    leaves = _float_leaves(tree)
    if not leaves:
        return torch.tensor(1.0)
    tot = sum(l.numel() for l in leaves)
    fin = sum(torch.sum(torch.isfinite(l)) for l in leaves)
    return fin / float(tot)


def all_finite(tree: Any) -> torch.Tensor:
    """Scalar bool tensor: every floating leaf entry is finite."""
    leaves = _float_leaves(tree)
    if not leaves:
        return torch.tensor(True)
    ok = torch.all(torch.isfinite(leaves[0]))
    for l in leaves[1:]:
        ok = ok & torch.all(torch.isfinite(l))
    return ok


class HealthLimits(NamedTuple):
    """Divergence bounds. Defaults generous for ground vehicles."""
    max_speed: float = 100.0      # m/s
    max_bias_acc: float = 5.0     # m/s^2
    max_bias_gyro: float = 1.0    # rad/s


def check_state(vel: torch.Tensor, bias: torch.Tensor,
                limits: HealthLimits = HealthLimits(),
                extra_tree: Any = None) -> torch.Tensor:
    """Scalar bool health verdict: finite velocity and bias within bounds,
    and every entry of ``extra_tree`` finite."""
    ok = torch.all(torch.isfinite(vel)) & torch.all(torch.isfinite(bias))
    speed2 = torch.sum(vel * vel, dim=-1)
    ok = ok & torch.all(speed2 <= limits.max_speed ** 2)
    ba2 = torch.sum(bias[..., :3] ** 2, dim=-1)
    bg2 = torch.sum(bias[..., 3:] ** 2, dim=-1)
    ok = ok & torch.all(ba2 <= limits.max_bias_acc ** 2)
    ok = ok & torch.all(bg2 <= limits.max_bias_gyro ** 2)
    if extra_tree is not None:
        ok = ok & all_finite(extra_tree)
    return ok


def guarded_update(prev_state: Any, new_state: Any,
                   healthy: torch.Tensor) -> Any:
    """Select ``new_state`` where healthy, else keep ``prev_state``."""
    return tree_map(lambda new, old: torch.where(healthy, new, old),
                    new_state, prev_state)


def wrap_step(step_fn: Callable, health_fn: Callable[[Any], torch.Tensor]):
    """A step function that applies :func:`guarded_update`; it returns
    ``(state, healthy, *rest)``."""
    def wrapped(state, *args, **kwargs):
        out = step_fn(state, *args, **kwargs)
        new_state, rest = (out[0], out[1:]) if isinstance(out, tuple) else (
            out, ())
        healthy = health_fn(new_state)
        return (guarded_update(state, new_state, healthy), healthy) + tuple(rest)
    return wrapped
