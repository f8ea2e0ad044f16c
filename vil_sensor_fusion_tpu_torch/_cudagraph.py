"""Replaying a stage's step as captured CUDA graphs: when a call may replay
(:func:`graph_device`), and :func:`scan`, the one loop of a step over rows,
eagerly or by replays of the step captured once per key and static flag
(:class:`Graphs`). Three stages replay through it: the fusion engine's
event step (``fusion/engine``), the LiDAR odometry's sweep step, split at
each k-NN search (``frontends/lidar/odometry``), and the VIO EKF's frame
step (``frontends/vio/pipeline``).

A call replays only when every input is a tensor on one CUDA device and
nothing around it would see the replay differently from the eager ops: a
functorch transform (a caller's ``vmap``, ``grad`` or ``jvp``), a capture
already under way, or inputs that record autograd. Every other call runs
the eager ops.
"""

from __future__ import annotations

import collections
import contextlib
import functools
from typing import Callable

import torch

from . import _tree
from .utils import tracing as TR

# Keys kept captured per stage in one process: the experiment grid, the
# window sweep and the ablation run several configurations.
KEEP = 8
_GRAPHS: collections.defaultdict = collections.defaultdict(
    collections.OrderedDict)


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


def _buffer(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


@contextlib.contextmanager
def _swapped(split, stand_in: Callable):
    """``split`` (a (module, name) pair, or ``None``) replaced by
    ``stand_in(the function it holds)`` inside the block."""
    if split is None:
        yield
        return
    real = getattr(*split)
    setattr(*split, stand_in(real))
    try:
        yield
    finally:
        setattr(*split, real)


class Graphs:
    """The captured step of one key: static buffers for the carried state,
    the row, the step's other inputs (``extra``) and its outputs (sized by
    its first, eager call), and per static flag a chain of CUDA graphs of
    the step from the buffers back into them. With ``split``, a (module,
    name) pair, each call of that function ends a graph and opens the next;
    a replay launches it between the two, as the module holds it then, on
    inputs and into outputs that the graphs keep at fixed addresses. All
    chains share one memory pool and keep every value they carry in the
    buffers, so they replay in any order on the stream that launches
    them."""

    def __init__(self, name: str, carry, row, extra: tuple, split=None):
        self.name, self.split = name, split
        self.carry = _tree.tree_map(_buffer, carry)
        self.row = _tree.tree_map(_buffer, row)
        self.extra = [_buffer(x) for x in extra]
        self.carry_leaves = _tree.tree_leaves(self.carry)
        self.row_leaves = _tree.tree_leaves(self.row)
        self.out = self.out_leaves = None
        # flag -> (its step, which holds what the graphs read; the chain
        # of (graph, the split call it ends at or None))
        self.chains: dict = {}
        self.pool = None

    def load(self, carry, extra: tuple) -> None:
        torch._foreach_copy_(self.carry_leaves + self.extra,
                             _tree.tree_leaves(carry) + list(extra))

    def _body(self, fn: Callable) -> None:
        """One step from the buffers into them: what a chain's replay
        does. The first call sizes the output buffers."""
        carry, out = fn(self.carry, self.row, *self.extra)
        src, out_leaves = _tree.tree_leaves(carry), _tree.tree_leaves(out)
        if self.out is None:
            self.out = _tree.tree_map(_buffer, out)
            self.out_leaves = _tree.tree_leaves(self.out)
        for d, x in zip(self.carry_leaves + self.out_leaves,
                        src + out_leaves):
            if d.shape != x.shape or d.dtype != x.dtype:
                raise RuntimeError(
                    f"{self.name} step graph: a {d.dtype} {tuple(d.shape)} "
                    f"buffer would take a {x.dtype} {tuple(x.shape)} value")
        # Every leaf the step returns is a new tensor or a shared constant,
        # never a view of a buffer, so no copy below reads a buffer another
        # has written.
        torch._foreach_copy_(self.out_leaves, out_leaves)
        torch._foreach_copy_(self.carry_leaves, src)

    def _capture(self, fn: Callable) -> list:
        """The loaded row's step run eagerly on the capture stream, which
        makes the lazy constants, the kernels' builds and that stream's
        library handles and workspaces; then :meth:`_body` captured as a
        chain, each split call given empty outputs shaped like the eager
        call's."""
        dev = self.row_leaves[0].device
        stream = capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        results: list = []

        def recorded(real):
            def call(*args, **kwargs):
                results.append(real(*args, **kwargs))
                return results[-1]
            return call

        chain: list = []
        open_: list = []

        def begin():
            open_.append(torch.cuda.CUDAGraph())
            open_[-1].capture_begin(pool=self.pool,
                                    capture_error_mode="thread_local")

        def end(search):
            open_[-1].capture_end()
            chain.append((open_.pop(), search))

        def stand_in(real):
            def call(*args, **kwargs):
                out = _tree.tree_map(torch.empty_like, results[len(chain)])
                end((args, kwargs, out))
                begin()
                return out
            return call

        with torch.cuda.stream(stream):
            with _swapped(self.split, recorded):
                self._body(fn)
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            with _swapped(self.split, stand_in):
                begin()
                try:
                    self._body(fn)
                finally:
                    if open_:
                        end(None)
        torch.cuda.current_stream(dev).wait_stream(stream)
        return chain

    def step(self, flag, make: Callable, counters: tuple) -> None:
        """The loaded row's step under ``flag``: a flag's first row is run
        and captured, every later one replayed."""
        entry = self.chains.get(flag)
        if entry is None:
            TR.count(counters[0], 1)
            fn = make(flag)
            self.chains[flag] = (fn, self._capture(fn))
            return
        split = getattr(*self.split) if self.split else None
        for graph, search in entry[1]:
            graph.replay()
            if search is not None:
                args, kwargs, out = search
                split(*args, **kwargs, out=out)
        TR.count(counters[1], 1)


def _lookup(name: str, key, make: Callable) -> Graphs:
    """The stage's entry for ``key``, made by ``make()`` when absent; the
    least recently used is dropped past :data:`KEEP`."""
    table = _GRAPHS[name]
    value = table.pop(key, None)
    if value is None:
        value = make()
    table[key] = value
    if len(table) > KEEP:
        table.popitem(last=False)
    return value


def scan(make: Callable, carry, rows, *, extra: tuple = (), flags=None,
         axis: int = 0, graphed: bool = False, key=None, name: str,
         split=None):
    """``make(flag)`` is the step ``(carry, row, *extra) -> (carry, out)``
    under a row's static flag; ``scan`` runs it from ``carry`` over the
    rows of ``rows`` (every leaf's index along ``axis``), ``flags`` giving
    one flag per row (``None``: one flag for all), and returns the last
    carry and the outputs stacked along ``axis``.

    Eagerly unless ``graphed``: then the step runs in the :class:`Graphs`
    of the stage ``name`` and of (``key``, ``axis``, the device, every
    input's shape and dtype). ``carry`` and ``extra`` are copied into its
    buffers once, each row before its step and each step's outputs out
    after it; a flag's first row of the key runs eagerly and captures the
    step (``<name>.graph_captures``), every other row is one replay
    (``<name>.graph_replays``). The carry is cloned out at the end, so
    nothing returned aliases a buffer."""
    leaves = _tree.tree_leaves(rows)
    n = leaves[0].shape[axis]
    flags = [None] * n if flags is None else flags
    if not graphed:
        steps, outs = {}, []
        for e, flag in enumerate(flags):
            if flag not in steps:
                steps[flag] = make(flag)
            row = _tree.tree_map(lambda x: x.select(axis, e), rows)
            carry, out = steps[flag](carry, row, *extra)
            outs.append(out)
        return carry, _tree.tree_map(
            lambda *xs: torch.stack(xs, dim=axis), *outs)

    row_parts = [x.unbind(axis) for x in leaves]
    firsts = iter([r[0] for r in row_parts])
    row0 = _tree.tree_map(lambda _: next(firsts), rows)
    inputs = _tree.tree_leaves((carry, row0, tuple(extra)))
    full_key = (key, axis, inputs[0].device) + tuple(
        (tuple(x.shape), x.dtype) for x in inputs)
    g = _lookup(name, full_key,
                lambda: Graphs(name, carry, row0, tuple(extra), split))
    g.load(carry, extra)
    counters = (f"{name}.graph_captures", f"{name}.graph_replays")
    outs = out_parts = None
    for e, flag in enumerate(flags):
        torch._foreach_copy_(g.row_leaves, [r[e] for r in row_parts])
        g.step(flag, make, counters)
        if outs is None:
            outs = [torch.empty(o.shape[:axis] + (n,) + o.shape[axis:],
                                dtype=o.dtype, device=o.device)
                    for o in g.out_leaves]
            out_parts = [o.unbind(axis) for o in outs]
        torch._foreach_copy_([r[e] for r in out_parts], g.out_leaves)
    it = iter(outs)
    return (_tree.tree_map(torch.clone, g.carry),
            _tree.tree_map(lambda _: next(it), g.out))
