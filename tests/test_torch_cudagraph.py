"""``_cudagraph.scan``, the one loop that replays a stage's step as
captured CUDA graphs, on the CPU with a toy step.

Through the capture seam (``Graphs._capture`` giving back a chain whose
replay runs the captured body eagerly): the replayed loop equals the eager
loop bit for bit over carried rows, two static flags interleave on one
entry's buffers, the least recently used key is dropped past ``KEEP``, and
nothing returned aliases a buffer. Through stand-ins for the CUDA graph
objects that record the ops dispatched between ``capture_begin`` and
``capture_end`` and run them again at replay: the real capture splits the
step at each call of the split function, and a replay launches that
function between the segments, as it stands at replay time, in capture
order, once per search.
"""

import collections
import contextlib
import functools
from types import SimpleNamespace

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vil_sensor_fusion_tpu_torch import _cudagraph as CG
from vil_sensor_fusion_tpu_torch import _tree
from vil_sensor_fusion_tpu_torch.utils import tracing as TR


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setattr(CG, "_GRAPHS",
                        collections.defaultdict(collections.OrderedDict))


Carry = collections.namedtuple("Carry", "x n")


def _toy(flag, carry, row, w):
    """A step with a carried vector and counter, a row and an extra input;
    the flag adds a branch that only its graphs hold."""
    x = torch.tanh(carry.x * w + row)
    if flag:
        x = x * 0.5 + 1.0
    return Carry(x, carry.n + 1), (x.sum(), x * 2.0)


def _make(flag):
    return functools.partial(_toy, flag)


def _inputs(n=6, width=5, seed=0):
    g = torch.Generator().manual_seed(seed)
    carry = Carry(torch.randn(width, generator=g, dtype=torch.float64),
                  torch.zeros((), dtype=torch.int64))
    rows = torch.randn(n, width, generator=g, dtype=torch.float64)
    w = torch.randn(width, generator=g, dtype=torch.float64)
    return carry, rows, (w,)


def _bits_equal(a, b):
    la, lb = _tree.tree_leaves(a), _tree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert (x.dtype, x.shape) == (y.dtype, y.shape)
        assert torch.equal(x.view(torch.int64) if x.is_floating_point()
                           else x, y.view(torch.int64)
                           if y.is_floating_point() else y)


def _bodies(monkeypatch):
    """The seam: a capture runs its row's step and gives back its body,
    run eagerly at every replay."""

    def capture(self, fn):
        self._body(fn)
        return [(SimpleNamespace(replay=functools.partial(self._body, fn)),
                 None)]

    monkeypatch.setattr(CG.Graphs, "_capture", capture)


def _scan(carry, rows, extra, graphed, flags=None, make=_make, **kw):
    with TR.recording() as rec:
        out = CG.scan(make, carry, rows, extra=extra, flags=flags,
                      graphed=graphed, key="toy", name="toy", **kw)
    return out, rec.trace.counts


@pytest.mark.parametrize("flags", [None, [True, False, False, True, True,
                                          False]])
def test_replays_equal_the_eager_loop_over_carried_rows(flags, monkeypatch):
    """Two calls, the second from the carry the first returned; with two
    flags, their rows interleave on the buffers of one entry."""
    _bodies(monkeypatch)
    carry0, rows, extra = _inputs()
    got = {}
    for graphed in (False, True):
        carry, calls = carry0, []
        for a, b in ((0, 4), (4, 6)):
            (carry, out), counts = _scan(carry, rows[a:b], extra, graphed,
                                         flags and flags[a:b])
            calls.append((carry, out, counts))
        got[graphed] = calls
    n_flags = 1 if flags is None else 2
    for k, ((c_e, o_e, n_e), (c_g, o_g, n_g)) in enumerate(
            zip(got[False], got[True])):
        _bits_equal(c_e, c_g)
        _bits_equal(o_e, o_g)
        assert n_e == {}
        steps = o_e[1].shape[0]
        captures = n_flags if k == 0 else 0
        assert n_g.get("toy.graph_captures", 0) == captures
        assert n_g.get("toy.graph_replays", 0) == steps - captures
    [entry] = CG._GRAPHS["toy"].values()
    assert set(entry.chains) == ({None} if flags is None else {True, False})


def test_the_lane_axis_stacks_outputs_behind_the_lanes(monkeypatch):
    _bodies(monkeypatch)
    lanes, rows, extra = (_tree.tree_map(lambda *x: torch.stack(x), *f)
                          for f in zip(_inputs(n=4), _inputs(n=4, seed=1)))

    def make(flag):
        return torch.func.vmap(_make(flag))

    eager, _ = _scan(lanes, rows, extra, False, make=make, axis=1)
    graph, _ = _scan(lanes, rows, extra, True, make=make, axis=1)
    _bits_equal(eager, graph)
    assert graph[1][1].shape == (2, 4, 5)


def test_the_least_recently_used_key_is_dropped_past_keep(monkeypatch):
    _bodies(monkeypatch)
    widths = range(2, 2 + CG.KEEP + 1)
    for width in widths:
        _scan(*_inputs(n=2, width=width), True)
    table = CG._GRAPHS["toy"]
    assert len(table) == CG.KEEP
    assert {e.row.shape[-1] for e in table.values()} == set(widths[1:])
    (_, _), counts = _scan(*_inputs(n=2, width=widths[1]), True)
    assert counts == {"toy.graph_replays": 2}        # kept: replays only
    (_, _), counts = _scan(*_inputs(n=2, width=widths[0]), True)
    assert counts == {"toy.graph_captures": 1, "toy.graph_replays": 1}
    assert widths[2] not in {e.row.shape[-1] for e in table.values()}


def test_nothing_returned_aliases_a_buffer(monkeypatch):
    _bodies(monkeypatch)
    carry, rows, extra = _inputs()
    returned = _scan(carry, rows, extra, True, [True, False] * 3)[0]
    [entry] = CG._GRAPHS["toy"].values()
    held = {x.untyped_storage().data_ptr() for x in _tree.tree_leaves(
        (entry.carry, entry.row, entry.extra, entry.out))}
    assert not held & {x.untyped_storage().data_ptr()
                       for x in _tree.tree_leaves(returned)}


# ---------------------------------------------------------------------------
# The real capture, split at a function, with recording graph stand-ins
# ---------------------------------------------------------------------------

class _Record(TorchDispatchMode):
    """Appends every op dispatched to ``ops``: an op that writes into its
    arguments is held back (a capture runs nothing), any other runs, so
    that the code around it sees tensors of the right shapes."""

    def __init__(self, ops):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func._schema.is_mutable:
            self.ops.append((func, args, kwargs, None))
            return args[0] if func._schema.returns else None
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out


class _Graph:
    """A CUDA graph stand-in: records between ``capture_begin`` and
    ``capture_end``; ``replay`` runs the ops again, each one's result
    copied into the tensor it gave at capture, and logs the replay."""

    log: list = []

    def __init__(self):
        self.ops, self.mode, self.index = [], None, None

    def capture_begin(self, pool=None, capture_error_mode=None):
        self.mode = _Record(self.ops)
        self.mode.__enter__()

    def capture_end(self):
        self.mode.__exit__(None, None, None)

    def replay(self):
        _Graph.log.append(("graph", self.index))
        for func, args, kwargs, out in self.ops:
            res = func(*args, **kwargs)
            if out is not None:
                for o, r in zip(_tree.tree_leaves(out),
                                _tree.tree_leaves(res)):
                    o.copy_(r)


def _search(x, k, *, out=None):
    """The split function: a toy search, logged with its ``k``."""
    _Graph.log.append(("search", k))
    res = (x * k, (x * x).sum(dim=-1, keepdim=True) + k)
    if out is None:
        return res
    for o, r in zip(out, res):
        o.copy_(r)
    return out


def _split_step(flag, carry, row, w):
    ns = _ns()
    a, s = ns.search(torch.tanh(carry.x * w + row), 2.0)
    b, t = ns.search(a - s, 3.0)
    x = torch.sin(b) + t
    return Carry(x, carry.n + 1), (x, s + t)


@functools.cache
def _ns():
    return SimpleNamespace(search=_search)


@pytest.fixture
def recording_graphs(monkeypatch):
    class Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(CG, "capture_stream", lambda dev: Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None:
                        Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(_ns(), "search", _search)
    _Graph.log = []


def test_a_split_chain_launches_the_split_function_between_segments(
        recording_graphs, monkeypatch):
    """Capture splits the step at each search; a replay runs segment,
    search, segment, search, segment, the searches in capture order and
    through the function the namespace holds at replay time; the values
    are the eager loop's, bit for bit."""
    carry, rows, extra = _inputs(n=4)
    split = (_ns(), "search")
    eager, _ = _scan(carry, rows, extra, False, make=lambda f: functools
                     .partial(_split_step, f))
    _Graph.log = []
    (graph, counts) = _scan(carry, rows, extra, True, make=lambda f:
                            functools.partial(_split_step, f), split=split)
    _bits_equal(eager, graph)
    assert counts == {"toy.graph_captures": 1, "toy.graph_replays": 3}
    [entry] = CG._GRAPHS["toy"].values()
    chain = entry.chains[None][1]
    for i, (g, _) in enumerate(chain):
        g.index = i
    assert [s is None for _, s in chain] == [False, False, True]
    # The first row runs eagerly (two searches), then the capture launches
    # nothing; each later row replays the chain.
    assert _Graph.log[:2] == [("search", 2.0), ("search", 3.0)]
    per_row = [("graph", None), ("search", 2.0), ("graph", None),
               ("search", 3.0), ("graph", None)]
    assert _Graph.log[2:] == per_row * 3

    # A wrapper put in place after the capture sees every launch.
    ref, _ = _scan(graph[0], rows, extra, False, make=lambda f: functools
                   .partial(_split_step, f))
    seen = []

    def wrapped(*a, **kw):
        seen.append(kw["out"][0].data_ptr())
        return _search(*a, **kw)

    monkeypatch.setattr(_ns(), "search", wrapped)
    _Graph.log = []
    again, counts = _scan(graph[0], rows, extra, True, make=lambda f:
                          functools.partial(_split_step, f), split=split)
    assert counts == {"toy.graph_replays": 4}
    assert [x for x in _Graph.log if x[0] == "graph"] == [
        ("graph", 0), ("graph", 1), ("graph", 2)] * 4
    assert seen == [s[2][0].data_ptr() for _, s in chain[:2]] * 4
    _bits_equal(ref, again)
