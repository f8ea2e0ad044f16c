"""Fusion engine — the reference's ``gtsam_fusion_node`` composition plus
the per-source ``SensorManagerRos`` logic, over a synchronous, time-sorted
measurement timeline.

Port of ``vil_sensor_fusion_tpu/fusion/engine.py``. ``run`` is a Python
loop over timeline events in place of ``lax.scan``.

Host and device: the event's source and its arrival (degeneracy ``keep`` ×
``valid``) are read once, on the host, before the loop — the timeline is
built on the host by :func:`merge_timeline` anyway. So the per-source
bookkeeping and the ``optimize_after_odom`` solve cadence (a ``lax.cond``
in JAX) are host branches on known values and cost no device sync. Every
value computed during the run — the IMU window, the gap check, the health
verdict and its guarded select — stays on the device.

Lanes: :func:`run_lanes` runs B sequences at once — what
``jax.vmap(E.run)`` computes — with one set of ops per event for all
lanes. Its step is the JAX step's device form: the per-source spec is a
set of tables indexed by a per-lane source tensor, the covariance choice,
the arrival and the ``_lastValidOdom`` updates are ``torch.where``
selects, and the solve runs whenever any lane of the event solves, kept
per lane by a select (never by a 0/1 blend: a lane that did not solve
may hold NaN in the discarded branch). ``torch.func.vmap`` maps that
branch-free step over the lane axis.

CUDA graphs: on a card, ``run`` and ``run_lanes`` capture that branch-free
step once per solve flag (without ``vmap`` for ``run``: one lane computes
what :func:`step` does) and replay it per event, so an event costs a few
host ops instead of thousands; the values are the eager step's, bit for
bit. CPU calls and calls under a functorch transform take the eager step.
"""

from __future__ import annotations

import collections
import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .. import _cudagraph as CG
from .. import _precision, _tree
from .._consts import const
from .._cudagraph import graph_device as _graph_device
from ..core import lie
from ..core import preintegration as pre
from ..graph import smoother as S
from ..graph.smoother import SmootherConfig, SmootherState
from ..utils import health as HL
from ..utils import tracing as TR


class SensorSpec(NamedTuple):
    """Static per-source config (config/carla/fusion_params.yaml:1-20)."""

    name: str = "odom"
    use_odom_covariance: bool = False   # twist covariance as between noise
    use_pose_covariance: bool = False   # pose covariance as between noise
    covariance_linear: float = 0.1      # used iff neither flag above
    covariance_angular: float = 0.1
    optimize_after_odom: bool = True
    max_time_skip: float = 0.1
    absolute_anchor: bool = False       # unary map-anchored pose factor
    anchor_cov_scale: float = 25.0


class FusionConfig(NamedTuple):
    smoother: SmootherConfig = SmootherConfig()
    sensors: tuple = (SensorSpec(),)
    max_imu_per_gap: int = 32           # static preintegration window length
    ref_pose_delta: bool = True         # the reference's poseDiff quirk
    guard_health: bool = True           # reject diverging events
    health_limits: HL.HealthLimits = HL.HealthLimits()


class Timeline(NamedTuple):
    """Merged, time-sorted measurement timeline (all arrays length E)."""

    times: torch.Tensor       # (E,)
    source: torch.Tensor      # (E,) int32 index into cfg.sensors
    odo_pose: torch.Tensor    # (E, 7) world-frame odometry pose
    odo_cov: torch.Tensor     # (E, 6, 6) relative-pose covariance
    keep: torch.Tensor        # (E,) degeneracy gate: 1 = arrived
    valid: torch.Tensor       # (E,) padding mask
    odo_twist_cov: torch.Tensor  # (E, 6, 6)


class EngineState(NamedTuple):
    smoother: SmootherState
    last_time: torch.Tensor   # (S,)
    last_key: torch.Tensor    # (S,) int32 global key index
    last_pose: torch.Tensor   # (S, 7)
    has_last: torch.Tensor    # (S,) 0/1


class FusedOutput(NamedTuple):
    """Per-event fused state."""

    times: torch.Tensor       # (E,)
    poses: torch.Tensor       # (E, 7)
    vels: torch.Tensor        # (E, 3)
    biases: torch.Tensor      # (E, 6)
    solved: torch.Tensor      # (E,) 1 if a solve ran at this event
    healthy: torch.Tensor     # (E,) 0 = event rejected by the health guard


def merge_timeline(sources: Sequence[tuple]) -> Timeline:
    """Host-side timeline construction (numpy, as in the JAX package).

    ``sources``: per sensor ``(times (M,), poses (M,7), covs (M,6,6),
    keep (M,))`` with an optional fifth ``twist_covs (M,6,6)`` (the pose
    covariance is reused when omitted). Returns a time-sorted Timeline of
    numpy arrays; ``convert.to_torch`` puts it on a device."""
    ts, sid, ps, cs, ks, tw = [], [], [], [], [], []
    for i, src in enumerate(sources):
        t, p, c, k = src[:4]
        t = np.asarray(t)
        ts.append(t)
        sid.append(np.full(t.shape, i, np.int32))
        ps.append(np.asarray(p))
        cs.append(np.asarray(c))
        ks.append(np.asarray(k))
        tw.append(np.asarray(src[4]) if len(src) > 4 else np.asarray(c))
    t = np.concatenate(ts)
    order = np.argsort(t, kind="stable")
    return Timeline(
        times=t[order],
        source=np.concatenate(sid)[order],
        odo_pose=np.concatenate(ps)[order],
        odo_cov=np.concatenate(cs)[order],
        keep=np.concatenate(ks)[order],
        valid=np.ones_like(t[order]),
        odo_twist_cov=np.concatenate(tw)[order],
    )


def init(cfg: FusionConfig, pose0, vel0, bias0, t0) -> EngineState:
    dtype, device = pose0.dtype, pose0.device
    nS = len(cfg.sensors)
    return EngineState(
        smoother=S.init(cfg.smoother, pose0, vel0, bias0, t0),
        last_time=torch.as_tensor(t0, dtype=dtype, device=device).expand(nS).clone(),
        last_key=torch.zeros((nS,), dtype=torch.int32, device=device),
        last_pose=lie.pose_identity(dtype, device).expand(nS, 7).clone(),
        has_last=torch.zeros((nS,), dtype=dtype, device=device),
    )


def _set(a: torch.Tensor, i: int, value) -> torch.Tensor:
    out = a.clone()
    out[i] = value
    return out


def step(cfg: FusionConfig, es: EngineState, ev, imu_times, imu_accel,
         imu_gyro) -> tuple[EngineState, tuple]:
    """Process one timeline event: reserve a keyframe, maybe add a
    between-factor, maybe solve. ``ev`` is one Timeline row; its ``source``,
    ``keep`` and ``valid`` may be host scalars (``run`` passes them so)."""
    dtype, device = es.smoother.states.poses.dtype, es.smoother.states.poses.device
    es_in = es
    W = cfg.smoother.window
    sid = int(ev.source)
    spec = cfg.sensors[sid]
    arrived = float(ev.keep) * float(ev.valid)
    s = es.smoother

    # --- reserveNode: new keyframe with IMU preintegration over the gap ----
    with TR.span("engine.preintegrate"):
        _, _, bias, t_prev = S.latest(s)
        pim = pre.preintegrate_window(
            imu_times, imu_accel, imu_gyro, t_prev, ev.times, bias,
            cfg.smoother.imu, max_samples=cfg.max_imu_per_gap)
    with TR.span("engine.factors"):
        s = S.add_keyframe(cfg.smoother, s, ev.times, pim)
        new_key = s.key0 + (W - 1)

        # --- odometryCallback: relative pose, covariance, gap check --------
        prev_pose = es.last_pose[sid]
        if cfg.ref_pose_delta:
            delta = lie.pose_ref_delta(prev_pose, ev.odo_pose)
        else:
            delta = lie.pose_between(prev_pose, ev.odo_pose)
        if spec.use_odom_covariance:
            cov = ev.odo_twist_cov
        elif spec.use_pose_covariance:
            cov = ev.odo_cov
        else:
            cov = _diag_cov(spec, dtype, device)

        gap_ok = (ev.times - es.last_time[sid]) < spec.max_time_skip
        factor_valid = arrived * es.has_last[sid] * gap_ok.to(dtype)
        i_window = (es.last_key[sid] - s.key0).to(torch.int32)
        j_window = torch.full((), W - 1, dtype=torch.int32, device=device)
        s = S.add_between(cfg.smoother, s, i_window, j_window, delta, cov,
                          factor_valid)

        # --- absolute map anchor (optional per source) ---------------------
        anchor_valid = torch.full((), arrived * float(spec.absolute_anchor),
                                  dtype=dtype, device=device)
        s = S.add_unary(cfg.smoother, s, j_window, ev.odo_pose,
                        ev.odo_cov * spec.anchor_cov_scale, anchor_valid)

    # --- optimize_after_odom: a host branch on host-known values -----------
    do_solve = spec.optimize_after_odom and arrived > 0.5
    if do_solve:
        s = S.solve(cfg.smoother, s)

    # --- _lastValidOdom update (on every arrived message) -------------------
    if arrived > 0.5:
        es = EngineState(
            smoother=s,
            last_time=_set(es.last_time, sid, ev.times),
            last_key=_set(es.last_key, sid, new_key),
            last_pose=_set(es.last_pose, sid, ev.odo_pose),
            has_last=_set(es.has_last, sid, 1.0),
        )
    else:
        es = es._replace(smoother=s)
    with TR.span("engine.guard"):
        pose, vel, b, t = S.latest(s)
        healthy = HL.check_state(vel, b, limits=cfg.health_limits,
                                 extra_tree=pose)
        if cfg.guard_health:
            # Elastic recovery with bounded coasting: on rejection keep the
            # pre-event state, with its time anchor dragged forward so that
            # the next gap still fits the static preintegration window.
            n_imu = imu_times.shape[0]
            imu_dt = (imu_times[-1] - imu_times[0]) / max(n_imu - 1, 1)
            t_floor = ev.times - 0.8 * cfg.max_imu_per_gap * imu_dt
            t_keep = torch.maximum(es_in.smoother.times[-1], t_floor)
            sm_keep = es_in.smoother._replace(
                times=_set(es_in.smoother.times, -1, t_keep))
            es = HL.guarded_update(es_in._replace(smoother=sm_keep), es,
                                   healthy)
            pose, vel, b, t = S.latest(es.smoother)
    solved = torch.full((), float(do_solve), dtype=dtype, device=device)
    return es, (t, pose, vel, b, solved, healthy.to(dtype))


def _solves(cfg: FusionConfig, source: np.ndarray,
            arrived: np.ndarray) -> np.ndarray:
    """Whether each event solves: its source optimises after it and it
    arrived (the ``optimize_after_odom`` cadence, on host values)."""
    solve_after = np.array([s.optimize_after_odom for s in cfg.sensors])
    return solve_after[source] & (arrived > 0.5)


def run(cfg: FusionConfig, es: EngineState, timeline: Timeline, imu_times,
        imu_accel, imu_gyro) -> tuple[EngineState, FusedOutput]:
    """Process the whole timeline. Reads the timeline's source/keep/valid to
    the host once, then loops over events without further syncs. On a card
    each event replays a captured CUDA graph of the step (see
    :func:`_graph_device` for when)."""
    _precision.require_full_f32()
    imu = (imu_times, imu_accel, imu_gyro)
    with TR.span("engine.run"):
        source = np.asarray(timeline.source.cpu())
        keep = np.asarray(timeline.keep.cpu(), dtype=np.float64)
        valid = np.asarray(timeline.valid.cpu(), dtype=np.float64)
        if _graph_device(es, timeline, imu) is not None:
            return _run_graphs(cfg, es, timeline, imu,
                               _solves(cfg, source, keep * valid), lanes=False)
        outs = []
        for e in range(source.shape[0]):
            TR.count("engine.steps", 1)
            ev = Timeline(times=timeline.times[e], source=int(source[e]),
                          odo_pose=timeline.odo_pose[e],
                          odo_cov=timeline.odo_cov[e], keep=keep[e],
                          valid=valid[e],
                          odo_twist_cov=timeline.odo_twist_cov[e])
            es, out = step(cfg, es, ev, *imu)
            outs.append(out)
        t, p, v, b, sv, hh = (torch.stack(f, dim=0) for f in zip(*outs))
    return es, FusedOutput(times=t, poses=p, vels=v, biases=b, solved=sv,
                           healthy=hh)


# ---------------------------------------------------------------------------
# Lanes: B sequences, one set of ops per event
# ---------------------------------------------------------------------------

class _SourceTables(NamedTuple):
    """The per-source static specs as tensors indexed by source id (the
    JAX package's ``_spec_arrays``)."""

    use_odom_cov: torch.Tensor   # (S,) bool
    use_pose_cov: torch.Tensor   # (S,) bool
    diag_cov: torch.Tensor       # (S, 6, 6) constant between-factor noise
    solve_after: torch.Tensor    # (S,)
    max_skip: torch.Tensor       # (S,)
    anchor: torch.Tensor         # (S,)
    anchor_scale: torch.Tensor   # (S,)


def _diag_cov(spec: SensorSpec, dtype, device) -> torch.Tensor:
    """A source's constant between-factor noise (6, 6)."""
    return torch.diag(const((spec.covariance_linear,) * 3
                            + (spec.covariance_angular,) * 3, dtype, device))


def _source_tables(cfg: FusionConfig, dtype, device) -> _SourceTables:
    sp = cfg.sensors

    def col(values, dt=dtype):
        return torch.tensor(values, dtype=dt, device=device)

    return _SourceTables(
        use_odom_cov=col([s.use_odom_covariance for s in sp], torch.bool),
        use_pose_cov=col([s.use_pose_covariance for s in sp], torch.bool),
        diag_cov=torch.stack([_diag_cov(s, dtype, device) for s in sp]),
        solve_after=col([float(s.optimize_after_odom) for s in sp]),
        max_skip=col([s.max_time_skip for s in sp]),
        anchor=col([float(s.absolute_anchor) for s in sp]),
        anchor_scale=col([s.anchor_cov_scale for s in sp]),
    )


def _lane_step(cfg: FusionConfig, tables: _SourceTables, solve_any: bool,
               es: EngineState, ev: Timeline, imu_times, imu_accel,
               imu_gyro) -> tuple[EngineState, tuple]:
    """One event of one lane with no host branch on the lane's values (the
    JAX step's device form), for ``torch.func.vmap`` over lanes and for a
    CUDA graph. ``solve_any`` says whether any lane solves at this event.
    With one lane it computes what :func:`step` does."""
    poses = es.smoother.states.poses
    dtype, device = poses.dtype, poses.device
    es_in = es
    W = cfg.smoother.window
    # A (1,)-shaped index, each row taken with [0]: a 0-d index tensor is
    # read on the host, a sync that a CUDA graph cannot capture.
    sid = ev.source.long().reshape(1)
    arrived = ev.keep.to(dtype) * ev.valid.to(dtype)
    s = es.smoother

    with TR.span("engine.preintegrate"):
        _, _, bias, t_prev = S.latest(s)
        pim = pre.preintegrate_window(
            imu_times, imu_accel, imu_gyro, t_prev, ev.times, bias,
            cfg.smoother.imu, max_samples=cfg.max_imu_per_gap)
    with TR.span("engine.factors"):
        s = S.add_keyframe(cfg.smoother, s, ev.times, pim)
        new_key = s.key0 + (W - 1)

        prev_pose = es.last_pose[sid][0]
        if cfg.ref_pose_delta:
            delta = lie.pose_ref_delta(prev_pose, ev.odo_pose)
        else:
            delta = lie.pose_between(prev_pose, ev.odo_pose)
        cov = torch.where(tables.use_odom_cov[sid][0], ev.odo_twist_cov,
                          torch.where(tables.use_pose_cov[sid][0], ev.odo_cov,
                                      tables.diag_cov[sid][0]))

        gap_ok = (ev.times - es.last_time[sid][0]) < tables.max_skip[sid][0]
        factor_valid = arrived * es.has_last[sid][0] * gap_ok.to(dtype)
        i_window = (es.last_key[sid][0] - s.key0).to(torch.int32)
        j_window = torch.full((), W - 1, dtype=torch.int32, device=device)
        s = S.add_between(cfg.smoother, s, i_window, j_window, delta, cov,
                          factor_valid)
        s = S.add_unary(cfg.smoother, s, j_window, ev.odo_pose,
                        ev.odo_cov * tables.anchor_scale[sid][0],
                        arrived * tables.anchor[sid][0])

    do_solve = (tables.solve_after[sid][0] * arrived) > 0.5
    if solve_any:
        s = _tree.tree_map(lambda a, b: torch.where(do_solve, a, b),
                           S.solve(cfg.smoother, s), s)

    hit = (torch.arange(len(cfg.sensors), device=device) == sid) & (
        arrived > 0.5)
    es = EngineState(
        smoother=s,
        last_time=torch.where(hit, ev.times, es.last_time),
        last_key=torch.where(hit, new_key, es.last_key),
        last_pose=torch.where(hit[:, None], ev.odo_pose, es.last_pose),
        has_last=torch.where(hit, 1.0, es.has_last),
    )
    with TR.span("engine.guard"):
        pose, vel, b, t = S.latest(s)
        healthy = HL.check_state(vel, b, limits=cfg.health_limits,
                                 extra_tree=pose)
        if cfg.guard_health:
            n_imu = imu_times.shape[0]
            imu_dt = (imu_times[-1] - imu_times[0]) / max(n_imu - 1, 1)
            t_floor = ev.times - 0.8 * cfg.max_imu_per_gap * imu_dt
            t_keep = torch.maximum(es_in.smoother.times[-1], t_floor)
            sm_keep = es_in.smoother._replace(times=torch.cat(
                [es_in.smoother.times[:-1], t_keep[None]]))
            es = HL.guarded_update(es_in._replace(smoother=sm_keep), es,
                                   healthy)
            pose, vel, b, t = S.latest(es.smoother)
    return es, (t, pose, vel, b, do_solve.to(dtype), healthy.to(dtype))


def run_lanes(cfg: FusionConfig, es: EngineState, timeline: Timeline,
              imu_times, imu_accel, imu_gyro) -> tuple[EngineState,
                                                      FusedOutput]:
    """B sequences at once: every leaf of ``es``, ``timeline`` and the IMU
    streams has a leading lane axis of size B, and the outputs do too —
    what ``jax.vmap(lambda s, tl, t, a, g: run(cfg, s, tl, t, a, g))``
    computes. Lanes may differ in every value, the sources included, but
    share the event count E. Each event issues one set of ops for all
    lanes (on a card, one replay of a captured CUDA graph); its solve runs
    when any lane solves there (read from the timeline on the host once,
    as :func:`run` does)."""
    _precision.require_full_f32()
    imu = (imu_times, imu_accel, imu_gyro)
    with TR.span("engine.run"):
        poses = es.smoother.states.poses
        source = np.asarray(timeline.source.cpu())
        arrived = (np.asarray(timeline.keep.cpu(), dtype=np.float64)
                   * np.asarray(timeline.valid.cpu(), dtype=np.float64))
        solve_any = _solves(cfg, source, arrived).any(axis=0)
        if _graph_device(es, timeline, imu) is not None:
            return _run_graphs(cfg, es, timeline, imu, solve_any, lanes=True)
        tables = _source_tables(cfg, poses.dtype, poses.device)
        steps = {flag: torch.func.vmap(functools.partial(_lane_step, cfg,
                                                         tables, flag))
                 for flag in (False, True)}
        outs = []
        for e in range(source.shape[1]):
            TR.count("engine.steps", 1)
            ev = Timeline(*(x[:, e] for x in timeline))
            es, out = steps[bool(solve_any[e])](es, ev, *imu)
            outs.append(out)
        t, p, v, b, sv, hh = (torch.stack(f, dim=1) for f in zip(*outs))
    return es, FusedOutput(times=t, poses=p, vels=v, biases=b, solved=sv,
                           healthy=hh)


# ---------------------------------------------------------------------------
# CUDA graphs: each event step captured once per key, then replayed
# ---------------------------------------------------------------------------

class _StepGraphs:
    """The captured event steps of one key (:func:`_step_graphs`): static
    buffers for the state, the event row, the IMU streams and the six
    per-event outputs, and one CUDA graph per solve flag of
    :func:`_lane_step` (``vmap``-ped over lanes with ``lanes``) from the
    buffers back into them. The graphs share one memory pool and keep
    every value they carry in the buffers, so they replay in any order on
    the stream that launches them."""

    def __init__(self, cfg: FusionConfig, es: EngineState, row: Timeline,
                 imu: tuple, lanes: bool):
        def buffer(x):
            return torch.empty(x.shape, dtype=x.dtype, device=x.device)

        self.cfg, self.lanes = cfg, lanes
        self.es = _tree.tree_map(buffer, es)
        self.row = [buffer(x) for x in row]
        self.imu = [buffer(x) for x in imu]
        poses = self.es.smoother.states.poses
        lead = poses.shape[:-2]                 # (B,) with lanes, else ()

        def out(*shape, dtype=poses.dtype):
            return torch.empty(lead + shape, dtype=dtype, device=poses.device)

        # (t, pose, vel, bias, solved, healthy)
        self.out = [out(dtype=self.es.smoother.times.dtype), out(7), out(3),
                    out(6), out(), out()]
        self.tables = _source_tables(cfg, poses.dtype, poses.device)
        self.graphs: dict = {}
        self.pool = None

    def load(self, es: EngineState, imu: tuple) -> None:
        torch._foreach_copy_(_tree.tree_leaves(self.es) + self.imu,
                             _tree.tree_leaves(es) + list(imu))

    def state(self) -> EngineState:
        return _tree.tree_map(torch.clone, self.es)

    def _advance(self, solve: bool):
        fn = functools.partial(_lane_step, self.cfg, self.tables, solve)
        if self.lanes:
            fn = torch.func.vmap(fn)
        return fn(self.es, Timeline(*self.row), *self.imu)

    def _body(self, solve: bool) -> None:
        """One event step from the buffers into them: what a replay does."""
        es, out = self._advance(solve)
        dst, src = _tree.tree_leaves(self.es), _tree.tree_leaves(es)
        for d, x in zip(dst + self.out, src + list(out)):
            if d.shape != x.shape or d.dtype != x.dtype:
                raise RuntimeError(
                    f"engine step graph: a {d.dtype} {tuple(d.shape)} "
                    f"buffer would take a {x.dtype} {tuple(x.shape)} value")
        # Every leaf the step returns is a new tensor (its last ops are
        # selects), so no copy below reads a buffer another has written.
        torch._foreach_copy_(self.out, list(out))
        torch._foreach_copy_(dst, src)

    def _capture(self, solve: bool) -> torch.cuda.CUDAGraph:
        """Capture :meth:`_body` after one eager step on the capture
        stream, which makes the lazy constants and that stream's cuBLAS and
        cuSOLVER handles and workspaces."""
        dev = self.out[0].device
        stream = CG.capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self._advance(solve)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=stream,
                              capture_error_mode="thread_local"):
            self._body(solve)
        torch.cuda.current_stream(dev).wait_stream(stream)
        return graph

    def step(self, solve: bool) -> None:
        graph = self.graphs.get(solve)
        if graph is None:
            TR.count("engine.graph_captures", 1)
            graph = self.graphs[solve] = self._capture(solve)
        graph.replay()
        TR.count("engine.graph_replays", 1)


# Keys kept captured in one process: the experiment grid and the window
# sweep run several configurations.
_GRAPHS: collections.OrderedDict = collections.OrderedDict()
_GRAPH_KEYS = 8


def _step_graphs(cfg: FusionConfig, es: EngineState, row: Timeline,
                 imu: tuple, lanes: bool) -> _StepGraphs:
    """The :class:`_StepGraphs` of (config, lanes, device, every input's
    shape and dtype), least recently used dropped past ``_GRAPH_KEYS``."""
    leaves = _tree.tree_leaves((es, row, imu))
    key = (cfg, lanes, leaves[0].device) + CG.shape_key(leaves)
    return CG.lookup(_GRAPHS, key,
                     lambda: _StepGraphs(cfg, es, row, imu, lanes),
                     _GRAPH_KEYS)


def _run_graphs(cfg: FusionConfig, es: EngineState, timeline: Timeline,
                imu: tuple, solves: np.ndarray,
                lanes: bool) -> tuple[EngineState, FusedOutput]:
    """:func:`run` (with ``lanes``, :func:`run_lanes`) by replays: the state
    and the IMU streams are copied into the key's buffers once, each
    event's row before its replay, and each replay's outputs into the
    call's own tensors; the state is cloned out at the end, so nothing
    returned aliases a buffer."""
    axis = 1 if lanes else 0
    rows = [x.unbind(axis) for x in timeline]
    graphs = _step_graphs(cfg, es, Timeline(*(r[0] for r in rows)), imu,
                          lanes)
    graphs.load(es, imu)
    outs = [torch.empty(o.shape[:axis] + (len(solves),) + o.shape[axis:],
                        dtype=o.dtype, device=o.device) for o in graphs.out]
    out_rows = [o.unbind(axis) for o in outs]
    for e, solve in enumerate(solves):
        TR.count("engine.steps", 1)
        torch._foreach_copy_(graphs.row, [r[e] for r in rows])
        graphs.step(bool(solve))
        torch._foreach_copy_([r[e] for r in out_rows], graphs.out)
    return graphs.state(), FusedOutput(*outs)
