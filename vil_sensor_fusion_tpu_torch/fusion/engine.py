"""Fusion engine — the reference's ``gtsam_fusion_node`` composition plus
the per-source ``SensorManagerRos`` logic, over a synchronous, time-sorted
measurement timeline.

Port of ``vil_sensor_fusion_tpu/fusion/engine.py``. ``run`` is a Python
loop over timeline events in place of ``lax.scan``.

Host and device: the event's source and its arrival (degeneracy ``keep`` ×
``valid``) are read once, on the host, before the loop — the timeline is
built on the host by :func:`merge_timeline` anyway. So the
``optimize_after_odom`` solve cadence (a ``lax.cond`` in JAX) is a static
flag of the step, known on the host, and costs no device sync. Every value
computed during the run — the IMU window, the per-source bookkeeping, the
gap check, the health verdict and its guarded select — stays on the
device.

One step: :func:`_lane_step` is the JAX step's device form, for one lane
or, under ``torch.func.vmap``, for B (:func:`run_lanes`, what
``jax.vmap(E.run)`` computes, with one set of ops per event for all
lanes). The per-source spec is a set of tables indexed by a per-lane
source tensor, the covariance choice, the arrival and the
``_lastValidOdom`` updates are ``torch.where`` selects, and the solve runs
whenever any lane of the event solves, kept per lane by a select (never by
a 0/1 blend: a lane that did not solve may hold NaN in the discarded
branch). :func:`step` is its one-lane call with the solve read on the host.

CUDA graphs: on a card, ``run`` and ``run_lanes`` capture that step once
per solve flag and replay it per event (``_cudagraph.scan``), so an event
costs a few host ops instead of thousands; the values are the eager
step's, bit for bit. CPU calls and calls under a functorch transform take
the eager step.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .. import _cudagraph as CG
from .. import _precision, _tree
from .._consts import const
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


def step(cfg: FusionConfig, es: EngineState, ev, imu_times, imu_accel,
         imu_gyro) -> tuple[EngineState, tuple]:
    """Process one timeline event: reserve a keyframe, maybe add a
    between-factor, maybe solve. ``ev`` is one Timeline row; its ``source``,
    ``keep`` and ``valid`` may be host scalars or tensors, read on the host
    to decide the solve. :func:`_lane_step` of one lane."""
    poses = es.smoother.states.poses
    dtype, device = poses.dtype, poses.device
    solve = (cfg.sensors[int(ev.source)].optimize_after_odom
             and float(ev.keep) * float(ev.valid) > 0.5)
    ev = ev._replace(source=torch.as_tensor(ev.source, device=device),
                     keep=torch.as_tensor(ev.keep, dtype=dtype, device=device),
                     valid=torch.as_tensor(ev.valid, dtype=dtype,
                                           device=device))
    return _lane_step(cfg, _source_tables(cfg, dtype, device), solve, es, ev,
                      imu_times, imu_accel, imu_gyro)


def _solves(cfg: FusionConfig, source: np.ndarray,
            arrived: np.ndarray) -> np.ndarray:
    """Whether each event solves: its source optimises after it and it
    arrived (the ``optimize_after_odom`` cadence, on host values)."""
    solve_after = np.array([s.optimize_after_odom for s in cfg.sensors])
    return solve_after[source] & (arrived > 0.5)


def run(cfg: FusionConfig, es: EngineState, timeline: Timeline, imu_times,
        imu_accel, imu_gyro) -> tuple[EngineState, FusedOutput]:
    """Process the whole timeline. Reads the timeline's source/keep/valid to
    the host once, then loops over events: on a card by replays of a
    captured CUDA graph of the step, with no further sync
    (``_cudagraph.graph_device`` says when), else eagerly through
    :func:`step`."""
    return _run(cfg, es, timeline, (imu_times, imu_accel, imu_gyro), axis=0)


# ---------------------------------------------------------------------------
# The device step: one lane, or B sequences with one set of ops per event
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
        return const(tuple(values), dt, device)

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
    :func:`step` is its one-lane call."""
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
    return _run(cfg, es, timeline, (imu_times, imu_accel, imu_gyro), axis=1)


def _run(cfg: FusionConfig, es: EngineState, timeline: Timeline, imu: tuple,
         axis: int) -> tuple[EngineState, FusedOutput]:
    """:func:`run` (``axis`` 0) and :func:`run_lanes` (``axis`` 1, the
    events' axis behind the lanes'): one ``_cudagraph.scan`` of the event
    step, flagged by whether any lane solves."""
    _precision.require_full_f32()
    with TR.span("engine.run"):
        arrived = (np.asarray(timeline.keep.cpu(), dtype=np.float64)
                   * np.asarray(timeline.valid.cpu(), dtype=np.float64))
        solves = _solves(cfg, np.asarray(timeline.source.cpu()), arrived)
        if axis:
            solves = solves.any(axis=0)
        TR.count("engine.steps", len(solves))
        graphed = CG.graph_device(es, timeline, imu) is not None
        poses = es.smoother.states.poses

        def make(solve):
            if not (axis or graphed):
                return functools.partial(step, cfg)
            fn = functools.partial(_lane_step, cfg, _source_tables(
                cfg, poses.dtype, poses.device), solve)
            return torch.func.vmap(fn) if axis else fn

        es, out = CG.scan(make, es, timeline, extra=imu,
                          flags=solves.tolist(), axis=axis, graphed=graphed,
                          key=cfg, name="engine")
    return es, FusedOutput(*out)
