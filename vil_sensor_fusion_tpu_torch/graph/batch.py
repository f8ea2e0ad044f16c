"""Full-batch MAP oracle: an offline f64 Gauss-Newton over an ENTIRE event
timeline, solving every keyframe jointly.

Port of ``vil_sensor_fusion_tpu/graph/batch.py``. The streaming engine is a
fixed-lag smoother: old states are Schur-marginalized into a dense prior
(graph/smoother.py:add_keyframe), whereas the reference's iSAM2 keeps the
full history and relinearizes it (GraphManager.cpp:101-141,
relinearizeThreshold 1e-4 / relinearizeSkip 1). This module computes the
full-history MAP with the *same factor semantics* (initial prior, one
CombinedImu-equivalent factor per event gap, per-source between-factor
chains with the engine's arrival/gap gates), in float64, so the fixed-lag
trajectory can be compared against the estimate an infinite-memory solver
would produce.

Differences from the JAX function, none of them in the numbers beyond the
order of f64 sums:

- It runs on the device of ``pose0`` (or the ``device`` named; numpy
  inputs go to ``DEFAULT_DEVICE``) and casts every input to float64 itself
  where JAX requires ``jax_enable_x64``.
- The factors are linearized by ``graph/factors``' batched forms (one call
  per factor kind for all factors, the port's replacement for ``vmap``).
- The dense (N·15)² normal equations are assembled on the device, without
  a loop over factors: the (K, 15, 15) blocks of all factors come from
  batched products and are scatter-added into H by one
  ``index_put_(..., accumulate=True)``. Only the cost leaves the device
  inside the loop (the stop rule needs it).
- The Jacobi-scaled damped solve uses ``solve_ex``: a singular system gives
  NaN, as ``np.linalg.solve`` would raise and ``jnp`` would give NaN.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..core import lie
from ..core import preintegration as pre
from ..fusion import engine as E
from . import factors as F
from .factors import STATE_DIM


class BatchSolution(NamedTuple):
    poses: torch.Tensor     # (N, 7) all keyframes incl. the initial state
    vels: torch.Tensor      # (N, 3)
    biases: torch.Tensor    # (N, 6)
    times: torch.Tensor     # (N,)
    cost: float             # final total weighted squared error
    n_between: int          # between-factors that passed the engine's gates


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _timeline_structure(cfg: E.FusionConfig, tl: E.Timeline, t0: float):
    """Replay the engine's bookkeeping host-side: per event, the between
    factor's (i_state, j_state, sensor, event) under the arrival/gap/chain
    gates (engine.step's factor_valid). State 0 is the initial state, event
    e creates state e+1."""
    times = _host(tl.times).astype(np.float64)
    source = _host(tl.source)
    keep = _host(tl.keep).astype(np.float64)
    valid = _host(tl.valid).astype(np.float64)
    nS = len(cfg.sensors)
    max_skip = [s.max_time_skip for s in cfg.sensors]
    last_state = np.zeros(nS, np.int64)
    last_time = np.full(nS, t0, np.float64)
    has_last = np.zeros(nS, bool)
    btw = []
    for e in range(len(times)):
        sid = int(source[e])
        arrived = keep[e] * valid[e] > 0
        gap_ok = (times[e] - last_time[sid]) < max_skip[sid]
        if arrived and has_last[sid] and gap_ok:
            btw.append((last_state[sid], e + 1, sid, e))
        if arrived:
            last_state[sid] = e + 1
            last_time[sid] = times[e]
            has_last[sid] = True
    return btw


def _blocks(A_i, A_j, info, r):
    """Normal-equation blocks of K factors with Jacobians A_i, A_j (K, n,
    15), information (K, n, n) and residuals (K, n): the (K, 4, 15, 15)
    blocks (ii, ij, ji, jj) of H and the (K, 2, 15) blocks (i, j) of b."""
    AL_i = A_i.mT @ info
    AL_j = A_j.mT @ info
    H = torch.stack([AL_i @ A_i, AL_i @ A_j, AL_j @ A_i, AL_j @ A_j], dim=1)
    b = torch.stack([AL_i @ r[..., None], AL_j @ r[..., None]], dim=1)
    return H, b[..., 0]


def _block_index(i, j):
    """Indices into the dense system for factors between states i and j
    (K,): rows and columns of their (ii, ij, ji, jj) blocks of H, each
    (K, 4, 15, 15), and the rows of their (i, j) blocks of b, (K, 2, 15)."""
    ar = torch.arange(STATE_DIM, device=i.device)
    ri = (i * STATE_DIM)[:, None] + ar                        # (K, 15)
    rj = (j * STATE_DIM)[:, None] + ar
    rows = torch.stack([ri, ri, rj, rj], dim=1)[..., :, None]
    cols = torch.stack([ri, rj, ri, rj], dim=1)[..., None, :]
    shape = (i.shape[0], 4, STATE_DIM, STATE_DIM)
    return rows.expand(shape), cols.expand(shape), torch.stack([ri, rj], 1)


def solve_batch(
    cfg: E.FusionConfig,
    tl: E.Timeline,
    imu_times,
    imu_accel,
    imu_gyro,
    pose0,
    vel0,
    bias0,
    t0: float,
    iters: int = 20,
    damping: float = 1e-6,
    device=None,
) -> BatchSolution:
    """Joint MAP over all E+1 states (f64, dense), on ``device`` (default:
    the device of ``pose0`` if it is a tensor, else ``DEFAULT_DEVICE``).
    See the module docstring."""
    f64 = torch.float64
    if device is None:
        device = (pose0.device if isinstance(pose0, torch.Tensor)
                  else DEFAULT_DEVICE)
    dev = lambda x: torch.as_tensor(x, dtype=f64, device=device)  # noqa: E731
    times_np = np.concatenate([[t0], _host(tl.times).astype(np.float64)])
    N = len(times_np)
    D = N * STATE_DIM

    imu_times, imu_accel, imu_gyro, pose0, vel0, bias0 = (
        dev(x) for x in (imu_times, imu_accel, imu_gyro, pose0, vel0, bias0))
    imu = cfg.smoother.imu

    # --- factors -----------------------------------------------------------
    # IMU: one per consecutive state pair, preintegrated at the initial
    # bias (bias Jacobians carry the first-order correction, the batch
    # linearization-point convention; the engine instead re-preintegrates
    # at each step's running bias estimate).
    starts, ends = dev(times_np[:-1]), dev(times_np[1:])
    pim = torch.func.vmap(lambda s, e: pre.preintegrate_window(
        imu_times, imu_accel, imu_gyro, s, e, bias0, imu,
        max_samples=cfg.max_imu_per_gap))(starts, ends)
    imu_info = F.info_from_cov(pre.combined_covariance_15(pim, imu),
                               jitter=1e-18)

    btw = _timeline_structure(cfg, tl, t0)
    bi, bj, bsid, bev = (np.array([b[c] for b in btw], np.int64)
                         for c in range(4))
    odo_pose_tl = _host(tl.odo_pose).astype(np.float64)
    odo_cov_tl = _host(tl.odo_cov).astype(np.float64)[bev]
    odo_twist_tl = _host(tl.odo_twist_cov).astype(np.float64)[bev]
    # Covariance selection (engine.step): twist channel for the literal
    # use_odom_covariance mode (SensorManagerRos.cpp:84-99), pose channel
    # for the adaptive use_pose_covariance extension, else fixed diag.
    covs = []
    for k in range(len(btw)):
        sp = cfg.sensors[bsid[k]]
        if sp.use_odom_covariance:
            covs.append(odo_twist_tl[k])
        elif sp.use_pose_covariance:
            covs.append(odo_cov_tl[k])
        else:
            covs.append(np.diag([sp.covariance_linear] * 3
                                + [sp.covariance_angular] * 3))
    if btw:
        btw_info = F.info_from_cov(dev(np.array(covs)), jitter=1e-18)
        # Between measurement from the engine's delta convention: the
        # previous arrival's odometry pose (pose0 for state 0).
        prev_sel = np.where(bi[:, None] == 0, _host(pose0),
                            odo_pose_tl[np.maximum(bi - 1, 0)])
        delta = lie.pose_ref_delta if cfg.ref_pose_delta else lie.pose_between
        meas = delta(dev(prev_sel), dev(odo_pose_tl[bev]))
        bi_t, bj_t = (torch.as_tensor(x, device=device) for x in (bi, bj))

    sm = cfg.smoother
    sig = np.array([sm.prior_trans_sigma] * 3 + [sm.prior_rot_sigma] * 3
                   + [sm.prior_vel_sigma] * 3 + [sm.prior_bias_sigma] * 6)
    prior_info = torch.diag(dev(np.minimum(1.0 / sig ** 2, sm.info_cap)))
    g_vec = dev([0.0, 0.0, -imu.gravity])

    # --- initial states: dead-reckon the IMU chain -------------------------
    poses, vels = [pose0], [vel0]
    for k in range(N - 1):
        p_new, v_new = pre.predict(pre.PreintegratedImu(*(f[k] for f in pim)),
                                   poses[-1], vels[-1], bias0, imu)
        poses.append(p_new)
        vels.append(v_new)
    poses = torch.stack(poses)
    vels = torch.stack(vels)
    biases = bias0.expand(N, 6).clone()

    # --- the system's sparsity pattern, fixed over the iterations ----------
    chain = torch.arange(N - 1, device=device)
    rows, cols, brows = _block_index(chain, chain + 1)
    if btw:
        r2, c2, b2 = _block_index(bi_t, bj_t)
        rows, cols, brows = (torch.cat([rows, r2]), torch.cat([cols, c2]),
                             torch.cat([brows, b2]))
    rows, cols, brows = rows.reshape(-1), cols.reshape(-1), brows.reshape(-1)

    last_cost = np.inf
    for _ in range(iters):
        r_i, Ai, Aj = F.linearize_imu_factor(
            poses[:-1], vels[:-1], biases[:-1],
            poses[1:], vels[1:], biases[1:], pim, g_vec)
        Hb, bb = _blocks(Ai, Aj, imu_info, r_i)
        cost = torch.einsum("kr,krq,kq->", r_i, imu_info, r_i)
        if btw:
            r_b, Bi, Bj = F.linearize_between_factor(poses[bi_t], poses[bj_t],
                                                     meas)
            Hb2, bb2 = _blocks(Bi, Bj, btw_info, r_b)
            Hb, bb = torch.cat([Hb, Hb2]), torch.cat([bb, bb2])
            cost = cost + torch.einsum("kr,krq,kq->", r_b, btw_info, r_b)

        r_p, Ap = F.linearize_prior_factor(poses[0], vels[0], biases[0],
                                           pose0, vel0, bias0)
        cost = float(cost + r_p @ prior_info @ r_p)

        H = torch.zeros((D, D), dtype=f64, device=device)
        H.index_put_((rows, cols), Hb.reshape(-1), accumulate=True)
        H[:STATE_DIM, :STATE_DIM] += Ap.mT @ prior_info @ Ap
        b = torch.zeros(D, dtype=f64, device=device)
        b.index_put_((brows,), bb.reshape(-1), accumulate=True)
        b[:STATE_DIM] += Ap.mT @ prior_info @ r_p

        # Jacobi-scaled damped solve (matches smoother._jacobi_solve).
        s_inv = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-15))
        Hs = H * s_inv[:, None] * s_inv[None, :]
        Hs.diagonal().add_(damping)
        x, info = torch.linalg.solve_ex(Hs, s_inv * b)
        dx = -(s_inv * torch.where(info == 0, x, torch.nan))
        poses, vels, biases = F.retract_state(poses, vels, biases,
                                              dx.reshape(N, STATE_DIM))
        if abs(last_cost - cost) < 1e-12 * max(cost, 1.0):
            break
        last_cost = cost

    return BatchSolution(
        poses=poses, vels=vels, biases=biases, times=dev(times_np),
        cost=0.5 * cost, n_between=len(btw))
