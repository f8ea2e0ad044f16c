"""IMU preintegration — GTSAM's ``PreintegratedCombinedMeasurements``
(IMUManager.cpp:27-74) as a fixed-length loop.

Port of ``vil_sensor_fusion_tpu/core/preintegration.py``: the static-shape
window extraction with an interpolated end sample, the on-manifold ΔR, Δv,
Δp recursion, the 9×9 covariance in (δθ, δp, δv) order, and the first-order
bias Jacobians. ``lax.scan`` becomes a Python loop; masked samples
(dt = 0) leave the state unchanged through the same arithmetic select.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._consts import const
from . import lie


class ImuParams(NamedTuple):
    """Continuous-time IMU noise parameters (fusion_params.yaml:24-29)."""

    cov_accel: float = 1e-6
    cov_gyro: float = 1e-6
    cov_integration: float = 1e-8
    cov_bias_acc: float = 1e-4
    cov_bias_omega: float = 1e-6
    cov_bias_acc_omega_int: float = 1e-4
    gravity: float = 9.81            # +Z-up world; g vector is (0,0,-gravity)


class PreintegratedImu(NamedTuple):
    """Result of preintegrating one IMU window (all in the frame of state i):
    delta_t, delta_R (3,3), delta_v (3,), delta_p (3,), cov (9,9) of
    (δθ, δp, δv), the bias Jacobians, and the linearization bias."""

    delta_t: torch.Tensor
    delta_R: torch.Tensor
    delta_v: torch.Tensor
    delta_p: torch.Tensor
    cov: torch.Tensor
    dR_dbg: torch.Tensor
    dv_dba: torch.Tensor
    dv_dbg: torch.Tensor
    dp_dba: torch.Tensor
    dp_dbg: torch.Tensor
    bias_hat: torch.Tensor


def preintegrate(
    accel: torch.Tensor,
    gyro: torch.Tensor,
    dts: torch.Tensor,
    bias: torch.Tensor,
    params: ImuParams,
    mask: torch.Tensor | None = None,
) -> PreintegratedImu:
    """Preintegrate a fixed-length window: accel/gyro (N,3), dts (N,)
    (masked samples have dt == 0), bias (6,) = (b_a, b_g)."""
    dtype, device = accel.dtype, accel.device
    ba, bg = bias[:3], bias[3:6]
    if mask is not None:
        dts = dts * mask.to(dtype)
    sig_a, sig_g = params.cov_accel, params.cov_gyro
    sig_int = params.cov_integration

    I3 = torch.eye(3, dtype=dtype, device=device)
    Z3 = torch.zeros((3, 3), dtype=dtype, device=device)
    dR = I3
    dv = torch.zeros(3, dtype=dtype, device=device)
    dp = torch.zeros(3, dtype=dtype, device=device)
    cov = torch.zeros((9, 9), dtype=dtype, device=device)
    dR_dbg = dv_dba = dv_dbg = dp_dba = dp_dbg = Z3
    dt_sum = torch.zeros((), dtype=dtype, device=device)
    # The integration noise's 9×9 block pattern, scaled by dt per sample
    # (a product, not a write into a slice, so the loop maps over lanes).
    Q_int_unit = torch.zeros((9, 9), dtype=dtype, device=device)
    Q_int_unit[3:6, 3:6] = I3 * sig_int

    for k in range(accel.shape[0]):
        dt = dts[k]
        live = (dt > 0).to(dtype)
        dt = torch.clamp(dt, min=1e-12)   # avoid 0-div; gated by `live`
        a_c = accel[k] - ba
        w_c = gyro[k] - bg
        theta = w_c * dt
        dRk = lie.so3_exp(theta)
        Jr = lie.so3_right_jacobian(theta)
        R = dR
        Ra = R @ a_c
        a_hat = lie.hat(a_c)

        dv_new = dv + Ra * dt
        dp_new = dp + dv * dt + 0.5 * Ra * dt * dt
        dR_new = R @ dRk

        Rahat = R @ a_hat
        A = torch.cat([
            torch.cat([dRk.T, Z3, Z3], dim=1),
            torch.cat([-0.5 * Rahat * dt * dt, I3, I3 * dt], dim=1),
            torch.cat([-Rahat * dt, Z3, I3], dim=1),
        ], dim=0)
        B = torch.cat([
            torch.cat([Jr * dt, Z3], dim=1),
            torch.cat([Z3, 0.5 * R * dt * dt], dim=1),
            torch.cat([Z3, R * dt], dim=1),
        ], dim=0)
        Q_in = torch.cat([
            torch.cat([I3 * (sig_g / dt), Z3], dim=1),
            torch.cat([Z3, I3 * (sig_a / dt)], dim=1),
        ], dim=0)
        cov_new = A @ cov @ A.T + B @ Q_in @ B.T + Q_int_unit * dt

        dR_dbg_new = dRk.T @ dR_dbg - Jr * dt
        dv_dba_new = dv_dba - R * dt
        dv_dbg_new = dv_dbg - Rahat @ dR_dbg * dt
        dp_dba_new = dp_dba + dv_dba * dt - 0.5 * R * dt * dt
        dp_dbg_new = dp_dbg + dv_dbg * dt - 0.5 * Rahat @ dR_dbg * dt * dt

        def sel(new, old):
            return live * new + (1.0 - live) * old

        dR, dv, dp, cov = (sel(dR_new, dR), sel(dv_new, dv),
                           sel(dp_new, dp), sel(cov_new, cov))
        dR_dbg, dv_dba, dv_dbg = (sel(dR_dbg_new, dR_dbg),
                                  sel(dv_dba_new, dv_dba),
                                  sel(dv_dbg_new, dv_dbg))
        dp_dba, dp_dbg = sel(dp_dba_new, dp_dba), sel(dp_dbg_new, dp_dbg)
        dt_sum = dt_sum + live * dt

    return PreintegratedImu(
        delta_t=dt_sum, delta_R=dR, delta_v=dv, delta_p=dp, cov=cov,
        dR_dbg=dR_dbg, dv_dba=dv_dba, dv_dbg=dv_dbg, dp_dba=dp_dba,
        dp_dbg=dp_dbg, bias_hat=bias,
    )


def gravity_vec(params: ImuParams, dtype, device) -> torch.Tensor:
    """The world gravity vector (0, 0, -g), a shared device constant."""
    return const((0.0, 0.0, -params.gravity), dtype, device)


def predict(
    pim: PreintegratedImu,
    pose_i: torch.Tensor,
    vel_i: torch.Tensor,
    bias: torch.Tensor,
    params: ImuParams,
) -> tuple[torch.Tensor, torch.Tensor]:
    """NavState prediction (GraphManager.cpp:148-152): first-order bias
    correction around ``pim.bias_hat``, then composition with gravity.
    Returns (pose_j, vel_j)."""
    g = gravity_vec(params, pim.delta_v.dtype, pim.delta_v.device)
    db = bias - pim.bias_hat
    dba, dbg = db[:3], db[3:6]

    dR = pim.delta_R @ lie.so3_exp(pim.dR_dbg @ dbg)
    dv = pim.delta_v + pim.dv_dba @ dba + pim.dv_dbg @ dbg
    dp = pim.delta_p + pim.dp_dba @ dba + pim.dp_dbg @ dbg

    Ri = lie.quat_to_rot(lie.pose_quat(pose_i))
    pi = lie.pose_trans(pose_i)
    dt = pim.delta_t

    Rj = Ri @ dR
    vj = vel_i + Ri @ dv + g * dt
    pj = pi + vel_i * dt + Ri @ dp + 0.5 * g * dt * dt
    return lie.pose_make(lie.rot_to_quat(Rj), pj), vj


def extract_window(
    times: torch.Tensor,
    accel: torch.Tensor,
    gyro: torch.Tensor,
    start: torch.Tensor,
    end: torch.Tensor,
    max_samples: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Static-shape IMUManager::getFactor buffer walk (IMUManager.cpp:35-66):
    samples with start < t < end, each integrated over (prev_t, t], plus a
    linearly interpolated final sample at exactly ``end``. Returns
    (accel_w, gyro_w, dts), each with leading dim ``max_samples + 1``. All
    index arithmetic stays on the device."""
    dtype, device = accel.dtype, accel.device
    M = times.shape[0]
    start = torch.as_tensor(start, dtype=times.dtype, device=device)
    end = torch.as_tensor(end, dtype=times.dtype, device=device)
    i0 = torch.searchsorted(times, start.reshape(1), right=True)[0]
    ar = torch.arange(max_samples, device=device)
    idx = i0 + ar
    idx_c = torch.clamp(idx, 0, M - 1)
    t_k = times[idx_c]
    in_window = (idx < M) & (t_k < end)

    a_k = accel[idx_c]
    g_k = gyro[idx_c]

    t_prev = torch.where(ar == 0, start, times[torch.clamp(idx - 1, 0, M - 1)])
    t_prev = torch.where(ar == 0, start, torch.maximum(t_prev, start))
    dts = torch.where(in_window, t_k - t_prev, 0.0).to(dtype)

    n_in = torch.sum(in_window)
    has_in = n_in > 0
    # (1,)-shaped indices, each row taken with [0]: a 0-d index tensor is
    # read on the host, a sync that a CUDA graph cannot capture.
    last_idx = torch.clamp(i0 + n_in - 1, 0, M - 1).reshape(1)
    before = torch.clamp(i0 - 1, 0, M - 1).reshape(1)
    last_t = torch.where(has_in, times[last_idx][0], start)
    last_a = torch.where(has_in, accel[last_idx][0], accel[before][0])
    last_g = torch.where(has_in, gyro[last_idx][0], gyro[before][0])
    nxt = torch.clamp(i0 + n_in, 0, M - 1).reshape(1)
    has_next = (i0 + n_in) < M
    t_next = times[nxt][0]
    denom = torch.clamp(t_next - last_t, min=1e-12)
    alpha = torch.clamp((end - last_t) / denom, 0.0, 1.0)
    a_interp = alpha * accel[nxt][0] + (1.0 - alpha) * last_a
    g_interp = alpha * gyro[nxt][0] + (1.0 - alpha) * last_g
    dt_final = torch.where(has_next, end - last_t, 0.0).to(dtype)

    accel_w = torch.cat([a_k, a_interp[None]], dim=0)
    gyro_w = torch.cat([g_k, g_interp[None]], dim=0)
    dts_all = torch.cat([dts, dt_final[None]], dim=0)
    return accel_w, gyro_w, dts_all


def preintegrate_window(
    times: torch.Tensor,
    accel: torch.Tensor,
    gyro: torch.Tensor,
    start: torch.Tensor,
    end: torch.Tensor,
    bias: torch.Tensor,
    params: ImuParams,
    max_samples: int = 64,
) -> PreintegratedImu:
    """extract_window + preintegrate in one call (the getFactor equivalent)."""
    a, g, dts = extract_window(times, accel, gyro, start, end, max_samples)
    return preintegrate(a, g, dts, bias, params)


def combined_covariance_15(pim: PreintegratedImu,
                           params: ImuParams) -> torch.Tensor:
    """15x15 covariance of (δθ, δp, δv, δb_a, δb_g): the preintegration
    covariance plus bias random walk over the window. Batched over any
    leading axes of ``pim``."""
    dtype, device = pim.cov.dtype, pim.cov.device
    dt = torch.clamp(pim.delta_t, min=1e-12)[..., None, None]
    batch = pim.cov.shape[:-2]
    I3 = torch.eye(3, dtype=dtype, device=device)

    def z(r, c):
        return torch.zeros(batch + (r, c), dtype=dtype, device=device)

    # Assembled by concatenation, not slice writes, so it maps over lanes.
    return torch.cat([
        torch.cat([pim.cov, z(9, 6)], dim=-1),
        torch.cat([z(3, 9), I3 * params.cov_bias_acc * dt, z(3, 3)], dim=-1),
        torch.cat([z(3, 12), I3 * params.cov_bias_omega * dt], dim=-1),
    ], dim=-2)
