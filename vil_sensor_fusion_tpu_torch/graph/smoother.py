"""Fixed-lag factor-graph smoother (the reference's GTSAM iSAM2 back-end,
GraphManager.cpp) over a fixed window of W keyframes.

Port of ``vil_sensor_fusion_tpu/graph/smoother.py``: on-manifold
Gauss-Newton with a dense marginal prior, first-estimates (FEJ) Schur
eviction of the oldest keyframe in ``add_keyframe``, ring pools of between
factors and unary anchors, and Jacobi-scaled Cholesky solves. Every
function returns a new state; ring-pool writes are one-hot selects, so the
pointer never leaves the device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core import lie
from ..core import preintegration as pre
from . import factors as F

STATE_DIM = F.STATE_DIM


class SmootherConfig(NamedTuple):
    window: int = 8
    between_slots: int = 16
    unary_slots: int = 8
    gn_iters: int = 8
    damping: float = 1e-9            # Levenberg damping on the scaled system
    info_cap: float = 1e6            # per-factor information ceiling
    prior_rot_sigma: float = 1e-6
    prior_trans_sigma: float = 5e-5
    prior_vel_sigma: float = 1e-5
    prior_bias_sigma: float = 1e-7
    imu: pre.ImuParams = pre.ImuParams()


class SmootherState(NamedTuple):
    states: F.KeyframeStates          # current estimates, (W, ·)
    times: torch.Tensor               # (W,) keyframe times
    key0: torch.Tensor                # global key index of window slot 0
    prior_H: torch.Tensor             # (D, D) dense marginal prior
    prior_g: torch.Tensor             # (D,)
    prior_lin: F.KeyframeStates       # its frozen linearization point
    imu: pre.PreintegratedImu         # stacked, leading dim W-1
    imu_valid: torch.Tensor           # (W-1,)
    btw_i: torch.Tensor               # (B,) int32, window-relative older key
    btw_j: torch.Tensor               # (B,) int32, window-relative newer key
    btw_meas: torch.Tensor            # (B, 7)
    btw_info: torch.Tensor            # (B, 6, 6)
    btw_valid: torch.Tensor           # (B,)
    btw_next: torch.Tensor            # scalar int32 ring pointer
    una_slot: torch.Tensor            # (U,) int32 window-relative key
    una_meas: torch.Tensor            # (U, 7)
    una_info: torch.Tensor            # (U, 6, 6)
    una_valid: torch.Tensor           # (U,)
    una_next: torch.Tensor            # scalar int32 ring pointer


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------

def _cap_info(info: torch.Tensor, cap: float) -> torch.Tensor:
    """Scale an information matrix down so its max diagonal ≤ cap."""
    d = torch.amax(torch.diagonal(info, dim1=-2, dim2=-1), dim=-1)
    s = torch.clamp(cap / torch.clamp(d, min=1e-30), max=1.0)
    return info * s[..., None, None]


def _cholesky_or_nan(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN-filled where A is not positive definite.
    ``torch.linalg.cholesky`` would raise there; ``jnp.linalg.cholesky``
    returns NaN, which the engine's health guard then rejects."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def _chol_solve(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """(L Lᵀ)⁻¹ rhs for a lower factor L and a (n, m) right-hand side."""
    y = torch.linalg.solve_triangular(L, rhs, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def _jacobi_solve(H: torch.Tensor, b: torch.Tensor, lam) -> torch.Tensor:
    """Solve H x = b with symmetric diagonal (Jacobi) scaling, then
    Cholesky: the factor information spans ~8 orders of magnitude. The
    damping ``lam`` (1e-9 by default) is kept exactly as in the JAX package,
    though it is below f32 epsilon on the unit-diagonal system."""
    s = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12))
    Hs = H * s[:, None] * s[None, :]
    Hs = Hs + lam * torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    x = _chol_solve(_cholesky_or_nan(Hs), (s * b)[:, None])
    return s * x[:, 0]


@functools.lru_cache(maxsize=8)
def _imu_scatter_const(W: int, dtype, device) -> torch.Tensor:
    """(W-1, D, 30) selection tensor: slot s maps its (state_s,
    state_{s+1}) tangent block onto rows [s·15, (s+2)·15)."""
    S = STATE_DIM
    P = np.zeros((W - 1, W * S, 2 * S), np.float64)
    for s_ in range(W - 1):
        P[s_, s_ * S:(s_ + 2) * S, :] = np.eye(2 * S)
    return torch.as_tensor(P, dtype=dtype, device=device)


def _state_prior_info(cfg: SmootherConfig, dtype, device) -> torch.Tensor:
    """15x15 information of the initial prior (tangent order rho,theta,v,b)."""
    sig = torch.tensor(
        [cfg.prior_trans_sigma] * 3 + [cfg.prior_rot_sigma] * 3
        + [cfg.prior_vel_sigma] * 3 + [cfg.prior_bias_sigma] * 6,
        dtype=dtype, device=device)
    return torch.diag(torch.clamp(1.0 / (sig * sig), max=cfg.info_cap))


def _empty_pim(n: int, dtype, device) -> pre.PreintegratedImu:
    """Stack of n zero (invalid) preintegration results."""
    def z(*shape):
        return torch.zeros((n,) + shape, dtype=dtype, device=device)
    eye = torch.eye(3, dtype=dtype, device=device).expand(n, 3, 3).clone()
    return pre.PreintegratedImu(
        delta_t=z(), delta_R=eye, delta_v=z(3), delta_p=z(3),
        cov=z(9, 9), dR_dbg=z(3, 3), dv_dba=z(3, 3), dv_dbg=z(3, 3),
        dp_dba=z(3, 3), dp_dbg=z(3, 3), bias_hat=z(6),
    )


def init(cfg: SmootherConfig, pose0, vel0, bias0, t0) -> SmootherState:
    """W pinned copies of the initial state, each with its own prior (the
    warm-up trick of the JAX package: no partially filled window)."""
    dtype, device = pose0.dtype, pose0.device
    W = cfg.window
    D = W * STATE_DIM
    B = cfg.between_slots
    U = cfg.unary_slots

    states = F.KeyframeStates(
        poses=pose0.expand(W, 7).clone(),
        vels=torch.as_tensor(vel0, dtype=dtype, device=device).expand(W, 3).clone(),
        biases=torch.as_tensor(bias0, dtype=dtype, device=device).expand(W, 6).clone(),
    )
    info15 = _state_prior_info(cfg, dtype, device)
    prior_H = torch.block_diag(*([info15] * W))
    ident = lie.pose_identity(dtype, device)

    def zi(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    def zf(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return SmootherState(
        states=states,
        times=torch.as_tensor(t0, dtype=dtype, device=device).expand(W).clone(),
        key0=zi(),
        prior_H=prior_H,
        prior_g=zf(D),
        prior_lin=states,
        imu=_empty_pim(W - 1, dtype, device),
        imu_valid=zf(W - 1),
        btw_i=zi(B), btw_j=zi(B),
        btw_meas=ident.expand(B, 7).clone(),
        btw_info=zf(B, 6, 6), btw_valid=zf(B), btw_next=zi(),
        una_slot=zi(U),
        una_meas=ident.expand(U, 7).clone(),
        una_info=zf(U, 6, 6), una_valid=zf(U), una_next=zi(),
    )


# ---------------------------------------------------------------------------
# Linearization / assembly of the normal equations
# ---------------------------------------------------------------------------

def _gravity_vec(cfg: SmootherConfig, dtype, device):
    return torch.tensor([0.0, 0.0, -cfg.imu.gravity], dtype=dtype,
                        device=device)


def _linearize_imu_slots(cfg: SmootherConfig, s: SmootherState,
                         x: F.KeyframeStates):
    """Linearization of all W-1 consecutive IMU factors (batched)."""
    g = _gravity_vec(cfg, x.poses.dtype, x.poses.device)
    r, A_i, A_j = F.linearize_imu_factor(
        x.poses[:-1], x.vels[:-1], x.biases[:-1],
        x.poses[1:], x.vels[1:], x.biases[1:], s.imu, g)
    cov15 = pre.combined_covariance_15(s.imu, cfg.imu)
    # Invalid slots have zero covariance — jitter makes the inverse finite,
    # and the validity mask zeroes the information afterwards.
    info = F.info_from_cov(cov15, jitter=1e-12)
    info = _cap_info(info, cfg.info_cap)
    info = info * s.imu_valid[:, None, None]
    return r, A_i, A_j, info


def _linearize_between_slots(s: SmootherState, x: F.KeyframeStates):
    W = x.poses.shape[0]
    ic = torch.clamp(s.btw_i, 0, W - 1).long()
    jc = torch.clamp(s.btw_j, 0, W - 1).long()
    r, A_i, A_j = F.linearize_between_factor(x.poses[ic], x.poses[jc],
                                             s.btw_meas)
    info = s.btw_info * s.btw_valid[:, None, None]
    return r, A_i, A_j, info


def _linearize_unary_slots(s: SmootherState, x: F.KeyframeStates):
    W = x.poses.shape[0]
    kc = torch.clamp(s.una_slot, 0, W - 1).long()
    r, A = F.linearize_pose_prior(x.poses[kc], s.una_meas)
    info = s.una_info * s.una_valid[:, None, None]
    return r, A, info


def _one_hot_cols(slot: torch.Tensor, W: int, dtype) -> torch.Tensor:
    """(N, D, 15) column selection of each slot's 15-dim tangent block."""
    D = W * STATE_DIM
    d_idx = torch.arange(D, device=slot.device)
    k15 = torch.arange(STATE_DIM, device=slot.device)
    slot = torch.clamp(slot, 0, W - 1).long()
    return (d_idx[None, :, None]
            == (slot * STATE_DIM)[:, None, None] + k15[None, None, :]
            ).to(dtype)


def _assemble(cfg: SmootherConfig, s: SmootherState, x: F.KeyframeStates,
              include_prior: bool = True, imu_mask=None, btw_mask=None,
              una_mask=None):
    """Dense normal equations (H, b) of all active factors at x; the GN
    step is dx = -(H + λI)⁻¹ b."""
    dtype, device = x.poses.dtype, x.poses.device
    W = x.poses.shape[0]
    D = W * STATE_DIM
    H = torch.zeros((D, D), dtype=dtype, device=device)
    b = torch.zeros((D,), dtype=dtype, device=device)

    if include_prior:
        d0 = F.local_window(s.prior_lin, x).reshape(-1)
        H = H + s.prior_H
        b = b + s.prior_g + s.prior_H @ d0

    # IMU factors: consecutive pairs, one contraction against the constant
    # block-selection tensor.
    r, A_i, A_j, info = _linearize_imu_slots(cfg, s, x)
    if imu_mask is not None:
        info = info * imu_mask[:, None, None]
    A = torch.cat([A_i, A_j], dim=-1)                     # (W-1, 15, 30)
    Hc = torch.einsum("sri,srq,sqk->sik", A, info, A)     # (W-1, 30, 30)
    bc = torch.einsum("sri,srq,sq->si", A, info, r)       # (W-1, 30)
    P = _imu_scatter_const(W, dtype, device)              # (W-1, D, 30)
    H = H + torch.einsum("sdi,sij,sej->de", P, Hc, P)
    b = b + torch.einsum("sdi,si->d", P, bc)

    # Between factors: arbitrary (i, j) pairs via one-hot expansion.
    rb, B_i, B_j, binfo = _linearize_between_slots(s, x)
    if btw_mask is not None:
        binfo = binfo * btw_mask[:, None, None]
    Afull = (torch.einsum("brk,bdk->brd", B_i, _one_hot_cols(s.btw_i, W, dtype))
             + torch.einsum("brk,bdk->brd", B_j,
                            _one_hot_cols(s.btw_j, W, dtype)))   # (B, 6, D)
    Lr = torch.einsum("brq,bq->br", binfo, rb)
    H = H + torch.einsum("brd,brq,bqe->de", Afull, binfo, Afull)
    b = b + torch.einsum("brd,br->d", Afull, Lr)

    # Unary absolute anchors.
    ru, U_A, uinfo = _linearize_unary_slots(s, x)
    if una_mask is not None:
        uinfo = uinfo * una_mask[:, None, None]
    Ufull = torch.einsum("urk,udk->urd", U_A,
                         _one_hot_cols(s.una_slot, W, dtype))    # (U, 6, D)
    H = H + torch.einsum("urd,urq,uqe->de", Ufull, uinfo, Ufull)
    b = b + torch.einsum("urd,urq,uq->d", Ufull, uinfo, ru)
    return H, b


# ---------------------------------------------------------------------------
# Solve (Gauss-Newton with fixed iteration count)
# ---------------------------------------------------------------------------

def solve(cfg: SmootherConfig, s: SmootherState) -> SmootherState:
    """cfg.gn_iters Gauss-Newton iterations, relinearizing each time."""
    W = s.states.poses.shape[0]
    x = s.states
    for _ in range(cfg.gn_iters):
        H, b = _assemble(cfg, s, x)
        dx = -_jacobi_solve(H, b, cfg.damping)
        x = F.retract_window(x, dx.reshape(W, STATE_DIM))
    return s._replace(states=x)


# ---------------------------------------------------------------------------
# Window management
# ---------------------------------------------------------------------------

def _shift(a: torch.Tensor, new_last: torch.Tensor) -> torch.Tensor:
    """Drop entry 0 along the leading axis, append ``new_last``."""
    return torch.cat([a[1:], new_last[None]], dim=0)


def add_keyframe(cfg: SmootherConfig, s: SmootherState, t_new,
                 pim: pre.PreintegratedImu) -> SmootherState:
    """Slide the window and append a keyframe at time t_new.

    The oldest slot's Markov blanket is linearized at the current estimates
    and Schur-eliminated in the prior's frozen coordinates (first-estimates
    policy, exactly as the JAX package). ``pim`` is the preintegration over
    (times[-1], t_new] at the current last-state bias."""
    dtype, device = s.states.poses.dtype, s.states.poses.device
    W = cfg.window
    D = W * STATE_DIM
    S = STATE_DIM
    x = s.states

    # ---- 1. Linearize the Markov blanket of slot 0 ------------------------
    d0 = F.local_window(s.prior_lin, x).reshape(-1)
    imu_mask = torch.zeros((W - 1,), dtype=dtype, device=device)
    imu_mask[0] = 1.0
    btw_mask = (s.btw_i == 0).to(dtype) * s.btw_valid
    una_mask = (s.una_slot == 0).to(dtype) * s.una_valid
    H_t, b_t = _assemble(cfg, s, x, include_prior=False,
                         imu_mask=imu_mask * s.imu_valid,
                         btw_mask=btw_mask, una_mask=una_mask)
    H_m = s.prior_H + H_t
    b_m = s.prior_g + b_t - H_t @ d0

    # ---- 2. Jacobi-scaled Schur elimination of the first 15 rows/cols -----
    Hmm, Hmr, Hrr = H_m[:S, :S], H_m[:S, S:], H_m[S:, S:]
    bm, br = b_m[:S], b_m[S:]
    smm = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(Hmm), min=1e-12))
    # 1e-7 damping kept exactly as in the JAX package.
    Hmm_s = (Hmm * smm[:, None] * smm[None, :]
             + 1e-7 * torch.eye(S, dtype=dtype, device=device))
    rhs = torch.cat([Hmr, bm[:, None]], dim=1) * smm[:, None]
    K = smm[:, None] * _chol_solve(_cholesky_or_nan(Hmm_s), rhs)
    Sc = Hrr - Hmr.T @ K[:, :-1]
    gs = br - Hmr.T @ K[:, -1]

    # ---- 3. Shift the window down by one ----------------------------------
    bias_prev = x.biases[-1]
    pose_new, vel_new = pre.predict(pim, x.poses[-1], x.vels[-1], bias_prev,
                                    cfg.imu)

    def shift_states(st: F.KeyframeStates) -> F.KeyframeStates:
        return F.KeyframeStates(poses=_shift(st.poses, pose_new),
                                vels=_shift(st.vels, vel_new),
                                biases=_shift(st.biases, bias_prev))

    # Zero-padded, not written into slices, so the eviction maps over lanes.
    prior_H_new = torch.nn.functional.pad(Sc, (0, S, 0, S))
    prior_g_new = torch.nn.functional.pad(gs, (0, S))

    btw_i_new = s.btw_i - 1
    una_slot_new = s.una_slot - 1
    return SmootherState(
        states=shift_states(x),
        times=_shift(s.times, torch.as_tensor(t_new, dtype=dtype,
                                              device=device)),
        key0=s.key0 + 1,
        prior_H=prior_H_new,
        prior_g=prior_g_new,
        prior_lin=shift_states(s.prior_lin),
        imu=pre.PreintegratedImu(*(_shift(a, n) for a, n in zip(s.imu, pim))),
        imu_valid=_shift(s.imu_valid, torch.ones((), dtype=dtype,
                                                 device=device)),
        btw_i=btw_i_new,
        btw_j=s.btw_j - 1,
        btw_meas=s.btw_meas,
        btw_info=s.btw_info,
        btw_valid=s.btw_valid * (btw_i_new >= 0).to(dtype),
        btw_next=s.btw_next,
        una_slot=torch.clamp(una_slot_new, min=0),
        una_meas=s.una_meas,
        una_info=s.una_info,
        una_valid=s.una_valid * (una_slot_new >= 0).to(dtype),
        una_next=s.una_next,
    )


def _ring_set(pool: torch.Tensor, k: torch.Tensor, value) -> torch.Tensor:
    """pool with entry k (a device scalar) replaced by ``value`` — a one-hot
    select, so the ring pointer is never read on the host."""
    hit = torch.arange(pool.shape[0], device=pool.device) == k
    hit = hit.reshape((-1,) + (1,) * (pool.dim() - 1))
    return torch.where(hit, torch.as_tensor(value, dtype=pool.dtype,
                                            device=pool.device), pool)


def add_between(cfg: SmootherConfig, s: SmootherState, i_window, j_window,
                measured, cov, valid) -> SmootherState:
    """Insert a between-factor into the ring pool (GraphManager.cpp:83-88).
    ``valid`` folds in every upstream gate (key match, max_time_skip, the
    degeneracy drop, window residency)."""
    dtype = s.states.poses.dtype
    k = torch.remainder(s.btw_next, cfg.between_slots)
    in_win = (i_window >= 0) & (i_window < j_window)
    v = valid.to(dtype) * in_win.to(dtype)
    info = _cap_info(F.info_from_cov(cov, jitter=1e-12), cfg.info_cap)
    return s._replace(
        btw_i=_ring_set(s.btw_i, k, torch.clamp(i_window, min=0)),
        btw_j=_ring_set(s.btw_j, k, j_window),
        btw_meas=_ring_set(s.btw_meas, k, measured),
        btw_info=_ring_set(s.btw_info, k, info),
        btw_valid=_ring_set(s.btw_valid, k, v),
        btw_next=s.btw_next + 1,
    )


def add_unary(cfg: SmootherConfig, s: SmootherState, k_window, measured,
              cov, valid) -> SmootherState:
    """Insert an absolute pose anchor (PriorFactor<Pose3>) on window slot
    ``k_window`` into the ring pool."""
    dtype = s.states.poses.dtype
    k = torch.remainder(s.una_next, cfg.unary_slots)
    W = s.states.poses.shape[0]
    in_win = (k_window >= 0) & (k_window < W)
    v = valid.to(dtype) * in_win.to(dtype)
    info = _cap_info(F.info_from_cov(cov, jitter=1e-12), cfg.info_cap)
    return s._replace(
        una_slot=_ring_set(s.una_slot, k, torch.clamp(k_window, 0, W - 1)),
        una_meas=_ring_set(s.una_meas, k, measured),
        una_info=_ring_set(s.una_info, k, info),
        una_valid=_ring_set(s.una_valid, k, v),
        una_next=s.una_next + 1,
    )


def latest(s: SmootherState):
    """(pose, vel, bias, time) of the newest keyframe."""
    return (s.states.poses[-1], s.states.vels[-1], s.states.biases[-1],
            s.times[-1])
