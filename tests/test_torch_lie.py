"""Parity of the port's Lie-group ops with the JAX package, in float64, on
identical numpy inputs (generic rotations and the small-angle Taylor
branches)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vil_sensor_fusion_tpu.core import lie as JL
from vil_sensor_fusion_tpu_torch.core import lie as TL

# Same formulas in f64 on both sides: only round-off differs.
RTOL, ATOL = 1e-9, 1e-11


def _inputs():
    rng = np.random.default_rng(11)
    n = 32
    theta = rng.standard_normal((n, 3)) * 0.8
    theta[:4] *= 1e-6                            # Taylor branches
    theta[4] = 0.0
    rho = rng.standard_normal((n, 3)) * 2.0
    xi = np.concatenate([rho, theta], -1)
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[5] = [-0.2, 0.5, 0.5, np.sqrt(1 - 0.54)]   # w < 0 (double cover)
    t = rng.standard_normal((n, 3)) * 10
    p = np.concatenate([q, t], -1)
    p2 = np.concatenate([q[::-1], t[::-1] * 0.5], -1)
    v = rng.standard_normal((n, 3))
    R = np.asarray(JL.quat_to_rot(jnp.asarray(q)))
    return dict(theta=theta, xi=xi, q=q, q2=q[::-1].copy(), p=p, p2=p2, v=v,
                R=R, rpy=rng.uniform(-1, 1, (n, 3)))


CASES = {
    "quat_normalize": ("q",),
    "quat_conjugate": ("q",),
    "quat_mul": ("q", "q2"),
    "quat_rotate": ("q", "v"),
    "quat_to_rot": ("q",),
    "rot_to_quat": ("R",),
    "quat_canonical": ("q",),
    "hat": ("v",),
    "so3_exp_quat": ("theta",),
    "so3_exp": ("theta",),
    "so3_log": ("R",),
    "quat_log": ("q",),
    "so3_left_jacobian": ("theta",),
    "so3_right_jacobian": ("theta",),
    "so3_left_jacobian_inv": ("theta",),
    "so3_right_jacobian_inv": ("theta",),
    "pose_compose": ("p", "p2"),
    "pose_inverse": ("p",),
    "pose_between": ("p", "p2"),
    "pose_ref_delta": ("p", "p2"),
    "se3_exp": ("xi",),
    "se3_log": ("p",),
    "pose_retract": ("p", "xi"),
    "pose_local": ("p", "p2"),
    "pose_adjoint": ("p",),
    "quat_to_euler": ("q",),
    "euler_to_quat": ("rpy",),
    "rotation_angle": ("q",),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_lie_op_matches_jax(name):
    data = _inputs()
    args = [data[a] for a in CASES[name]]
    out_j = getattr(JL, name)(*[jnp.asarray(a) for a in args])
    out_t = getattr(TL, name)(*[torch.from_numpy(a) for a in args])
    assert out_t.dtype == torch.float64
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               rtol=RTOL, atol=ATOL)


def test_vee_and_transform_points_match_jax():
    data = _inputs()
    M = np.asarray(JL.hat(jnp.asarray(data["v"])))
    np.testing.assert_allclose(TL.vee(torch.from_numpy(M)).numpy(),
                               np.asarray(JL.vee(jnp.asarray(M))))
    pts = np.random.default_rng(2).standard_normal((32, 50, 3))
    out_j = JL.pose_transform_points(jnp.asarray(data["p"]), jnp.asarray(pts))
    out_t = TL.pose_transform_points(torch.from_numpy(data["p"]),
                                     torch.from_numpy(pts))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=RTOL,
                               atol=1e-10)


def test_identity_constructors_follow_dtype_and_device():
    p = TL.pose_identity(torch.float64, "cpu")
    assert p.dtype == torch.float64 and p.device.type == "cpu"
    np.testing.assert_array_equal(p.numpy(), np.asarray(JL.pose_identity()))
    np.testing.assert_array_equal(TL.quat_identity().numpy(),
                                  np.asarray(JL.quat_identity()))
