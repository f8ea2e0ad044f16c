"""Parity of the port's ``data/scenarios.build`` with the JAX package for
every scenario kind (town, corridor, arena, field, tunnel), in float64:
the labeled degenerate windows are equal, and the ground truth, event
times and IMU stream agree to 1e-12 (the same analytic trajectories). The
random worlds differ (numpy's RNG in the port; ``test_torch_data.py``
holds the sweeps of handed-over worlds to JAX's), so sweeps are compared
where the world is deterministic: the motion-distorted corridor.

The two durations of each kind keep the sweep count (0.2 and 0.25 s: two
sweeps), so JAX compiles its raycast once per kind; the windows of the
tunnel and field kinds move with the duration."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vil_sensor_fusion_tpu.data import scenarios as JSC
from vil_sensor_fusion_tpu_torch.data import scenarios as TSC

DT = jnp.float64


@pytest.mark.parametrize("kind", ["town", "corridor", "arena", "field",
                                  "tunnel"])
def test_scenario_windows_and_ground_truth_match_jax(kind):
    """``scenarios.build`` of every kind at two durations: the labeled
    degenerate windows equal JAX's, the ground truth and IMU stream agree
    to 1e-12 (the same analytic trajectory in f64)."""
    for duration in (0.2, 0.25):
        j = JSC.build(kind, duration=duration, dtype=DT)
        t = TSC.build(kind, duration=duration, dtype=torch.float64,
                      device="cpu")
        assert t.degen_windows == j.degen_windows
        for f in ("gt_vio_poses", "gt_lidar_poses", "vio_times",
                  "lidar_times", "lidar_guess_idx"):
            np.testing.assert_allclose(np.asarray(getattr(t, f)),
                                       np.asarray(getattr(j, f)),
                                       rtol=0, atol=1e-12, err_msg=f)
        np.testing.assert_allclose(t.imu_accel.numpy(),
                                   np.asarray(j.imu_accel), atol=1e-12)
        assert tuple(t.sweeps.xyz.shape) == np.asarray(j.sweeps.xyz).shape


def test_distorted_corridor_sweeps_match_jax():
    """``distort_sweeps``: each sweep cast from the poses over its scan
    period (deterministic corridor world, so the sweeps themselves agree)."""
    j = JSC.build("corridor", duration=0.2, dtype=DT, distort_sweeps=True)
    t = TSC.build("corridor", duration=0.2, dtype=torch.float64,
                  device="cpu", distort_sweeps=True)
    np.testing.assert_array_equal(t.sweeps.mask.numpy(),
                                  np.asarray(j.sweeps.mask))
    np.testing.assert_allclose(t.sweeps.xyz.numpy(), np.asarray(j.sweeps.xyz),
                               rtol=1e-9, atol=1e-9)
