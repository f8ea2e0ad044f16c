"""The check catches a broken timed path: each fault the cells can have is
planted in the port underneath a CPU run of a tiny cell, and ``correct``
comes out false. (The cells run on one card, so there is no exchange
between cards to leave out.)"""

from __future__ import annotations

import pytest
import torch

from vil_sensor_fusion_tpu_torch import _tree
from vil_sensor_fusion_tpu_torch import bench as B
from vil_sensor_fusion_tpu_torch import soak as S
from vil_sensor_fusion_tpu_torch.frontends import vio
from vil_sensor_fusion_tpu_torch.frontends.lidar import odometry
from vil_sensor_fusion_tpu_torch.fusion import engine
from vilbench import harness
from vilbench.tests.vilbench_tiny import LANES, STREAM, make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def _shift_first_pose(fused):
    poses = fused.poses.clone()
    poses[..., 0, 4] += 0.5              # 0.5 m along x, one event
    return fused._replace(poses=poses)


def state_unchanged_lidar(mp):
    real = odometry.step

    def step(cfg, state, *a, **k):
        return state, real(cfg, state, *a, **k)[1]

    mp.setattr(odometry, "step", step)


def half_the_lanes(mp):
    real = B.lanes_pass

    def lanes_pass(cfg, x, s, timer):
        half = x.pose0.shape[0] // 2
        cut = lambda v: v[:half] if isinstance(v, torch.Tensor) and \
            v.dim() and v.shape[0] == 2 * half else v  # noqa: E731
        x_half = x._replace(**{k: _tree.tree_map(cut, getattr(x, k))
                               for k in x._fields if k not in (
                                   "vio_times", "lidar_times", "guess_idx")})
        out = real(cfg, x_half, _tree.tree_map(cut, s), timer)
        return _tree.tree_map(lambda v: torch.cat([v, v]), out)

    mp.setattr(B, "lanes_pass", lanes_pass)


def answer_altered_lanes(mp):
    real = engine.run_lanes

    def run_lanes(*a, **k):
        es, fused = real(*a, **k)
        return es, _shift_first_pose(fused)

    mp.setattr(engine, "run_lanes", run_lanes)


def state_unchanged_chunk(mp):
    real = S.estimator_chunk

    def estimator_chunk(rig, idx, state, *a, **k):
        return state, real(rig, idx, state, *a, **k)[1]

    mp.setattr(S, "estimator_chunk", estimator_chunk)


def state_unchanged_engine(mp):
    """The single-lane engine step the stream runs returns the state it
    was given."""
    real = engine.step

    def step(cfg, es, *a, **k):
        return es, real(cfg, es, *a, **k)[1]

    mp.setattr(engine, "step", step)


def answer_altered_engine(mp):
    """Each fused pose moved 0.5 m where the engine step produces it."""
    real = engine.step

    def step(*a, **k):
        es, (t, pose, *rest) = real(*a, **k)
        return es, (t, pose + torch.tensor([0, 0, 0, 0, 0.5, 0, 0]), *rest)

    mp.setattr(engine, "step", step)


def answer_altered_vio(mp):
    """A VIO pose altered where the EKF produces it."""
    real = vio.run

    def run(*a, **k):
        st, out = real(*a, **k)
        pose = out.pose.clone()
        pose[0, 4] += 0.5
        return st, out._replace(pose=pose)

    mp.setattr(vio, "run", run)


@pytest.mark.parametrize("cell, fault", [
    (LANES, state_unchanged_lidar), (LANES, half_the_lanes),
    (LANES, answer_altered_lanes), (STREAM, state_unchanged_chunk),
    (STREAM, state_unchanged_engine), (STREAM, answer_altered_engine),
    (STREAM, answer_altered_vio)])
def test_a_broken_timed_path_is_not_correct(root, cell, fault, monkeypatch):
    torch.set_num_threads(2)
    fault(monkeypatch)
    res, lines = harness.run(cell, 2**31 + 99, 0.01, False, "cpu", root=root)
    assert res["correct"] is False, lines
    assert res["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
