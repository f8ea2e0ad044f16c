"""The port's stage profile (``vil_sensor_fusion_tpu_torch/profile_stages.py``)
on the CPU at a small rig: ``--device cpu --res 112x84 --frames 2
--sweeps 2`` with one timed call per row. Every row of the JAX package's
``scripts/profile_stages.py`` is there under its name (listed here), every
time is finite, and ``--only`` runs only the sections it names.

112×84 is the smallest 4:3 image whose coarsest pyramid level (28×21)
holds the KLT's 21-pixel window; at 80×60 (20×15) both packages refuse
the ``klt_track`` row (JAX's ``dynamic_slice`` does not fit).

The inputs are the script's random draws, so the tests check what runs and
what is reported, not the times; the per-row functions themselves are
held to JAX by the other ``test_torch_*`` files."""

import math

import pytest
import torch

from vil_sensor_fusion_tpu_torch import profile_stages as TPS

ARGS = ["--device", "cpu", "--res", "112x84", "--frames", "2", "--sweeps",
        "2"]
FRONTEND = [
    "pyramid (vmap T)",
    "shi_tomasi score (vmap T)",
    "detect full (vmap T)",
    "project_sweep+depth_at 64q (vmap T)",
    "klt_track 1 frame (24 slots)",
    "build_frames FULL (two-program)",
]
LIDAR = [
    "feat.extract",
    "undistort",
    "submap corner 32k->4096",
    "submap surf 64k->8192",
    "insert corner (+1920)",
    "insert surf (+3984)",
    "knn corner 1920x4096",
    "knn surf 3984x8192",
    "eig3 batch (3984)",
    "register 6 iters (map stage)",
    "register 8 iters (odom stage)",
    "odometry.step FULL (two_stage)",
    "odometry.step FULL (single)",
]
FUSION = [
    "engine.run (4 events)",       # frames + sweeps
    "vio.run (2 frames)",
]


@pytest.fixture(scope="module")
def profile():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        return TPS.run(TPS.parse_args(ARGS), reps=1)
    finally:
        torch.set_num_threads(n)


def test_every_jax_row_is_there(profile):
    assert list(profile) == FRONTEND + LIDAR + FUSION


def test_every_time_is_finite(profile):
    for name, row in profile.items():
        assert set(row) == {"ms", "first_call_s", "knn_launches"}, name
        assert math.isfinite(row["ms"]) and row["ms"] > 0, name
        assert math.isfinite(row["first_call_s"]), name
        assert row["knn_launches"] == 0, name      # no kernel on the CPU


def test_only_runs_the_sections_it_names(capsys):
    rows = TPS.run(TPS.parse_args(ARGS + ["--only", "fusion"]), reps=1)
    assert list(rows) == FUSION
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "platform=cpu res=112x84 frames=2 sweeps=2"
    assert out[1] == "--- fusion+vio ---" and out[-1] == "done"
    assert [ln[:42].rstrip() for ln in out[2:-1]] == FUSION
    assert all(ln.endswith("s)") and " ms   (first call " in ln
               for ln in out[2:-1])


def test_main_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks a host without one")
    with pytest.raises(RuntimeError, match="CUDA card"):
        TPS.main(["--only", "fusion", "--frames", "2", "--sweeps", "2"])
