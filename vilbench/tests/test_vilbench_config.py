"""Every key of each configuration file is what runs: the drivers read some,
and this test holds every other one to the program's and the reference's
configuration objects at full size, and to a CPU run of the cell's tiny
twin (the same rates, sensors, iterations and k-NN calls at a smaller
camera and drive). A key that is neither read nor checked here fails."""

from __future__ import annotations

import inspect
import json
import math
from types import SimpleNamespace

import pytest
import torch

from vil_sensor_fusion_tpu_torch import bench as B
from vil_sensor_fusion_tpu_torch import soak as S
from vil_sensor_fusion_tpu_torch.ops import knn as K
from vilbench import harness
from vilbench.reference import pipeline as R
from vilbench.reference.vil.data import raycast as rc
from vilbench.tests.vilbench_tiny import LANES, REPO, STREAM, make_root

# Keys that only say where the configuration comes from.
ABOUT = {"name", "source", "reduced_from", "assumed"}
# Keys the drivers read.
READ = {"town-bench": {"rig", "landmark_slots", "duration_s", "world"},
        "road-soak": {"cam_w", "cam_h", "landmarks", "photometric",
                      "speed_mps", "world_length_m", "chunk_s", "duration_s",
                      "world"}}
# Keys this test holds to what runs.
CHECKED = {"camera", "lidar", "imu_rate_hz", "icp", "gate",
           "fixed_lag_window", "precision", "guarantees", "maps"}
# The guarantees each file states, as the tiny runs below check them.
GUARANTEES = {
    "town-bench": "every event fused in time order; poses as the f32 "
                  "estimator computes them",
    "road-soak": "every chunk's state carried to the next; every event "
                 "fused in time order"}


def _conf(name):
    return json.loads((REPO / "vilbench" / "configs" / f"{name}.json")
                      .read_text())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("name", ["town-bench", "road-soak"])
def test_every_key_is_read_or_checked(name):
    assert set(_conf(name)) <= ABOUT | READ[name] | CHECKED


def _configs(name):
    c = _conf(name)
    if name == "town-bench":
        return c, [B.bench_config(B.Rig(**c["rig"])),
                   R.bench_config(R.Rig(**c["rig"]), c["landmark_slots"])]
    return c, [S.soak_rig(c["cam_w"], c["cam_h"], c["landmarks"]),
               R.soak_rig(c["cam_w"], c["cam_h"], c["landmarks"])]


@pytest.mark.parametrize("name", ["town-bench", "road-soak"])
def test_the_stated_sizes_are_the_ones_built(name):
    c, built = _configs(name)
    for cfg in built:
        cam = cfg.vio.cam
        assert (cam.width, cam.height) == (c["camera"]["width"],
                                           c["camera"]["height"])
        fov = math.degrees(2 * math.atan(cam.width / 2 / cam.fx))
        assert fov == pytest.approx(c["camera"]["fov_deg"])
        lid = cfg.lidar
        assert lid.two_stage
        assert lid.odom_icp.iters == c["icp"]["scan_to_scan_iters"]
        assert lid.icp.iters == c["icp"]["scan_to_map_iters"]
        assert lid.odom_icp.fit_every == lid.icp.fit_every == \
            c["icp"]["fit_every"]
        maps = c["rig"] if name == "town-bench" else c["maps"]
        assert lid.corner_map.capacity == maps["corner_capacity"]
        assert lid.surf_map.capacity == maps["surf_capacity"]
        assert lid.submap_corners == maps["submap_corners"]
        assert lid.submap_surfs == maps["submap_surfs"]
        assert (cfg.gate.rot_threshold, cfg.gate.trans_threshold) == (
            c["gate"]["rot_threshold"], c["gate"]["trans_threshold"])
        assert cfg.fusion.smoother.window == c["fixed_lag_window"]
    assert c["precision"] == "float32, TF32 off"
    assert c["guarantees"] == GUARANTEES[name]
    assert (rc.RINGS, rc.AZIMUTH) == (c["lidar"]["channels"],
                                      c["lidar"]["azimuth_columns"])
    for cast in (rc.raycast, rc.raycast_motion, rc.sweep_series):
        assert inspect.signature(cast).parameters["max_range"].default == \
            c["lidar"]["range_m"]


def _cell(root, cell):
    spec = harness.cell_spec(root, cell)
    driver = harness.load_module(spec["base"], "drivers",
                                 spec["workload"]["driver"])
    ctx = SimpleNamespace(device=torch.device("cpu"), seed=2**31 + 5,
                          config=spec["config"], traffic=spec["entry"],
                          params=spec["workload"]["params"],
                          limits=spec["workload"]["limits"], side="program",
                          sync=lambda: None, log=lambda msg: None)
    return spec["config"]["name"], driver.setup(ctx)


def _count_knn(monkeypatch):
    calls = []
    real = K.knn

    def knn(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(K, "knn", knn)
    return calls


def _spacing(t) -> float:
    t = torch.as_tensor(t, dtype=torch.float64).reshape(-1)
    return float(torch.diff(t).median())


@pytest.mark.parametrize("cell", [LANES, STREAM])
def test_a_run_renders_and_runs_what_is_stated(root, cell, monkeypatch):
    torch.set_num_threads(2)
    twin, c = _cell(root, cell)
    conf = _conf("town-bench" if twin == "tiny-town" else "road-soak")
    calls = _count_knn(monkeypatch)
    c.warm()
    if twin == "tiny-town":
        x = c.x_ref
        vio_t, lidar_t, imu_t = x.vio_times, x.lidar_times, x.imu_times[0]
        sweeps, sweeps_run = x.sweeps, len(x.lidar_times)
        fused, floats = c.warm_out.fused, [x.images, x.sweeps.xyz,
                                           x.imu_accel]
    else:
        x = c.inputs[0]
        vio_t, imu_t, sweeps = c.ref_idx.vio_rel, x.imu[0], x.sweeps
        sweeps_run = c.warm_chunks * len(c.ref_idx.lidar_rel)
        fused = c.history[-1][3].fused
        floats = [x.images, x.sweeps.xyz, x.imu[1]]
        # Every chunk starts from the state the one before it carried out.
        for a, b in zip(c.history, c.history[1:]):
            assert b[1] is a[2]
    assert 1 / _spacing(vio_t) == pytest.approx(conf["camera"]["rate_hz"])
    if twin == "tiny-town":
        assert 1 / _spacing(lidar_t) == pytest.approx(
            conf["lidar"]["rate_hz"])
    else:
        assert len(c.ref_idx.lidar_rel) == round(
            conf["chunk_s"] * conf["lidar"]["rate_hz"])
    assert 1 / _spacing(imu_t) == pytest.approx(conf["imu_rate_hz"], rel=1e-3)
    ring_az = tuple(sweeps.xyz.shape[-3:-1])
    assert ring_az == (conf["lidar"]["channels"],
                       conf["lidar"]["azimuth_columns"])
    rng = sweeps.rng[sweeps.mask > 0]
    assert 0 < float(rng.max()) <= conf["lidar"]["range_m"]
    assert len(calls) == conf["icp"]["knn_launches_per_sweep"] * sweeps_run
    # float32 in and out; every event fused, in time order.
    assert all(t.dtype == torch.float32 for t in floats)
    assert fused.poses.dtype == torch.float32
    assert fused.poses.shape[-2] == c.counts["step"]
    assert bool((torch.diff(fused.times, dim=-1) >= 0).all())
