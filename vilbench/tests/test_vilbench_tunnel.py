"""The ``tunnel-exp.grid`` cell on the CPU: the stretch generator against the
port's own tunnel drive, a pass of the cell's tiny twin (the same rates,
iterations and k-NN calls, a 0.3 s stretch and narrow maps) that the
cell's correctness check reads as correct and every new span reader reads, faults
that trip the check, and every key of ``tunnel-exp.json`` read or held to
what runs. (``vilbench_tiny.make_root`` knows the first two cells only,
so the twin is added here.)"""

from __future__ import annotations

import contextlib
import inspect
import json
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.func import vmap

from vil_sensor_fusion_tpu_torch.data import raycast as rc
from vil_sensor_fusion_tpu_torch.data import scenarios as SC
from vil_sensor_fusion_tpu_torch.eval import experiments as EX
from vil_sensor_fusion_tpu_torch.ops import knn as K
from vilbench import harness
from vilbench.reference import experiment as X
from vilbench.tests.vilbench_tiny import REPO

CELL, TWIN = "tunnel-exp.grid", "tiny-tunnel.grid"
CONF = json.loads((REPO / "vilbench/configs/tunnel-exp.json").read_text())
READERS = ("vil_lidar_ms_per_sweep", "perturb_ms_per_sweep",
           "vil_vio_ms_per_frame", "vil_timeline_ms_per_run",
           "score_ms_per_sweep")
SEED = 2**31 + 4711
# Keys that only say where the configuration comes from.
ABOUT = {"name", "source", "reduced_from", "assumed"}
# Keys ``drivers/experiment_stretch.py`` reads.
READ = {"kind", "spec", "duration_s", "stretch_start_s", "maps"}
# Keys these tests hold to what runs.
CHECKED = {"world", "lidar", "imu_rate_hz", "vio", "icp", "gate", "fusion",
           "precision", "guarantees"}
GUARANTEES = ("every event fused in time order; scores, gate flags and "
              "their NaN / inf pattern as the f32 estimator computes them")


def tiny_root(tmp):
    """``BENCHMARK.json`` and ``vilbench/`` copied to ``tmp`` with the
    cell's tiny twin added as files and entries."""
    shutil.copytree(REPO / "vilbench", tmp / "vilbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    base = tmp / "vilbench"
    conf = dict(CONF, name="tiny-tunnel", duration_s=0.3,
                maps=dict(corner_capacity=4096, surf_capacity=8192,
                          submap_corners=512, submap_surfs=1024))
    work = json.loads((base / f"workloads/{CELL}.json").read_text())
    (base / "configs/tiny-tunnel.json").write_text(json.dumps(conf))
    (base / f"workloads/{TWIN}.json").write_text(
        json.dumps(dict(work, config="tiny-tunnel")))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    c = next(c for c in bench["configs"] if c["name"] == "tunnel-exp")
    w = next(w for w in bench["workloads"] if w["name"] == CELL)
    bench["configs"].append(dict(c, name="tiny-tunnel",
                                 file="vilbench/configs/tiny-tunnel.json"))
    bench["workloads"].append(dict(w, name=TWIN, config="tiny-tunnel"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TWIN)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One pass of the twin on the CPU with the new span readers' hooks
    open, then the cell's correctness check of it, with every pass's result on both
    sides and the program's k-NN calls noted."""
    root = tiny_root(tmp_path_factory.mktemp("tunnel"))
    spec = harness.cell_spec(root, TWIN)
    driver = harness.load_module(root / "vilbench", "drivers",
                                 spec["workload"]["driver"])
    readers = {m: harness.load_module(root / "vilbench", "metrics", m)
               for m in READERS}
    prog, ref, knn = [], [], []
    real_prog, real_ref, real_knn = EX.run_scenario, X.run_scenario, K.knn

    def keep(out, into):
        into.append(out)
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(EX, "run_scenario", lambda *a: keep(real_prog(*a), prog))
    mp.setattr(X, "run_scenario", lambda *a: keep(real_ref(*a), ref))
    mp.setattr(K, "knn", lambda *a, **k: keep(real_knn(*a, **k), knn))
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    observed = {m: [] for m in READERS}
    try:
        ctx = SimpleNamespace(device=torch.device("cpu"), seed=SEED,
                              config=spec["config"],
                              params=spec["workload"]["params"],
                              limits=spec["workload"]["limits"],
                              side="program", sync=lambda: None,
                              log=lambda msg: None)
        cell = driver.setup(ctx)
        with contextlib.ExitStack() as stack:
            for m in READERS:
                stack.enter_context(readers[m].observe(observed[m]))
            cell.unit(harness.Spans())
        readings, limits = cell.check(np.random.default_rng(SEED))
    finally:
        torch.set_num_threads(n)
        mp.undo()
    metrics = {m: readers[m].read(SimpleNamespace(observed=observed))
               for m in READERS}
    checks, failed = harness.judge(readings, limits)
    return SimpleNamespace(metrics=metrics, checks=checks, failed=failed,
                           prog=prog, ref=ref, knn=len(knn), root=root,
                           sweeps=cell.counts["sweep"],
                           events=cell.events_per_unit)


def test_the_check_reads_correct_and_every_reader_reads(traced):
    assert traced.failed == 0, traced.checks
    for name in READERS:
        assert traced.metrics[name] > 0, name
    assert len(traced.prog) == len(traced.ref) == 1


def _fault_cases():
    def zero_dists(out):
        out["dists"] = np.zeros_like(out["dists"])
        return "dists_gap_median"

    def move_lidar(out):
        out["lidar_poses"] = np.array(out["lidar_poses"])
        out["lidar_poses"][-1, 5] += 0.1
        return "lidar_gap_m"

    def shift_scores(out):
        out["scores"] = {k: np.roll(v, 1) for k, v in out["scores"].items()}
        return "score_gap_median"

    def flip_keep(out):
        out["gate_keep"] = out["gate_keep"].copy()
        out["gate_keep"][-1] = 1.0 - out["gate_keep"][-1]
        return "flags_mismatch"

    def nan_score(out):
        name, v = next((k, v) for k, v in out["scores"].items()
                       if np.isfinite(v).any())
        v = v.copy()
        v[np.flatnonzero(np.isfinite(v))[0]] = np.nan
        out["scores"] = dict(out["scores"], **{name: v})
        return "nonfinite_mismatch"

    return [zero_dists, move_lidar, shift_scores, flip_keep, nan_score]


@pytest.mark.parametrize("fault", _fault_cases())
def test_a_fault_trips_the_check(traced, fault):
    driver = harness.load_module(traced.root / "vilbench", "drivers",
                                 "experiment_stretch")
    limits = harness.cell_spec(traced.root, TWIN)["workload"]["limits"]
    out = dict(traced.prog[0])
    number = fault(out)
    checks, failed = harness.judge([driver.readings(out, traced.ref[0])],
                                   limits)
    assert failed == 1
    assert checks[number]["value"] > checks[number]["limit"]


def test_a_program_without_the_compared_results_fails_in_set_up(
        tmp_path, monkeypatch):
    """A program whose ``run_scenario`` returns no dists or flags (the port
    before this cell) stops at the warm-up, before any window."""
    root = tiny_root(tmp_path)
    spec = harness.cell_spec(root, TWIN)
    driver = harness.load_module(root / "vilbench", "drivers",
                                 "experiment_stretch")
    monkeypatch.setattr(X, "tunnel_stretch",
                        lambda *a, **k: SimpleNamespace(vio_times=[0.05],
                                                        lidar_times=[0.1]))
    monkeypatch.setattr(driver, "port_scenario", lambda sc: sc)
    monkeypatch.setattr(EX, "run_scenario",
                        lambda *a: {"scores": {}, "n_corr": np.ones(1)})
    ctx = SimpleNamespace(device=torch.device("cpu"), seed=SEED,
                          config=spec["config"],
                          params=spec["workload"]["params"],
                          limits=spec["workload"]["limits"], side="program",
                          sync=lambda: None, log=lambda msg: None)
    cell = driver.setup(ctx)
    with pytest.raises(RuntimeError, match="no vio_poses"):
        cell.warm()


def test_the_stretch_is_the_ports_tunnel_drive():
    """The generator's world, ground truth, labels and first and last
    sweeps against the port's own 60 s tunnel drive (``scenarios._kind``,
    what ``scenarios.build`` draws) at the stretch's drive times."""
    start, dur = CONF["stretch_start_s"], CONF["duration_s"]
    sc = X.tunnel_stretch(SEED, start, dur, "cpu")
    world, traj, windows, *_ = SC._kind("tunnel", X.DRIVE_S, SEED,
                                        torch.float32, "cpu")
    for a, b in zip(sc.world, world):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert sc.degen_windows == tuple((a - start, b - start, k)
                                     for a, b, k in windows)

    def truth(times):
        t = torch.as_tensor(np.asarray(times) + start, dtype=torch.float64)
        return vmap(traj.pose_fn)(t).float()

    np.testing.assert_allclose(sc.gt_vio_poses, truth(sc.vio_times),
                               atol=2e-6)
    np.testing.assert_allclose(sc.gt_lidar_poses, truth(sc.lidar_times),
                               atol=2e-6)
    for i in (0, len(sc.lidar_times) - 1):
        t_end = sc.lidar_times[i]
        ps, pe = truth([t_end - 1.0 / X.LIDAR_HZ, t_end])
        want = rc.raycast_motion(world, ps, pe)
        got = [f[i] for f in sc.sweeps]
        assert float((got[-1] != want.mask).float().mean()) < 1e-3
        both = (got[-1] > 0) & (want.mask > 0)
        torch.testing.assert_close(got[0][both], want.xyz[both], rtol=0,
                                   atol=1e-3)
    # The stretch starts at the entry portal and enters the labelled
    # window after half a second.
    x0 = CONF["world"]["tunnel_x_m"][0]
    assert float(sc.gt_lidar_poses[0, 4]) == pytest.approx(
        x0 + CONF["world"]["speed_mps"] / X.LIDAR_HZ, abs=1e-3)
    lo, hi, _ = sc.degen_windows[0]
    inside = (sc.lidar_times >= lo) & (sc.lidar_times <= hi)
    assert 0 < inside.sum() < len(inside)


def test_every_key_is_read_or_checked():
    assert set(CONF) <= ABOUT | READ | CHECKED
    assert set(CONF) >= READ | CHECKED


def test_the_stated_configuration_is_the_one_run():
    spec = EX.ExperimentSpec(kind=CONF["kind"], duration=X.DRIVE_S,
                             **CONF["spec"])
    assert spec == EX.ExperimentSpec(kind="tunnel", duration=60.0)
    assert spec in EX.default_grid(seeds=(0,))
    assert CONF["reduced_from"] == {"duration_s": X.DRIVE_S}
    m = CONF["maps"]
    ref = X.experiment_config(icp_iters=spec.icp_iters,
                              degen_eigval=spec.degen_eigval,
                              trans_threshold=spec.trans_threshold,
                              rot_threshold=spec.rot_threshold, **m)
    for cfg in (EX.experiment_config(spec), ref):
        lid = cfg.lidar
        assert (lid.two_stage, lid.undistort, lid.emit_dists,
                lid.guess_is_delta) == (True, True, True, True)
        assert lid.odom_icp.iters == CONF["icp"]["scan_to_scan_iters"]
        assert lid.icp.iters == CONF["icp"]["scan_to_map_iters"]
        assert lid.odom_icp.fit_every == lid.icp.fit_every == \
            CONF["icp"]["fit_every"]
        assert lid.icp.degen_eigval == spec.degen_eigval
        assert lid.dists_shifts == CONF["icp"]["dists_shifts"]
        assert (lid.corner_map.capacity, lid.surf_map.capacity,
                lid.submap_corners, lid.submap_surfs) == (
            m["corner_capacity"], m["surf_capacity"], m["submap_corners"],
            m["submap_surfs"])
        assert (cfg.gate.trans_threshold, cfg.gate.rot_threshold,
                cfg.gate.normalize_per_corr) == (
            spec.trans_threshold, spec.rot_threshold,
            CONF["gate"]["normalize_per_corr"])
        sm = cfg.fusion.smoother
        assert dict(window=sm.window, between_slots=sm.between_slots,
                    gn_iters=sm.gn_iters,
                    max_imu_per_gap=cfg.fusion.max_imu_per_gap) == \
            CONF["fusion"]
        assert (cfg.vio.num_landmarks, cfg.vio.update_iters) == (
            CONF["vio"]["landmark_slots"], CONF["vio"]["update_iters"])
    assert CONF["precision"] == "float32, TF32 off"
    assert CONF["guarantees"] == GUARANTEES
    w = CONF["world"]
    world, *_, speed, _, _ = SC._kind("tunnel", X.DRIVE_S, 0,
                                      torch.float64, "cpu")
    assert speed == w["speed_mps"]
    assert w["road_length_m"] == speed * X.DRIVE_S
    tube = world.box_max[-3:] - world.box_min[-3:]
    assert [float(world.box_min[-1, 0]), float(world.box_max[-1, 0])] == \
        w["tunnel_x_m"]
    assert float(world.box_min[-2, 1] - world.box_max[-3, 1]) == \
        w["tunnel_width_m"]
    assert float(world.box_min[-1, 2]) == w["tunnel_height_m"]
    assert bool((tube[:, 0] == 40.0).all())
    assert world.box_min.shape[0] == w["road_buildings"] + w["tube_boxes"]
    assert list(SC._kind("tunnel", X.DRIVE_S, 0, torch.float64,
                         "cpu")[2][0][:2]) == w["degenerate_window_s"]
    assert (rc.RINGS, rc.AZIMUTH) == (CONF["lidar"]["channels"],
                                      CONF["lidar"]["azimuth_columns"])
    assert inspect.signature(rc.raycast_motion).parameters[
        "max_range"].default == CONF["lidar"]["range_m"]
    assert CONF["lidar"]["motion_distorted"] == spec.distort_sweeps
    assert (X.VIO_HZ, X.LIDAR_HZ, X.IMU_HZ) == (
        CONF["vio"]["rate_hz"], CONF["lidar"]["rate_hz"],
        CONF["imu_rate_hz"])
    assert CONF["vio"]["tracks"] == "synthetic"


def test_the_twin_runs_what_is_stated(traced):
    """Rates, k-NN calls, float32 and every event fused in time order, on
    the twin's pass."""
    sc = X.tunnel_stretch(SEED, CONF["stretch_start_s"], 0.3, "cpu")
    assert 1 / np.diff(sc.vio_times).mean() == pytest.approx(
        CONF["vio"]["rate_hz"])
    assert 1 / np.diff(sc.lidar_times).mean() == pytest.approx(
        CONF["lidar"]["rate_hz"])
    assert 1 / float(torch.diff(sc.imu_times).mean()) == pytest.approx(
        CONF["imu_rate_hz"], rel=1e-4)
    assert sc.sweeps.xyz.shape[1:3] == (CONF["lidar"]["channels"],
                                        CONF["lidar"]["azimuth_columns"])
    assert traced.sweeps == len(sc.lidar_times)
    assert traced.knn == CONF["icp"]["knn_launches_per_sweep"] * \
        traced.sweeps
    out = traced.prog[0]
    for k in ("vio_poses", "fused_poses", "hessian", "dists"):
        assert out[k].dtype == np.float32, k
    assert len(out["fused_poses"]) == traced.events
    assert (np.diff(out["fused_times"]) >= 0).all()
    assert traced.checks["nonfinite_mismatch"]["value"] == 0
    assert traced.checks["flags_mismatch"]["value"] == 0


def test_the_reference_imports_nothing_of_the_port():
    p = subprocess.run(
        [sys.executable, "-c", "import sys, vilbench.reference.experiment\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    top = set(p.stdout.split())
    assert not top & {"vil_sensor_fusion_tpu_torch", "vil_sensor_fusion_tpu",
                      "jax", "jaxlib"}
