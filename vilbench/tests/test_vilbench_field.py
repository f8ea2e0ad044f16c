"""The ``field-exp.grid`` cell on the CPU: a pass of the cell's tiny twin (the
same rates, iterations and k-NN calls, a 0.3 s stretch from 29.4 s and
narrow maps) that the cell's correctness check reads as correct and the
new reader reads, faults that trip the check (a kept sweep, a flipped
frozen flag, a NaN score turned finite), every key of ``field-exp.json``
read or held to what runs, and the reference importing nothing of the
port. (``vilbench_tiny.make_root`` knows the first two cells only, so the
twin is added here.)"""

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

from vil_sensor_fusion_tpu_torch.data import raycast as rc
from vil_sensor_fusion_tpu_torch.data import scenarios as SC
from vil_sensor_fusion_tpu_torch.eval import experiments as EX
from vil_sensor_fusion_tpu_torch.ops import knn as K
from vilbench import harness
from vilbench.reference import experiment as X
from vilbench.reference import field as F
from vilbench.tests.vilbench_tiny import REPO

CELL, TWIN = "field-exp.grid", "tiny-field.grid"
CONF = json.loads((REPO / "vilbench/configs/field-exp.json").read_text())
READER = "diagnostics_ms_per_run"
SEED = 2**31 + 4711
# Keys that only say where the configuration comes from.
ABOUT = {"name", "source", "reduced_from", "assumed"}
# Keys ``drivers/field_stretch.py`` reads.
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
    conf = dict(CONF, name="tiny-field", duration_s=0.3,
                maps=dict(corner_capacity=4096, surf_capacity=8192,
                          submap_corners=512, submap_surfs=1024))
    work = json.loads((base / f"workloads/{CELL}.json").read_text())
    (base / "configs/tiny-field.json").write_text(json.dumps(conf))
    (base / f"workloads/{TWIN}.json").write_text(
        json.dumps(dict(work, config="tiny-field")))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    c = next(c for c in bench["configs"] if c["name"] == "field-exp")
    w = next(w for w in bench["workloads"] if w["name"] == CELL)
    bench["configs"].append(dict(c, name="tiny-field",
                                 file="vilbench/configs/tiny-field.json"))
    bench["workloads"].append(dict(w, name=TWIN, config="tiny-field"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TWIN)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One pass of the twin on the CPU with the new reader's hook open,
    then the cell's correctness check of it, with every pass's result on
    both sides and the program's k-NN calls noted."""
    root = tiny_root(tmp_path_factory.mktemp("field"))
    spec = harness.cell_spec(root, TWIN)
    driver = harness.load_module(root / "vilbench", "drivers",
                                 spec["workload"]["driver"])
    reader = harness.load_module(root / "vilbench", "metrics", READER)
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
    observed = {READER: []}
    try:
        ctx = SimpleNamespace(device=torch.device("cpu"), seed=SEED,
                              config=spec["config"],
                              params=spec["workload"]["params"],
                              limits=spec["workload"]["limits"],
                              side="program", sync=lambda: None,
                              log=lambda msg: None)
        cell = driver.setup(ctx)
        with contextlib.ExitStack() as stack:
            stack.enter_context(reader.observe(observed[READER]))
            cell.unit(harness.Spans())
        readings, limits = cell.check(np.random.default_rng(SEED))
    finally:
        torch.set_num_threads(n)
        mp.undo()
    metric = reader.read(SimpleNamespace(observed=observed))
    checks, failed = harness.judge(readings, limits)
    return SimpleNamespace(metric=metric, checks=checks, failed=failed,
                           prog=prog, ref=ref, knn=len(knn), root=root,
                           sweeps=cell.counts["sweep"],
                           events=cell.events_per_unit)


def test_the_check_reads_correct_and_the_reader_reads(traced):
    assert traced.failed == 0, traced.checks
    assert traced.metric > 0
    assert len(traced.prog) == len(traced.ref) == 1


def test_the_reader_prints_the_frozen_and_dropped_sweeps(capsys):
    from vil_sensor_fusion_tpu_torch.utils import tracing as TR

    reader = harness.load_module(REPO / "vilbench", "metrics", READER)
    noted = []
    with reader.observe(noted):
        with TR.span("experiments.diagnostics"):
            pass
        TR.count("vil.runs", 2)
        TR.count("odometry.sweeps", 24)
        TR.count("icp.frozen_sweeps", 24)
        TR.count("gate.dropped_sweeps", 23)
    v = reader.read(SimpleNamespace(observed={READER: noted}))
    assert v is not None and v >= 0
    err = capsys.readouterr().err
    assert ("odometry.sweeps 24, icp.frozen_sweeps 24, "
            "gate.dropped_sweeps 23") in err
    # Nothing to read: a run counted but no span, a span but no run
    # counted, or no recording (a program without the recorder).
    def no_span():
        TR.count("vil.runs", 1)

    def no_run():
        with TR.span("experiments.diagnostics"):
            pass

    for body in (no_span, no_run):
        noted = []
        with reader.observe(noted):
            body()
        assert reader.read(SimpleNamespace(observed={READER: noted})) \
            is None
    assert reader.read(SimpleNamespace(observed={})) is None


def _fault_cases():
    def keep_a_sweep(out):
        out["gate_keep"] = out["gate_keep"].copy()
        out["gate_keep"][-1] = 1.0
        return "flags_mismatch"

    def unfreeze_a_direction(out):
        out["icp_degenerate"] = out["icp_degenerate"].copy()
        i = np.flatnonzero(out["icp_degenerate"][-1] > 0)[0]
        out["icp_degenerate"][-1, i] = 0.0
        return "flags_mismatch"

    def nan_score_made_finite(out):
        name, v = next((k, v) for k, v in out["scores"].items()
                       if np.isnan(v).any())
        v = v.copy()
        v[np.flatnonzero(np.isnan(v))[0]] = 0.0
        out["scores"] = dict(out["scores"], **{name: v})
        return "nonfinite_mismatch"

    def move_fused(out):
        out["fused_poses"] = np.array(out["fused_poses"])
        out["fused_poses"][-1, 4] += 1.0
        return "fused_gap_m"

    def scale_hessian(out):
        out["hessian"] = out["hessian"] * np.float32(1.2)
        return "hessian_gap_median"

    return [keep_a_sweep, unfreeze_a_direction, nan_score_made_finite,
            move_fused, scale_hessian]


@pytest.mark.parametrize("fault", _fault_cases())
def test_a_fault_trips_the_check(traced, fault):
    driver = harness.load_module(traced.root / "vilbench", "drivers",
                                 "field_stretch")
    limits = harness.cell_spec(traced.root, TWIN)["workload"]["limits"]
    out = dict(traced.prog[0])
    number = fault(out)
    checks, failed = harness.judge([driver.readings(out, traced.ref[0])],
                                   limits)
    assert failed == 1
    assert checks[number]["value"] > checks[number]["limit"]


def test_another_kind_is_refused(tmp_path):
    root = tiny_root(tmp_path)
    spec = harness.cell_spec(root, TWIN)
    driver = harness.load_module(root / "vilbench", "drivers",
                                 "field_stretch")
    ctx = SimpleNamespace(device=torch.device("cpu"), seed=SEED,
                          config=dict(spec["config"], kind="tunnel"),
                          params=spec["workload"]["params"],
                          limits=spec["workload"]["limits"], side="program",
                          sync=lambda: None, log=lambda msg: None)
    with pytest.raises(ValueError, match="field drive"):
        driver.setup(ctx)


def test_every_key_is_read_or_checked():
    assert set(CONF) <= ABOUT | READ | CHECKED
    assert set(CONF) >= READ | CHECKED
    assert set(CONF["assumed"]) == {"stretch_start_s", "fresh_states",
                                    "landmarks"}


def test_the_stated_configuration_is_the_one_run():
    spec = EX.ExperimentSpec(kind=CONF["kind"], duration=X.DRIVE_S,
                             **CONF["spec"])
    assert spec == EX.ExperimentSpec(kind="field", duration=60.0)
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
    world, _, windows, speed, _, _ = SC._kind("field", X.DRIVE_S, 0,
                                              torch.float64, "cpu")
    assert speed == w["speed_mps"]
    assert w["road_length_m"] == speed * X.DRIVE_S
    assert world.box_min.shape[0] == w["road_buildings"]
    x0, x1 = w["field_x_m"]
    assert (x0, x1) == (w["road_length_m"] / 3, 2 * w["road_length_m"] / 3)
    over = (world.box_max[:, 0] > x0) & (world.box_min[:, 0] < x1)
    assert bool(over.any())
    assert w["buildings_over_field"] == "sunk below the ground"
    assert bool((world.box_max[over, 2] < 0).all())
    assert bool((world.box_max[~over, 2] > 0).all())
    cy = (world.box_min[:, 1] + world.box_max[:, 1]) / 2
    lo, hi = w["building_offset_m"]
    assert bool(((cy.abs() >= lo) & (cy.abs() <= hi)).all())
    assert {k: [a, b] for a, b, k in windows} == w["degenerate_window_s"]
    assert (rc.RINGS, rc.AZIMUTH) == (CONF["lidar"]["channels"],
                                      CONF["lidar"]["azimuth_columns"])
    assert inspect.signature(rc.raycast_motion).parameters[
        "max_range"].default == CONF["lidar"]["range_m"]
    assert CONF["lidar"]["motion_distorted"] == spec.distort_sweeps
    assert (X.VIO_HZ, X.LIDAR_HZ, X.IMU_HZ) == (
        CONF["vio"]["rate_hz"], CONF["lidar"]["rate_hz"],
        CONF["imu_rate_hz"])
    assert CONF["vio"]["tracks"] == "synthetic"
    # The stretch lies inside both labels.
    start, end = CONF["stretch_start_s"], \
        CONF["stretch_start_s"] + CONF["duration_s"]
    for a, b, _ in windows:
        assert a < start and end < b


def test_the_twin_runs_what_is_stated(traced):
    """Rates, k-NN calls, float32, every event fused in time order, and
    every sweep frozen and dropped on both sides."""
    sc = F.field_stretch(SEED, CONF["stretch_start_s"], 0.3, "cpu")
    assert 1 / np.diff(sc.vio_times).mean() == pytest.approx(
        CONF["vio"]["rate_hz"])
    assert 1 / np.diff(sc.lidar_times).mean() == pytest.approx(
        CONF["lidar"]["rate_hz"])
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
    for o in (out, traced.ref[0]):
        assert np.any(o["icp_degenerate"] > 0, axis=-1).all()
        assert (o["gate_keep"] == 0).all()
    assert traced.checks["nonfinite_mismatch"]["value"] == 0
    assert traced.checks["flags_mismatch"]["value"] == 0


def test_the_reference_imports_nothing_of_the_port():
    p = subprocess.run(
        [sys.executable, "-c", "import sys, vilbench.reference.field\n"
         "import vilbench.reference.experiment\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    top = set(p.stdout.split())
    assert not top & {"vil_sensor_fusion_tpu_torch", "vil_sensor_fusion_tpu",
                      "jax", "jaxlib"}
