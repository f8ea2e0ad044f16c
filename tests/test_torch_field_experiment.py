"""The field degeneracy experiment on the CPU (the benchmark's cell
``field-exp.grid`` at a tiny size, one intra-op thread): the plain
reference's stretch generator (``vilbench/reference/field.py``) against the
port's own 60 s field drive, and a 0.3 s stretch from drive time 29.4 s,
inside the open field and both labels, with narrow maps, through the port's
``experiments.run_scenario`` against the reference's: flags and score
classes equal and poses within the cell's limits, every sweep frozen and
dropped, and the ``experiments.diagnostics`` span once per call under
``experiments.run_scenario``."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.func import vmap

from vil_sensor_fusion_tpu_torch.data import raycast as rc
from vil_sensor_fusion_tpu_torch.data import scenarios as SC
from vil_sensor_fusion_tpu_torch.eval import experiments as EX
from vil_sensor_fusion_tpu_torch.utils import tracing as TR
from vilbench import harness
from vilbench.drivers import experiment_stretch as ES
from vilbench.reference import experiment as X
from vilbench.reference import field as F
from vilbench.reference import pipeline as R

REPO = Path(__file__).resolve().parents[1]
CONF = json.loads((REPO / "vilbench/configs/field-exp.json").read_text())
LIMITS = json.loads((REPO / "vilbench/workloads/field-exp.grid.json")
                    .read_text())["limits"]
SEED = 2**31 + 4711
START, DURATION = CONF["stretch_start_s"], 0.3
MAPS = dict(corner_capacity=4096, surf_capacity=8192, submap_corners=512,
            submap_surfs=1024)


def test_the_stretch_is_the_ports_field_drive():
    """World, ground truth, shifted labels and the first and last sweeps
    against the port's 60 s field drive (``scenarios._kind``, what
    ``scenarios.build("field", 60.0)`` draws) at the stretch's drive
    times."""
    sc = F.field_stretch(SEED, START, DURATION, "cpu")
    world, traj, windows, speed, *_ = SC._kind("field", X.DRIVE_S, SEED,
                                               torch.float32, "cpu")
    for a, b in zip(sc.world, world):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert sc.degen_windows == tuple((a - START, b - START, k)
                                     for a, b, k in windows)

    def truth(times):
        t = torch.as_tensor(np.asarray(times) + START, dtype=torch.float64)
        return vmap(traj.pose_fn)(t).float()

    np.testing.assert_allclose(sc.gt_vio_poses, truth(sc.vio_times),
                               atol=3e-5)
    np.testing.assert_allclose(sc.gt_lidar_poses, truth(sc.lidar_times),
                               atol=3e-5)
    for i in (0, len(sc.lidar_times) - 1):
        t_end = sc.lidar_times[i]
        ps, pe = truth([t_end - 1.0 / X.LIDAR_HZ, t_end])
        want = rc.raycast_motion(world, ps, pe)
        got = [f[i] for f in sc.sweeps]
        assert float((got[-1] != want.mask).float().mean()) < 1e-3
        both = (got[-1] > 0) & (want.mask > 0)
        torch.testing.assert_close(got[0][both], want.xyz[both], rtol=0,
                                   atol=1e-3)
    # The stretch lies inside both labels, at the drive's speed, in the
    # open field: nothing stands above the ground within the LiDAR's range.
    assert speed == CONF["world"]["speed_mps"]
    for lo, hi, _ in sc.degen_windows:
        assert lo < 0 and hi > sc.lidar_times[-1]
    x = sc.gt_lidar_poses[:, 4]
    up = world.box_max[:, 2] > 0
    gap = torch.maximum(world.box_min[up, 0] - float(x.max()),
                        float(x.min()) - world.box_max[up, 0])
    assert float(gap.min()) > 120.0


@pytest.fixture(scope="module")
def runs():
    """The 0.3 s stretch through the port (recorded) and the reference,
    at narrow maps."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        sc = F.field_stretch(SEED, START, DURATION, "cpu")
        spec = EX.ExperimentSpec(kind="field", duration=X.DRIVE_S,
                                 seed=SEED)
        cfg = EX.experiment_config(spec)
        lid = cfg.lidar
        cfg = cfg._replace(lidar=lid._replace(
            corner_map=lid.corner_map._replace(
                capacity=MAPS["corner_capacity"]),
            surf_map=lid.surf_map._replace(capacity=MAPS["surf_capacity"]),
            submap_corners=MAPS["submap_corners"],
            submap_surfs=MAPS["submap_surfs"]))
        with TR.recording() as rec:
            prog = EX.run_scenario(spec, cfg, ES.port_scenario(sc))
        with R.tf32(False):
            ref = X.run_scenario(X.experiment_config(**MAPS), sc)
    finally:
        torch.set_num_threads(n)
    return dict(prog=prog, ref=ref, trace=rec.trace,
                sweeps=len(sc.lidar_times))


def test_the_port_matches_the_reference_within_the_cells_limits(runs):
    prog, ref = runs["prog"], runs["ref"]
    checks, failed = harness.judge([ES.readings(prog, ref)], LIMITS)
    assert failed == 0, checks
    assert checks["flags_mismatch"]["value"] == 0
    assert checks["nonfinite_mismatch"]["value"] == 0
    for k in ES.FLAGS:
        np.testing.assert_array_equal(prog[k], ref[k], err_msg=k)
    assert prog["scores"].keys() == ref["scores"].keys()
    for k, v in ref["scores"].items():
        np.testing.assert_array_equal(ES.score_class(prog["scores"][k]),
                                      ES.score_class(v), err_msg=k)


def test_every_sweep_is_frozen_and_dropped(runs):
    """The stretch stays degenerate to the ICP and the gate, not to the
    labels alone: past sweep 0 (an empty map) too."""
    for out in (runs["prog"], runs["ref"]):
        assert np.any(out["icp_degenerate"] > 0, axis=-1).all()
        assert (out["gate_keep"] == 0).all()
        assert out["gate_keep"].shape == (runs["sweeps"],)
    counts = runs["trace"].counts
    assert counts["icp.frozen_sweeps"] == runs["sweeps"]
    assert counts["gate.dropped_sweeps"] == runs["sweeps"]


def test_the_diagnostics_span_fires_once_under_run_scenario(runs):
    spans = runs["trace"].spans
    names = [s.name for s in spans]
    assert names.count("experiments.diagnostics") == 1
    assert runs["trace"].counts["vil.runs"] == 1
    root = names.index("experiments.run_scenario")
    diag = spans[names.index("experiments.diagnostics")]
    assert spans[root].parent == -1
    assert diag.parent == root and diag.root == root
    score = spans[names.index("experiments.score")]
    fusion = spans[names.index("vil.fusion")]
    assert fusion.end <= diag.start <= diag.end <= score.start
