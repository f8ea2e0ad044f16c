"""The experiment path's program spans and counters (``utils.tracing``):
``experiments.run_scenario`` with ``experiments.score`` inside it,
``run_vil``'s stages (``vil.vio``, ``vil.lidar``, ``vil.gate``,
``vil.timeline``, ``vil.fusion``; counter ``vil.runs``) and
``icp.perturbation_dists``, on a 0.2 s corridor drive on the CPU: each
fires once per call, off they record nothing, they add no ``aten`` op,
and ``icp.frozen_sweeps`` / ``gate.dropped_sweeps`` are the counts of the
numpy result."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vil_sensor_fusion_tpu_torch.eval import experiments as EX
from vil_sensor_fusion_tpu_torch.frontends.lidar import voxelmap as vm
from vil_sensor_fusion_tpu_torch.utils import tracing as TR

VIL_STAGES = ("vil.vio", "vil.lidar", "vil.gate", "vil.timeline",
              "vil.fusion")


class _Ops(TorchDispatchMode):
    """Every ``aten`` op dispatched inside, by name, in order."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _case():
    spec = EX.ExperimentSpec(kind="corridor", duration=0.2, icp_iters=2)
    cfg = EX.experiment_config(spec)
    cfg = cfg._replace(lidar=cfg.lidar._replace(
        corner_map=vm.VoxelMapConfig(capacity=4096, leaf=0.2),
        surf_map=vm.VoxelMapConfig(capacity=8192, leaf=0.4),
        submap_corners=512, submap_surfs=1024))
    return spec, cfg, EX.experiment_scenario(spec, cfg, device="cpu")


@pytest.fixture(scope="module")
def runs():
    """The drive recorded, then run under the op counter with the recorder
    off and on (after the first run has filled the port's caches of
    device constants)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        spec, cfg, sc = _case()
        with TR.recording() as rec:
            out = EX.run_scenario(spec, cfg, sc)
        with _Ops() as off:
            out_off = EX.run_scenario(spec, cfg, sc)
        assert TR._REC is None
        with TR.recording():
            with _Ops() as on:
                EX.run_scenario(spec, cfg, sc)
    finally:
        torch.set_num_threads(n)
    return dict(sweeps=len(sc.lidar_times), off=off.names, on=on.names,
                out=out, out_off=out_off, trace=rec.trace)


def test_each_span_fires_once_per_call(runs):
    spans = runs["trace"].spans
    names = [s.name for s in spans]
    root = names.index("experiments.run_scenario")
    assert spans[root].parent == -1 and names.count(names[root]) == 1
    for name in VIL_STAGES + ("experiments.score",):
        assert names.count(name) == 1, name
        assert spans[names.index(name)].root == root, name
    assert spans[names.index("experiments.score")].parent == root
    lidar = names.index("vil.lidar")
    perturb = [s for s in spans if s.name == "icp.perturbation_dists"]
    assert len(perturb) == runs["sweeps"]
    assert all(spans[lidar].start <= s.start <= s.end <= spans[lidar].end
               for s in perturb)
    counts = runs["trace"].counts
    assert counts["vil.runs"] == 1
    assert counts["odometry.sweeps"] == runs["sweeps"]


def test_off_the_recorder_records_nothing(runs):
    with TR.recording() as rec:
        pass
    assert rec.trace == TR.Trace(spans=[], counts={})
    assert TR._REC is None


def test_the_spans_add_no_aten_op(runs):
    assert runs["off"] and runs["on"] == runs["off"]


def test_the_counters_are_the_numpy_results_counts(runs):
    counts, out = runs["trace"].counts, runs["out"]
    frozen = int(np.any(out["icp_degenerate"] > 0, axis=-1).sum())
    dropped = int((out["gate_keep"] == 0).sum())
    assert counts["icp.frozen_sweeps"] == frozen
    assert counts["gate.dropped_sweeps"] == dropped
    # The corridor starves translation along its axis.
    assert frozen > 0
    for k in ("icp_degenerate", "gate_keep", "dists", "fused_healthy",
              "fused_solved"):
        np.testing.assert_array_equal(out[k], runs["out_off"][k])
    assert out["dists"].shape == (runs["sweeps"], 6,
                                  EX.experiment_config(
                                      EX.ExperimentSpec()).lidar.dists_shifts)
