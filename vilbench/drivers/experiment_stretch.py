"""One scored degeneracy experiment at a time: a stretch of the thesis's
tunnel drive through ``eval/experiments.run_scenario`` (``run_vil``, then
the metric scores, the gate's log-dets and the dist slopes, then the numpy
result), each pass from fresh states over the same stretch, back to back
(a closed loop of one client calibrating the gate).

Configuration: the experiment's ``kind``, its ``spec`` (the
``ExperimentSpec`` knobs, the defaults of ``default_grid``), the stretch
(``stretch_start_s``, ``duration_s``) of the ``DRIVE_S`` s drive, and the
``maps``. The stretch is made by the reference's generator
(``reference/experiment.tunnel_stretch``), so both sides get the same
tensors; the program's side runs ``ExperimentSpec(kind, DRIVE_S, seed,
**spec)`` through ``experiment_config`` and ``run_scenario``, bypassing
the experiment cache. Traffic parameters (``params``): ``trace_passes``,
the passes in the profiler slice.

The check compares one pass drawn from the seed with the reference's pass
over the same inputs from its own fresh states. It reads the VIO, LiDAR and
fused pose gaps, the median relative gaps of the Hessian, ``n_corr`` and
6 × S dists series and of the finite score entries, the score entries
whose class (finite, NaN, +inf, −inf) differs, and the differing flags (the
gate's ``keep``, the ICP's frozen directions, the fused ``healthy`` and
``solved``); the cell's ``limits`` judge those that part sound runs from
the TF32 control, the last two exactly.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from vilbench.reference import compare as C
from vilbench.reference import experiment as X
from vilbench.reference import pipeline as R

STAGES = ("experiment",)
# Result entries the check holds exactly.
FLAGS = ("gate_keep", "icp_degenerate", "fused_healthy", "fused_solved")
# What the check reads of a pass's result besides the scores.
COMPARED = ("vio_poses", "lidar_poses", "fused_poses", "hessian", "n_corr",
            "dists") + FLAGS


def score_class(a: np.ndarray) -> np.ndarray:
    """0 finite, 1 NaN, 2 +inf, 3 −inf, per entry."""
    return np.select([np.isnan(a), np.isposinf(a), np.isneginf(a)],
                     [1, 2, 3], 0)


def score_readings(prog: dict, ref: dict) -> tuple[list[float], int]:
    """The relative gap of every score entry finite on both sides
    (``|a − b| / |b|``, ``|a − b|`` where ``b`` is 0), and how many
    entries differ in class. A series the program lacks, or holds with
    another shape, differs in every entry."""
    gaps, differ = [], 0
    for name, b in ref.items():
        b = np.asarray(b, np.float64)
        a = prog.get(name)
        a = None if a is None else np.asarray(a, np.float64)
        if a is None or a.shape != b.shape:
            differ += b.size
            continue
        ca, cb = score_class(a), score_class(b)
        differ += int((ca != cb).sum())
        both = (ca == 0) & (cb == 0)
        d, den = np.abs(a[both] - b[both]), np.abs(b[both])
        gaps += np.where(den > 0, d / np.where(den > 0, den, 1.0),
                         d).tolist()
    return gaps, differ


def readings(prog: dict, ref: dict) -> dict:
    """One pass's numbers: ``prog`` and ``ref`` are result dicts under
    ``run_scenario``'s keys."""
    gaps, differ = score_readings(prog["scores"], ref["scores"])
    return dict(
        vio_gap_m=C.trans_gap(prog["vio_poses"], ref["vio_poses"]),
        lidar_gap_m=C.trans_gap(prog["lidar_poses"], ref["lidar_poses"]),
        fused_gap_m=C.trans_gap(prog["fused_poses"], ref["fused_poses"]),
        hessian_gap_median=C.per_entry_rel_gap(prog["hessian"],
                                               ref["hessian"]),
        ncorr_gap_median=C.per_entry_count_gap(prog["n_corr"],
                                               ref["n_corr"]),
        dists_gap_median=C.per_entry_rel_gap(prog["dists"], ref["dists"]),
        score_gap_median=gaps,
        nonfinite_mismatch=differ,
        flags_mismatch=sum(C.mismatches(prog[k], ref[k]) for k in FLAGS))


def flag_counts(out: dict) -> str:
    """The sweeps with a frozen ICP direction and those the gate dropped,
    by index, and the events the health guard rejected and solved."""
    frozen = np.flatnonzero(np.any(np.asarray(out["icp_degenerate"]) > 0,
                                   -1)).tolist()
    dropped = np.flatnonzero(np.asarray(out["gate_keep"]) == 0).tolist()
    return (f"sweeps frozen {frozen}, dropped {dropped}; events rejected "
            f"{int((np.asarray(out['fused_healthy']) == 0).sum())}, solves "
            f"{int(np.asarray(out['fused_solved']).sum())}")


def port_scenario(sc):
    """The generator's scenario in the port's types (the same tensors)."""
    from vil_sensor_fusion_tpu_torch.data import raycast, scenarios
    from vil_sensor_fusion_tpu_torch.data import synthetic
    from vil_sensor_fusion_tpu_torch.frontends import vio
    from vil_sensor_fusion_tpu_torch.frontends.lidar import Sweep

    return scenarios.VilScenario(**dict(
        sc._asdict(), traj=synthetic.Trajectory(*sc.traj),
        world=raycast.World(*sc.world),
        vio_frames=vio.VioFrameInput(*sc.vio_frames),
        sweeps=Sweep(*sc.sweeps)))


class ExperimentCell:
    stage_names = STAGES

    def __init__(self, ctx):
        conf, p = ctx.config, ctx.params
        self.ctx, self.limits = ctx, ctx.limits
        if conf["kind"] != X.KIND:
            raise ValueError(f"the reference generates the {X.KIND} drive, "
                             f"the configuration asks for {conf['kind']!r}")
        self.spec = dict(conf["spec"])
        off = [k for k in ("two_stage", "undistort", "emit_dists",
                           "distort_sweeps") if not self.spec[k]]
        if off:
            raise ValueError("the reference runs every switch on; the "
                             f"configuration turns off {', '.join(off)}")
        self.maps = dict(conf["maps"])
        self.trace_units = int(p["trace_passes"])
        self.ref_cfg = X.experiment_config(
            icp_iters=self.spec["icp_iters"],
            degen_eigval=self.spec["degen_eigval"],
            trans_threshold=self.spec["trans_threshold"],
            rot_threshold=self.spec["rot_threshold"], **self.maps)
        self.ref_sc = X.tunnel_stretch(ctx.seed,
                                       float(conf["stretch_start_s"]),
                                       float(conf["duration_s"]), ctx.device)
        Tv, Tl = len(self.ref_sc.vio_times), len(self.ref_sc.lidar_times)
        self.counts = {"step": Tv + Tl, "sweep": Tl, "frame": Tv}
        self.events_per_unit = Tv + Tl
        if ctx.side == "program":
            self._setup_program(conf)
        else:
            def control():
                with R.tf32(True):
                    return X.run_scenario(self.ref_cfg, self.ref_sc)

            self.run_pass = control
        self.outputs = []

    def _setup_program(self, conf):
        from vil_sensor_fusion_tpu_torch.eval import experiments as EX
        from vil_sensor_fusion_tpu_torch.ops import knn as K

        self.K = K
        if self.ctx.device.type == "cuda":
            K.build_kernel()
        spec = EX.ExperimentSpec(kind=conf["kind"], duration=X.DRIVE_S,
                                 seed=self.ctx.seed, **self.spec)
        cfg = EX.experiment_config(spec)
        lid, m = cfg.lidar, self.maps
        sized = lid._replace(
            corner_map=lid.corner_map._replace(
                capacity=m["corner_capacity"]),
            surf_map=lid.surf_map._replace(capacity=m["surf_capacity"]),
            submap_corners=m["submap_corners"],
            submap_surfs=m["submap_surfs"])
        if sized != lid:
            self.ctx.log(f"maps and submaps set from the configuration: {m}")
            cfg = cfg._replace(lidar=sized)
        sc = port_scenario(self.ref_sc)

        def program():
            return EX.run_scenario(spec, cfg, sc)

        self.run_pass = program

    def warm(self):
        launches = getattr(self, "K", None) and self.K.KERNEL_LAUNCHES
        out = self.run_pass()
        self.ctx.sync()
        if launches is not None:
            self.ctx.log(f"k-NN kernel launches per pass: "
                         f"{self.K.KERNEL_LAUNCHES - launches}")
        missing = [k for k in COMPARED + ("scores",) if k not in out]
        if missing:
            raise RuntimeError("the program's run_scenario result has no "
                               f"{', '.join(missing)}: the check compares "
                               "them, so this cell cannot run it")
        self.ctx.log(f"warm pass: {flag_counts(out)} (of "
                     f"{self.counts['sweep']} sweeps, "
                     f"{self.counts['step']} events)")

    def unit(self, rec):
        t0 = time.perf_counter()
        out = rec.time("experiment", self.run_pass)
        self.ctx.sync()
        lat = time.perf_counter() - t0
        self.outputs.append(out)
        return {"latency_s": lat, "counts": dict(self.counts)}

    def release(self):
        self.run_pass = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, rng):
        prog = self.outputs[int(rng.integers(len(self.outputs)))]
        self.outputs = []
        with R.tf32(False):
            ref = X.run_scenario(self.ref_cfg, self.ref_sc)
        self.ctx.sync()
        self.ctx.log(f"check pass: {flag_counts(prog)} / {flag_counts(ref)} "
                     "(program / reference)")
        return [readings(prog, ref)], self.limits


def setup(ctx):
    return ExperimentCell(ctx)
