"""Batch replay: distinct town drives as lanes, one pass of every stage over
all of them per unit, each pass from the same initial states, back to back
(a closed loop of one client replaying a data set).

Traffic parameters (the cell's ``params``): ``lanes``, the number of
distinct drives (seeds ``seed`` … ``seed + lanes − 1``), each pass through
``bench.lanes_pass`` (every stage over the lane axis). The configuration
gives the world, the rig (``rig``: camera and map sizes), the landmark
slots and the drive's length. The inputs are made by the reference's generator
(``reference/pipeline.build_inputs``), so both sides get the same tensors.

The check compares one pass drawn from the seed, every lane of it, with
the reference's pass over the same inputs from its own initial states.
"""

from __future__ import annotations

import time

import torch

from vilbench.harness import Spans
from vilbench.reference import compare as C
from vilbench.reference import pipeline as R

STAGES = ("frontend_pyr", "frontend_detect", "frontend_track", "vio",
          "lidar", "gate", "fusion")


class LanesCell:
    stage_names = STAGES
    trace_units = 1

    def __init__(self, ctx):
        conf, p = ctx.config, ctx.params
        self.ctx = ctx
        self.limits = ctx.limits
        self.lanes = int(p["lanes"])
        rig = R.Rig(**conf["rig"])
        self.ref_cfg = R.bench_config(rig, int(conf["landmark_slots"]))
        self.x_ref = R.build_inputs(self.ref_cfg, self.lanes,
                                    float(conf["duration_s"]), ctx.device,
                                    seed=ctx.seed, world=conf["world"])
        Tv, Tl = len(self.x_ref.vio_times), len(self.x_ref.lidar_times)
        self.counts = {"step": Tv + Tl, "sweep": Tl, "frame": Tv}
        self.events_per_unit = (Tv + Tl) * self.lanes
        if ctx.side == "program":
            self._setup_program(conf, rig)
        else:
            self.s_ref = R.initial_states(self.ref_cfg, self.x_ref)

            def control(rec):
                with R.tf32(True):
                    return R.lanes_pass(self.ref_cfg, self.x_ref, self.s_ref)

            self.run_pass = control
        self.outputs = []

    def _setup_program(self, conf, rig):
        from vil_sensor_fusion_tpu_torch import bench as B
        from vil_sensor_fusion_tpu_torch.ops import knn as K

        if int(conf["landmark_slots"]) != B.N_SLOTS:
            raise ValueError(f"the port's bench runs {B.N_SLOTS} landmark "
                             "slots, the configuration "
                             f"{conf['landmark_slots']}")
        self.K = K
        if self.ctx.device.type == "cuda":
            K.build_kernel()
        cfg = B.bench_config(B.Rig(**rig._asdict()))
        x = B.BenchInputs(**dict(self.x_ref._asdict(),
                                 sweeps=B.L.Sweep(*self.x_ref.sweeps)))
        s = B.initial_states(cfg, x)
        self.program = (cfg, x, s)

        def program(rec):
            return B.lanes_pass(*self.program, rec)

        self.run_pass = program

    def warm(self):
        launches = getattr(self, "K", None) and self.K.KERNEL_LAUNCHES
        self.warm_out = self.run_pass(Spans())
        self.ctx.sync()
        if launches is not None:
            self.ctx.log(f"k-NN kernel launches per pass: "
                         f"{self.K.KERNEL_LAUNCHES - launches}")

    def unit(self, rec):
        t0 = time.perf_counter()
        out = self.run_pass(rec)
        self.ctx.sync()
        lat = time.perf_counter() - t0
        self.outputs.append(out)
        return {"latency_s": lat, "counts": dict(self.counts)}

    def release(self):
        self.program = self.s_ref = self.warm_out = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, rng):
        prog = self.outputs[int(rng.integers(len(self.outputs)))]
        self.outputs = []
        s_ref = R.initial_states(self.ref_cfg, self.x_ref)
        with R.tf32(False):
            ref = R.lanes_pass(self.ref_cfg, self.x_ref, s_ref)
        self.ctx.sync()

        def parts(o, b):
            return {k: R.tree_map(lambda v: v[b], getattr(o, k))
                    for k in ("vio", "lidar", "fused")}

        return ([C.readings(parts(prog, b), parts(ref, b))
                 for b in range(self.lanes)], self.limits)


def setup(ctx):
    return LanesCell(ctx)
