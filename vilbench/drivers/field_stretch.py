"""One scored field degeneracy experiment at a time: ``experiment_stretch``'s
cell over a stretch of the thesis's field drive, which is labelled
degenerate in rotation and in translation at once, each pass from fresh
states over the same stretch, back to back (a closed loop of one client
calibrating the gate).

Configuration and traffic parameters are ``experiment_stretch``'s; the
``kind`` is ``field``. The stretch is made by the reference's generator
(``reference/field.field_stretch``), so both sides get the same tensors;
the program's side runs ``ExperimentSpec("field", DRIVE_S, seed, **spec)``
through ``experiment_config`` and ``run_scenario``, bypassing the
experiment cache, and the control side the reference in TF32. The warm-up,
the timed unit, the check and its readings are ``experiment_stretch``'s.
"""

from __future__ import annotations

from vilbench.drivers import experiment_stretch as ES
from vilbench.reference import experiment as X
from vilbench.reference import field as F
from vilbench.reference import pipeline as R

# The check's readings of a pass (the tests plant faults through them).
readings = ES.readings


class FieldCell(ES.ExperimentCell):
    """``ExperimentCell`` with the field stretch as its inputs."""

    def __init__(self, ctx):
        conf, p = ctx.config, ctx.params
        self.ctx, self.limits = ctx, ctx.limits
        if conf["kind"] != F.KIND:
            raise ValueError(f"the reference generates the {F.KIND} drive, "
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
        self.ref_sc = F.field_stretch(ctx.seed,
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


def setup(ctx):
    return FieldCell(ctx)
