"""``perturb_ms_per_sweep``: the ICP's perturbation sweep (the
``icp.perturbation_dists`` span of ``frontends/lidar/icp``: two fits and
the 6 × 15 perturbed poses of an odometry step with ``emit_dists``) in the
profiler slice, in ms per sweep (``odometry.sweeps``)."""

from ._spans import ms_per, observe  # noqa: F401  (observe: the hook)

SPANS = ("icp.perturbation_dists",)
COUNTER = "odometry.sweeps"


def read(ctx):
    return ms_per(ctx, "perturb_ms_per_sweep", SPANS, COUNTER)
