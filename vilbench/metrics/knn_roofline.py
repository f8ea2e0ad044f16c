"""``knn_roofline``: the k-NN kernel's share of its roofline in the
profiler slice, in %: the least time of every launch (``_roofline``) over
the device time of every ``knn5_kernel`` run.

The launches' shapes come from :func:`observe`, which the harness holds
open over the slice: it wraps the port's kernel entry
``ops.knn.knn_cuda_lanes`` (every launch, lanes folded in, goes through
it) and notes ``(B, Q, M)`` per call, then puts the entry back. The
profiler's own input shapes would cost the slice twice its length. Nothing
to read without a launch, or where the calls noted and the kernels run
differ in number."""

from __future__ import annotations

import contextlib

from . import _roofline as R


@contextlib.contextmanager
def observe(noted: list):
    try:
        from vil_sensor_fusion_tpu_torch.ops import knn as K
    except ImportError:
        yield
        return
    real = K.knn_cuda_lanes

    def knn_cuda_lanes(queries, targets, t_mask, *args, **kwargs):
        if queries.shape[0] * queries.shape[1] > 0:
            noted.append((queries.shape[0], queries.shape[1],
                          targets.shape[1]))
        return real(queries, targets, t_mask, *args, **kwargs)

    K.knn_cuda_lanes = knn_cuda_lanes
    try:
        yield
    finally:
        K.knn_cuda_lanes = real


def read(ctx):
    launches = ctx.observed.get("knn_roofline", [])
    runs = [e - s for name, s, e in ctx.slice.device_ops
            if "knn5_kernel" in name]
    if not launches or len(runs) != len(launches) or sum(runs) <= 0:
        return None
    return 100.0 * sum(R.knn_bound_s(*l) for l in launches) / sum(runs)
