"""The k-NN roofline arithmetic reproduces the bound column of PERF.md's
kernel table, and the reader finds each launch's shapes in a slice."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from vilbench.metrics import _roofline as R
from vilbench.metrics import knn_roofline


@pytest.mark.parametrize("shape, bound_us", [
    ((192, 1920), 0.044), ((384, 3984), 0.183), ((1920, 2048), 0.470),
    ((3984, 4096), 1.948)])
def test_bound_matches_the_kernel_table(shape, bound_us):
    assert round(R.knn_bound_s(1, *shape) * 1e6, 3) == bound_us
    # f32 operations bound these shapes, not bytes.
    assert R.knn_flops(1, *shape) / R.F32_FLOPS > (
        R.knn_bytes(1, *shape) / R.HBM_BYTES)


def test_lanes_scale_the_bound():
    assert R.knn_bound_s(8, 384, 3984) == pytest.approx(
        8 * R.knn_bound_s(1, 384, 3984))


def test_observer_notes_each_launch_and_puts_the_entry_back():
    from vil_sensor_fusion_tpu_torch.ops import knn as K

    real = K.knn_cuda_lanes
    noted = []
    with knn_roofline.observe(noted):
        assert K.knn_cuda_lanes is not real
        with pytest.raises(ValueError):          # CPU tensors: no kernel
            K.knn_cuda_lanes(torch.zeros(8, 384, 3), torch.zeros(8, 3984, 3),
                             torch.ones(8, 3984))
    assert K.knn_cuda_lanes is real
    assert noted == [(8, 384, 3984)]


def test_reader_divides_the_bound_by_the_kernels_device_time():
    launches = [(8, 384, 3984), (1, 192, 1920)]
    bound = sum(R.knn_bound_s(*l) for l in launches)
    dev = [("void knn5_kernel<2>(...)", 2.0, 2.0 + bound),
           ("void knn5_kernel<1>(...)", 5.0, 5.0 + bound),
           ("elementwise", 3.0, 4.0)]
    ctx = SimpleNamespace(observed={"knn_roofline": launches},
                          slice=SimpleNamespace(device_ops=dev))
    assert knn_roofline.read(ctx) == pytest.approx(50.0)
    # Launches noted and kernels run must agree in number.
    ctx.observed["knn_roofline"] = launches[:1]
    assert knn_roofline.read(ctx) is None


def test_reader_finds_nothing_without_a_launch():
    ctx = SimpleNamespace(observed={}, slice=SimpleNamespace(device_ops=[]))
    assert knn_roofline.read(ctx) is None
