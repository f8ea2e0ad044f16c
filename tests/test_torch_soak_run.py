"""The port's soak end to end on the CPU (``soak.run_soak`` and its
``main``), at the soak's full LiDAR maps and a 160×120 camera with 8
landmarks: 1 s in two 0.5 s chunks with the checkpoint test (the first
chunk, then the second from the carried state and again from the
checkpoint restored into a fresh template), float32 as on the card.

The bounds are ``chip_smoke.py`` phase 12's: the JAX test's
(tests/test_soak.py) for drift, health, maps and resume, but a gate keep
share above 0.5, not its 0.9 over 20 s: the first sweeps of a drive are
gated more often (0.80 kept in the first 0.5 s, JAX and port alike). The
port's chunk handoff is held against JAX's stage functions in
``test_torch_soak.py``; the photometric VIO against JAX's in
``test_torch_photometric.py``, so the photometric soak here is checked
for its properties only."""

import numpy as np
import pytest
import torch

from vil_sensor_fusion_tpu_torch import soak as S
from vil_sensor_fusion_tpu_torch.ops import knn as K

KNN_PER_SWEEP = 14     # (8 odometry + 6 mapping iterations) / fit_every 2 × 2


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("photometric", [False, True],
                         ids=["geometric", "photometric"])
def test_run_soak_resumes_exactly_on_the_cpu(tmp_path, monkeypatch,
                                             photometric):
    calls = []
    knn = K.knn

    def counted(*a, **kw):
        calls.append(a[0].shape[0])
        return knn(*a, **kw)
    monkeypatch.setattr(K, "knn", counted)
    summary, metrics = S.run_soak(
        duration=1.0, chunk=0.5, cam_w=160, cam_h=120, landmarks=8,
        checkpoint_test=True, checkpoint_dir=str(tmp_path), verbose=False,
        photometric=photometric, device="cpu")
    assert summary["platform"] == "cpu"
    assert summary["vio_mode"] == ("photometric" if photometric
                                   else "geometric")
    assert summary["chunks"] == 2 and len(metrics) == 2
    assert (tmp_path / "soak.npz").exists()
    # Checkpoint -> resume reproduces the uninterrupted run exactly.
    assert summary["resume_max_delta"] == 0.0
    assert summary["err_max_m"] < 0.05 * summary["distance_m"], summary
    assert summary["healthy_mean"] > 0.95
    assert summary["keep_mean"] > 0.5
    assert 1000 < summary["map_surf_final"] <= 65536
    assert 0 < summary["map_corner_final"] <= 32768
    assert summary["err_max_last_chunk_m"] <= summary["err_max_m"] + 1e-6
    assert all(np.isfinite(m["last_pose"]).all() for m in metrics)
    # 3 chunk runs of 5 sweeps, 14 searches per sweep, none on a card.
    assert len(calls) == 3 * 5 * KNN_PER_SWEEP
    assert K.KERNEL_LAUNCHES == 0 or not torch.cuda.is_available()


def test_main_passes_its_flags(monkeypatch, capsys):
    """``main`` maps every flag onto ``run_soak`` and prints the summary;
    ``--device`` defaults to the card."""
    seen = {}

    def fake(**kw):
        seen.update(kw)
        return {"platform": "cpu"}, []
    monkeypatch.setattr(S, "run_soak", fake)
    S.main(["--duration", "3", "--chunk", "1.5", "--cam", "320x240",
            "--landmarks", "12", "--checkpoint-test", "--vio-odom-cov",
            "--vio-twist-cov", "--vio-cov", "0.2", "--lidar-cov", "0.1",
            "--no-gravity", "--no-zuv", "--photometric", "--lidar-anchor",
            "--anchor-scale", "5", "--device", "cpu"])
    assert seen == dict(
        duration=3.0, chunk=1.5, cam_w=320, cam_h=240, landmarks=12,
        checkpoint_test=True, vio_use_odom_cov=True, vio_twist_cov=True,
        vio_cov=0.2, lidar_cov=0.1, gravity_update=False, zuv_update=False,
        lidar_anchor=True, anchor_scale=5.0, photometric=True, device="cpu")
    assert '"platform": "cpu"' in capsys.readouterr().out
    S.main([])
    assert seen["device"] == "cuda" and seen["duration"] == 60.0


def test_run_soak_runs_on_the_card_by_default():
    """No device: the card; without one it raises, never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks a host without one")
    with pytest.raises(RuntimeError, match="CUDA card"):
        S.run_soak(duration=0.5, chunk=0.5, cam_w=160, cam_h=120,
                   landmarks=8, verbose=False)
