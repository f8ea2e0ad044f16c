"""Aten ops per camera frame of the two VIO modes at ``configs/
carla_full.yaml``'s rig (800×600 camera, 24 landmark slots, EKF state
D = 87; photometric: 2 levels of 7×7 patches): the geometric frame
(``pipeline.step``, its ``ekf.update``) against the direct photometric one
(``photometric.step``, its ``photometric_update``), counted on the CPU in
float32 with a ``TorchDispatchMode`` (every op that reaches aten, views
included), as ``tools/lane_ops.py`` counts the fusion engine's. Neither
mode has a data-dependent host branch, so the counts do not depend on the
(seeded, synthetic) image and landmarks. Run from the root of the
repository:

    python3 tools/vio_ops.py
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from vil_sensor_fusion_tpu_torch import config as C  # noqa: E402
from vil_sensor_fusion_tpu_torch.core import lie  # noqa: E402
from vil_sensor_fusion_tpu_torch.frontends.vio import ekf as E  # noqa: E402
from vil_sensor_fusion_tpu_torch.frontends.vio import frontend as F  # noqa: E402
from vil_sensor_fusion_tpu_torch.frontends.vio import photometric as PH  # noqa: E402
from vil_sensor_fusion_tpu_torch.frontends.vio import pipeline as P  # noqa: E402
from vil_sensor_fusion_tpu_torch.frontends.vio import tracker as T  # noqa: E402

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "carla_full.yaml")


class OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def count(fn, *args) -> int:
    with OpCount() as c:
        fn(*args)
    return c.n


def main() -> int:
    sys_cfg = C.load(CONFIG)
    cfg = sys_cfg.vil().vio._replace(use_photometric=True)
    fcfg = sys_cfg.frontend
    cam = cfg.cam
    g = torch.Generator().manual_seed(0)
    M = cfg.num_landmarks
    img = torch.nn.functional.avg_pool2d(
        255.0 * torch.rand((1, cam.height + 4, cam.width + 4), generator=g),
        5, stride=1)[0]
    pyr = tuple(T.pyramid(img, fcfg.pyramid_levels))

    # Landmarks on a grid in front of the camera, 8-20 m out.
    s = E.init(cfg, lie.pose_identity(device="cpu"), torch.zeros(3),
               torch.zeros(6))
    uv = torch.stack([torch.linspace(60, cam.width - 60, M),
                      torch.linspace(60, cam.height - 60, M).flip(0)], -1)
    depth = 8.0 + 12.0 * torch.rand(M, generator=g)
    s = E.init_landmarks(cfg, s, uv, depth, 0.1, torch.ones(M, dtype=bool))
    tmpl, tok = PH.extract_templates(cfg, pyr, uv)
    ps = PH.PhotoState(ekf=s, templates=tmpl, tmpl_ok=tok,
                       fail_count=torch.zeros(M))

    n_imu = 11
    accel = torch.tensor([0.0, 0.0, 9.81]).expand(n_imu, 3).clone()
    gyro = torch.zeros((n_imu, 3))
    dts = torch.full((n_imu,), 0.005)
    cand_uv, cand_score = T.detect(img, fcfg.n_candidates,
                                   nms_radius=fcfg.nms_radius,
                                   border=fcfg.border)
    pts = torch.rand((7200, 3), generator=g) * torch.tensor([40.0, 30.0, 60.0])
    proj = F.project_sweep(fcfg, pts - torch.tensor([20.0, 15.0, 0.0]),
                           torch.ones(7200))
    cand_depth = F.depth_at(fcfg, proj, cand_uv)

    obs_uv = uv + 0.5 * torch.randn((M, 2), generator=g)
    frame = P.VioFrameInput(
        accel=accel, gyro=gyro, dts=dts, obs_uv=obs_uv,
        obs_valid=torch.ones(M), obs_depth=depth, new_uv=torch.zeros((M, 2)),
        new_depth=torch.ones(M), new_enable=torch.zeros(M))

    out = {
        "rig": f"{cam.width}x{cam.height}, {M} slots, D = {s.cov.shape[0]}, "
               f"{cfg.photo_levels} levels of {PH.patch_dim(cfg)} px",
        "geometric_step": count(P.step, cfg, s, frame),
        "geometric_update": count(E.update, cfg, s, obs_uv, frame.obs_valid,
                                  depth),
        "photometric_step": count(PH.step, cfg, fcfg, ps, pyr, cand_uv,
                                  cand_score, cand_depth, proj, accel, gyro,
                                  dts),
        "photometric_update": count(PH.photometric_update, cfg, s, pyr, tmpl,
                                    tok),
        "depth_update": count(E.depth_update, cfg, s, depth),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
