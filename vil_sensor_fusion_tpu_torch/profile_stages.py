"""Per-stage profile at the bench's shapes, on random inputs: every sub-op
of the VIL pipeline timed on its own, to find where each bench stage's
milliseconds go. The port's counterpart of the repository's
``scripts/profile_stages.py``, with its sections, rows and row names.

    python -m vil_sensor_fusion_tpu_torch.profile_stages [--res 400x300]
        [--frames 80] [--sweeps 40] [--only frontend,lidar,fusion]
        [--device cuda]

Each row is :func:`bench`: one first call (its seconds; nothing is
compiled, so this is the eager first call), then the mean of ``reps``
calls ending in one sync (host clock). The control flow of every row is
fixed by the shapes, and the few host branches there are (the fusion
engine's per event, by ``Timeline.source``) follow inputs drawn as the JAX
script draws them, from ``numpy.random.default_rng(0)`` in the same order;
the map inserts run into full maps, as there. The ``(vmap T)`` rows map the
single-frame function with ``torch.func.vmap`` (each of them maps with no
batching-rule fallback), the ``knn`` rows go through ``ops.knn.knn`` (on a
card the CUDA kernel, built before the first row). Output: the JAX
script's lines on stdout; :func:`run` returns ``{row: {"ms",
"first_call_s", "knn_launches"}}`` (the kernel's launches over the row's
calls; 0 on the CPU).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from . import fusion as fu
from . import graph as G
from ._linspace import linspace0
from .core import lie
from .frontends import lidar as L
from .frontends import vio as V
from .frontends.lidar import features as feat
from .frontends.lidar import icp as I
from .frontends.lidar import rangeimage as RI
from .frontends.lidar import voxelmap as vm
from .frontends.vio import camera as C
from .frontends.vio import frontend as F
from .frontends.vio import tracker as T
from .fusion import engine as E
from .fusion import vil
from .ops import eig3 as E3
from .ops import knn as K
from .soak import require_device
from .utils.tracing import block_until_ready as ready

REPS = 10


def bench(name: str, fn, *args, reps: int = REPS) -> dict:
    """Time ``fn(*args)``: the first call, then the mean of ``reps`` calls
    ending in one sync. Prints the row; returns its numbers."""
    n0 = K.KERNEL_LAUNCHES
    t0 = time.perf_counter()
    r = ready(fn(*args))
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        r = fn(*args)
    ready(r)
    dt = (time.perf_counter() - t0) / reps
    print(f"{name:42s} {dt*1e3:9.3f} ms   (first call {first_s:.1f}s)",
          flush=True)
    return {"ms": dt * 1e3, "first_call_s": first_s,
            "knn_launches": K.KERNEL_LAUNCHES - n0}


def lidar_config() -> L.LidarOdomConfig:
    """The LiDAR rows' configuration: two-stage ICP, 6 map iterations."""
    return L.LidarOdomConfig(icp=I.IcpConfig(iters=6, degen_eigval=5.0),
                             two_stage=True)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m vil_sensor_fusion_tpu_torch.profile_stages",
        description="Per-stage profile at the bench's shapes.")
    ap.add_argument("--res", default="400x300")
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--sweeps", type=int, default=40)
    ap.add_argument("--only", default="",
                    help="comma-separated sections: frontend, lidar, fusion")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, reps: int = REPS) -> dict:
    """Every row of the chosen sections on ``args.device``."""
    dev = require_device(args.device, "the stage profile")
    W, H = map(int, args.res.split("x"))
    Tn, Tl = args.frames, args.sweeps
    dtype = torch.float32
    rng = np.random.default_rng(0)
    print(f"platform={dev.type} res={W}x{H} frames={Tn} sweeps={Tl}",
          flush=True)
    if dev.type == "cuda":
        K.build_kernel()
    rows = {}

    def row(name, fn, *a):
        rows[name] = bench(name, fn, *a, reps=reps)

    def do(sec):
        return (not args.only) or (sec in args.only.split(","))

    def t(x, dt=dtype):
        return torch.as_tensor(x, dtype=dt, device=dev)

    # ---------------- frontend shapes ----------------
    images = t(rng.random((Tn, H, W)))
    P = (RI.RINGS * RI.AZIMUTH) // 4
    pts_cam = t(rng.uniform(-30, 30, (Tn, P, 3)))
    pts_cam[..., 2] = torch.abs(pts_cam[..., 2]) + 1.0
    pv = torch.ones((Tn, P), dtype=dtype, device=dev)
    cam = C.Camera(fx=214.0 * W / 400, fy=214.0 * W / 400,
                   cx=W / 2.0, cy=H / 2.0, width=W, height=H)
    fe_cfg = F.FrontendConfig(cam=cam, n_candidates=64, min_dist=16.0,
                              min_score=0.5)
    M = 24
    imu_w = (torch.zeros((Tn, 16, 3), dtype=dtype, device=dev),
             torch.zeros((Tn, 16, 3), dtype=dtype, device=dev),
             torch.full((Tn, 16), 0.003, dtype=dtype, device=dev))
    vmap = torch.func.vmap

    if do("frontend"):
        print("--- frontend ---", flush=True)
        row("pyramid (vmap T)",
            vmap(lambda x: tuple(T.pyramid(x, 3))), images)
        row("shi_tomasi score (vmap T)", vmap(T.shi_tomasi), images)
        row("detect full (vmap T)",
            vmap(lambda x: T.detect(x, 64, nms_radius=8, border=12)),
            images)
        q64 = torch.full((64, 2), 50.0, dtype=dtype, device=dev)
        row("project_sweep+depth_at 64q (vmap T)",
            vmap(lambda a, b: F.depth_at(
                fe_cfg, F.project_sweep(fe_cfg, a, b), q64)), pts_cam, pv)
        uv = t(rng.uniform(20, min(W, H) - 20, (M, 2)))
        valid = torch.ones((M,), dtype=dtype, device=dev)
        pyr_a = [t(rng.random((H // (2**lv), W // (2**lv))))
                 for lv in range(3)]
        pyr_b = [t(rng.random((H // (2**lv), W // (2**lv))))
                 for lv in range(3)]
        row("klt_track 1 frame (24 slots)",
            lambda a0, a1, a2, b0, b1, b2, u, v: T.klt_track(
                [a0, a1, a2], [b0, b1, b2], u, v, radius=4, iters=8),
            *pyr_a, *pyr_b, uv, valid)
        row("build_frames FULL (two-program)",
            lambda im, p, v: F.build_frames(fe_cfg, im, p, v, imu_w, M),
            images, pts_cam, pv)

    # ---------------- lidar shapes ----------------
    sw_xyz = rng.uniform(-40, 40, (RI.RINGS, RI.AZIMUTH, 3))
    sweep = RI.Sweep(xyz=t(sw_xyz), rng=t(np.linalg.norm(sw_xyz, axis=-1)),
                     mask=torch.ones((RI.RINGS, RI.AZIMUTH), dtype=dtype,
                                     device=dev))
    cfg = lidar_config()
    state = L.odometry.init(cfg, dtype, device=dev)
    # Full maps.
    mc = vm.VoxelMap(points=t(rng.uniform(-60, 60, (32768, 3))),
                     mask=torch.ones((32768,), dtype=dtype, device=dev))
    ms = vm.VoxelMap(points=t(rng.uniform(-60, 60, (65536, 3))),
                     mask=torch.ones((65536,), dtype=dtype, device=dev))
    state = state._replace(corner_map=mc, surf_map=ms,
                           initialized=torch.ones((), dtype=dtype,
                                                  device=dev))
    center = torch.zeros((3,), dtype=dtype, device=dev)
    pose = lie.pose_identity(dtype, dev)

    nc, ns = feat.pool_sizes(RI.RINGS, RI.AZIMUTH)
    q_c = t(rng.uniform(-40, 40, (nc, 3)))
    q_s = t(rng.uniform(-40, 40, (ns, 3)))
    m_c = torch.ones((nc,), dtype=dtype, device=dev)
    m_s = torch.ones((ns,), dtype=dtype, device=dev)
    sub_c = vm.VoxelMap(points=t(rng.uniform(-40, 40, (4096, 3))),
                        mask=torch.ones((4096,), dtype=dtype, device=dev))
    sub_s = vm.VoxelMap(points=t(rng.uniform(-40, 40, (8192, 3))),
                        mask=torch.ones((8192,), dtype=dtype, device=dev))

    if do("lidar"):
        print("--- lidar ---", flush=True)
        row("feat.extract", feat.extract, sweep)
        d6 = torch.full((6,), 0.01, dtype=dtype, device=dev)
        row("undistort", lambda s: RI.undistort(s, d6), sweep)
        row("submap corner 32k->4096",
            lambda m: vm.submap(m, center, 4096, 100.0), mc)
        row("submap surf 64k->8192",
            lambda m: vm.submap(m, center, 8192, 100.0), ms)
        row("insert corner (+1920)",
            lambda m: vm.insert(m, q_c[:1920], m_c[:1920], center,
                                cfg.corner_map), mc)
        row("insert surf (+3984)",
            lambda m: vm.insert(m, q_s, m_s, center, cfg.surf_map), ms)
        row("knn corner 1920x4096",
            lambda q, tg, tm: K.knn(q, tg, tm, 5), q_c, sub_c.points,
            sub_c.mask)
        row("knn surf 3984x8192",
            lambda q, tg, tm: K.knn(q, tg, tm, 5), q_s, sub_s.points,
            sub_s.mask)
        covs = t(rng.random((ns, 3, 3)))
        covs = covs + covs.transpose(-1, -2)
        row("eig3 batch (3984)", E3.eigh3, covs)
        row("register 6 iters (map stage)",
            lambda p: I.register(p, q_c, m_c, q_s, m_s, sub_c.points,
                                 sub_c.mask, sub_s.points, sub_s.mask,
                                 cfg.icp), pose)
        row("register 8 iters (odom stage)",
            lambda p: I.register(p, q_c[:1920], m_c[:1920], q_s[:3984],
                                 m_s[:3984], q_c[:1920], m_c[:1920],
                                 q_s[:3984], m_s[:3984], cfg.odom_icp),
            pose)
        row("odometry.step FULL (two_stage)",
            lambda st, sw, g: L.odometry.step(cfg, st, sw, g),
            state, sweep, pose)
        cfg1 = cfg._replace(two_stage=False)
        row("odometry.step FULL (single)",
            lambda st, sw, g: L.odometry.step(cfg1, st, sw, g),
            state, sweep, pose)

    if do("fusion"):
        print("--- fusion+vio ---", flush=True)
        fcfg = fu.FusionConfig(
            smoother=G.SmootherConfig(window=6, between_slots=12,
                                      gn_iters=4),
            sensors=vil.VilConfig().fusion.sensors, max_imu_per_gap=32)
        Ev = Tn + Tl
        t_all = torch.sort(t(rng.uniform(0, 4.0, (Ev,)))).values
        eye6 = torch.eye(6, dtype=dtype, device=dev) * 0.1
        tl = E.Timeline(
            times=t_all,
            source=t(rng.integers(0, 2, (Ev,)), torch.int32),
            odo_pose=lie.pose_identity(dtype, dev).expand(Ev, 7),
            odo_cov=eye6.expand(Ev, 6, 6),
            keep=torch.ones((Ev,), dtype=dtype, device=dev),
            valid=torch.ones((Ev,), dtype=dtype, device=dev),
            odo_twist_cov=eye6.expand(Ev, 6, 6))
        zeros3 = torch.zeros(3, dtype=dtype, device=dev)
        zeros6 = torch.zeros(6, dtype=dtype, device=dev)
        es0 = fu.init(fcfg, lie.pose_identity(dtype, dev), zeros3, zeros6,
                      torch.tensor(-1e-3, dtype=dtype, device=dev))
        n_imu = 800
        imu_t = linspace0(4.0, n_imu, dtype, dev)
        imu_a = torch.zeros((n_imu, 3), dtype=dtype, device=dev)
        imu_a[:, 2] = 9.81
        imu_g = torch.zeros((n_imu, 3), dtype=dtype, device=dev)
        row(f"engine.run ({Ev} events)",
            lambda e, tt: E.run(fcfg, e, tt, imu_t, imu_a, imu_g), es0, tl)

        pose_ic = tuple(float(v) for v in
                        F.forward_camera_extrinsics(dtype, device="cpu"))
        vio_cfg = V.VioConfig(num_landmarks=M, update_iters=2, cam=cam,
                              pose_ic=pose_ic)
        vs0 = V.init(vio_cfg, lie.pose_identity(dtype, dev), zeros3, zeros6)
        frames = V.pipeline.VioFrameInput(
            accel=imu_w[0], gyro=imu_w[1], dts=imu_w[2],
            obs_uv=t(rng.uniform(20, 200, (Tn, M, 2))),
            obs_valid=torch.ones((Tn, M), dtype=dtype, device=dev),
            obs_depth=torch.zeros((Tn, M), dtype=dtype, device=dev),
            new_uv=torch.zeros((Tn, M, 2), dtype=dtype, device=dev),
            new_depth=torch.ones((Tn, M), dtype=dtype, device=dev),
            new_enable=torch.zeros((Tn, M), dtype=dtype, device=dev))
        row(f"vio.run ({Tn} frames)",
            lambda s, f: V.run(vio_cfg, s, f), vs0, frames)

    print("done", flush=True)
    return rows


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
