"""Command-line interface of the PyTorch port — the roslaunch-file
equivalents, with the JAX package's subcommands, arguments and JSON
output keys:

  python -m vil_sensor_fusion_tpu_torch.cli run --scenario town --duration 4
      run the full VIL system on a synthetic scenario, print metrics
      (replaces fusion_carla.launch replay)
  python -m vil_sensor_fusion_tpu_torch.cli run --bag X.bag
      replay a RAW-SENSOR bag (IMU + PointCloud2 + Image) through the FULL
      stack: organize → LiDAR odometry, images → tracker → EKF, gate,
      fusion (gtsam_fusion/launch/fusion_carla.launch:13-97)
  python -m vil_sensor_fusion_tpu_torch.cli record --scenario town --out X.bag
      render a scenario's raw sensors and record them to a bag
      (replaces the Carla recording pipeline, carla_ros_bridge.launch)
  python -m vil_sensor_fusion_tpu_torch.cli fuse-bag --bag X.bag --config c.yaml
      run the fusion back-end on a recorded bag's odometry+IMU topics
      (replaces gtsam_fusion_node on a bag)
  python -m vil_sensor_fusion_tpu_torch.cli convert --bag X.bag --out X.npz
      decode a bag's topics to arrays once (replaces rosbag play)
  python -m vil_sensor_fusion_tpu_torch.cli fix-time --bag X.bag --out Y.bag
      rewrite record times := header stamps
  python -m vil_sensor_fusion_tpu_torch.cli experiments --smoke
      the degeneracy-experiment grid with per-run reports
  python -m vil_sensor_fusion_tpu_torch.cli bench
      full-pipeline throughput at the reference rig, 8 distinct sequences
      as lanes (``bench.py`` of this package; one JSON line on stdout)

``--device`` (default ``cuda``) names the device the subcommands that
compute run on; ``--device cpu`` runs them on the host.

``run --model-devices N`` spreads one sequence's scan-to-map ICP over N
ranks (``parallel.ops.make_sharded_register``); N > 1 needs a
``torch.distributed`` world of N processes, one card each:

  torchrun --nproc-per-node N -m vil_sensor_fusion_tpu_torch.cli run \
      --model-devices N ...

Every rank runs the whole command; rank 0 alone prints the JSON and
writes the checkpoint.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def _bag_rig(width=160, height=120, num_landmarks=16):
    """The default camera rig for raw-bag runs without a --config: a small
    forward camera with real mounting extrinsics (the image-driven tracker
    path is resolution-agnostic; 160×120 keeps ad-hoc CLI runs fast). Use
    `--config configs/carla_full.yaml` for the reference's 800×600 rig."""
    from .frontends import vio as V
    from .frontends.vio import frontend as F

    cam = V.camera.Camera(fx=107.0, fy=107.0, cx=width / 2.0,
                          cy=height / 2.0, width=width, height=height)
    # A config value: Python floats of the float32 mounting.
    pose_ic = tuple(float(v) for v in F.forward_camera_extrinsics(
        torch.float32, device="cpu"))
    vio_cfg = V.VioConfig(num_landmarks=num_landmarks, update_iters=2,
                          cam=cam, pose_ic=pose_ic)
    fe_cfg = F.FrontendConfig(cam=cam, n_candidates=32, min_dist=10.0,
                              min_score=0.5)
    return vio_cfg, fe_cfg


def _resolve_run_config(args, default_rig=None):
    """(VilConfig, FrontendConfig) for `cli run`: from --config YAML when
    given (the full per-dataset config surface, reference
    gtsam_fusion/config/<dataset>/), else built-in defaults."""
    from . import fusion as fu
    from . import graph as G
    from .degeneracy import gate as DG
    from .frontends import lidar as L
    from .fusion import vil

    if args.config:
        from . import config as C

        sys_cfg = C.load(args.config)
        return sys_cfg.vil(), sys_cfg.frontend
    vio_cfg, fe_cfg = default_rig or _bag_rig()
    cfg = vil.VilConfig(
        vio=vio_cfg,
        lidar=L.LidarOdomConfig(
            icp=L.IcpConfig(iters=4, degen_eigval=5.0),
            odom_icp=L.IcpConfig(iters=5, max_corr_dist=2.0,
                                 degen_eigval=5.0),
            guess_is_delta=True),
        gate=DG.GateConfig(rot_threshold=4.0, trans_threshold=-6.0,
                           normalize_per_corr=True),
        fusion=fu.FusionConfig(
            smoother=G.SmootherConfig(window=6, between_slots=12, gn_iters=4),
            sensors=vil.VilConfig().fusion.sensors, max_imu_per_gap=32),
    )
    return cfg, fe_cfg


def _model_mesh(args):
    """The mesh for ``--model-devices N`` (one sequence's ICP over N ranks),
    or None for N = 1. N > 1 needs a world of exactly N processes: one a
    caller started, or torchrun's (``env://``)."""
    n = args.model_devices
    if n <= 1:
        return None
    import torch.distributed as dist

    from .parallel import mesh as PM

    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        dist.init_process_group(PM.backend_for(args.device),
                                init_method="env://")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise RuntimeError(
            f"--model-devices {n} needs a torch.distributed world of {n} "
            f"processes, one per device; this one has {world}. Launch it "
            f"with torchrun --nproc-per-node {n} -m "
            f"vil_sensor_fusion_tpu_torch.cli run --model-devices {n} ...")
    return PM.make_mesh(n_data=1, n_model=n, devices=args.device)


def _writes(mesh) -> bool:
    """Whether this process prints and saves: rank 0 of a mesh's world."""
    import torch.distributed as dist

    return mesh is None or dist.get_rank() == 0


def _gate_numbers(res) -> dict:
    keep = res.gate.keep.cpu().numpy()
    valid = res.gate.valid.cpu().numpy() > 0
    return {
        "gate_keep_fraction": float(np.mean(keep)),
        # Mean over valid scores (gate.valid masks the map-seeding first
        # sweep's empty Hessian).
        "lidar_trans_logdet_mean": float(np.mean(
            res.gate.trans_d_opt.cpu().numpy()[valid])),
        "healthy_fraction": float(np.mean(res.fused.healthy.cpu().numpy())),
    }


def _save_checkpoint(args, es, out: dict) -> None:
    if args.checkpoint:
        from . import utils as U

        U.save(args.checkpoint, es)
        out["checkpoint"] = args.checkpoint


def cmd_record(args):
    from .data import scenarios

    vio_cfg, fe_cfg = _bag_rig()
    sc = scenarios.build(args.scenario, duration=args.duration,
                         vio_cfg=vio_cfg, dtype=torch.float32,
                         device=args.device, vio_from_images=True,
                         frontend_cfg=fe_cfg, seed=args.seed)
    scenarios.write_scenario_bag(args.out, sc,
                                 compression=args.compression,
                                 gt_topic="/gt/odometry")
    print(json.dumps({
        "bag": args.out, "bytes": os.path.getsize(args.out),
        "imu_msgs": int(len(sc.imu_times)),
        "lidar_msgs": int(len(sc.lidar_times)),
        "image_msgs": int(len(sc.vio_times)),
    }, indent=2))


def _run_bag(args, mesh):
    from .fusion import vil

    cfg, fe_cfg = _resolve_run_config(args)
    es, res, ba = vil.run_vil_from_bag(
        args.bag, cfg=cfg, fe_cfg=fe_cfg,
        topics=dict(gt_topic="/gt/odometry"), device=args.device, mesh=mesh)
    if not _writes(mesh):
        return
    out = {"bag": args.bag, "events": int(res.timeline.times.shape[0])}
    out.update(_gate_numbers(res))
    _save_checkpoint(args, es, out)
    if ba.gt_poses is not None and len(ba.gt_poses):
        fused_t = res.fused.times.cpu().numpy()
        fused_p = res.fused.poses.cpu().numpy()
        idx = np.clip(np.searchsorted(ba.gt_times, fused_t),
                      0, len(ba.gt_times) - 1)
        err = np.linalg.norm(fused_p[:, 4:7] - ba.gt_poses[idx][:, 4:7],
                             axis=1)
        out["fused_ate_rmse_m"] = float(np.sqrt((err ** 2).mean()))
    print(json.dumps(out, indent=2))


def cmd_run(args):
    mesh = _model_mesh(args)
    if args.bag:
        return _run_bag(args, mesh)

    from torch.func import vmap

    from . import eval as ev
    from . import fusion as fu
    from .data import scenarios
    from .frontends import lidar as L
    from .frontends import vio as V
    from .fusion import vil

    dtype, device = torch.float32, torch.device(args.device)
    default_vio = V.VioConfig(num_landmarks=24, update_iters=2)
    cfg, _ = _resolve_run_config(args, default_rig=(default_vio, None))
    sc = scenarios.build(args.scenario, duration=args.duration,
                         vio_cfg=cfg.vio, dtype=dtype, device=device)
    t0 = torch.zeros((), dtype=dtype, device=device)
    pose0 = sc.traj.pose_fn(t0)
    vel0 = sc.traj.vel_fn(t0)
    zeros6 = torch.zeros(6, dtype=dtype, device=device)
    es, res = vil.run_vil(
        cfg, sc.imu_times, sc.imu_accel, sc.imu_gyro,
        sc.vio_times, sc.vio_frames, V.init(cfg.vio, pose0, vel0, zeros6),
        sc.lidar_times, sc.sweeps,
        L.odometry.init(cfg.lidar, dtype, pose0=pose0),
        lidar_guess_from_vio_idx=sc.lidar_guess_idx,
        engine_state=fu.init(cfg.fusion, pose0, vel0, zeros6, t0),
        mesh=mesh,
    )
    if not _writes(mesh):
        return
    gt = vmap(sc.traj.pose_fn)(res.timeline.times)
    out = {
        "scenario": args.scenario,
        "events": int(res.timeline.times.shape[0]),
        "fused_ate_rmse_m": float(ev.ate_rmse(res.fused.poses, gt)),
    }
    out.update(_gate_numbers(res))
    _save_checkpoint(args, es, out)
    print(json.dumps(out, indent=2))


def cmd_convert(args):
    from .data.rosbag_io import BagReader

    with BagReader(args.bag) as bag:
        arrays = {}
        meta = {}
        for topic, typ in bag.topics().items():
            key = topic.strip("/").replace("/", "_")
            if typ == "sensor_msgs/Imu":
                t, a, g = bag.read_imu(topic)
                arrays[f"{key}_t"] = t
                arrays[f"{key}_accel"] = a
                arrays[f"{key}_gyro"] = g
            elif typ == "nav_msgs/Odometry":
                t, p, pc, tc = bag.read_odometry(topic)
                arrays[f"{key}_t"] = t
                arrays[f"{key}_pose"] = p
                arrays[f"{key}_pose_cov"] = pc
                arrays[f"{key}_twist_cov"] = tc
            meta[topic] = typ
        np.savez_compressed(args.out, **arrays)
        print(json.dumps({"topics": meta, "out": args.out}, indent=2))


def cmd_fix_time(args):
    """fix_rosbag_time equivalent (carla_tools/scripts/fix_rosbag_time.py:
    28-47): record time := header stamp, payloads verbatim."""
    from .data.bagtools import fix_bag_time

    report = fix_bag_time(args.bag, args.out, compression=args.compression)
    print(json.dumps(report, indent=2))


def cmd_fuse_bag(args):
    from . import config as C
    from . import convert
    from . import fusion as fu
    from .core import lie
    from .data.rosbag_io import BagReader

    sys_cfg = C.load(args.config)
    dtype, device = torch.float32, torch.device(args.device)
    with BagReader(args.bag) as bag:
        imu_t, accel, gyro = bag.read_imu(sys_cfg.imu_topic)
        sources = []
        for name in sys_cfg.sensor_topics:
            t, p, pc, tc = bag.read_odometry(sys_cfg.sensor_topics[name])
            # Both channels ride the timeline; the engine selects per the
            # spec (use_odom_covariance → twist, SensorManagerRos.cpp:84-99).
            sources.append((t, p, pc, np.ones(len(t)), tc))
    tl = convert.to_torch(fu.merge_timeline(sources), device, dtype)
    tensor = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    es = fu.init(sys_cfg.fusion, tl.odo_pose[0],
                 torch.zeros(3, dtype=dtype, device=device),
                 torch.zeros(6, dtype=dtype, device=device),
                 tensor(float(tl.times[0]) - 1e-3))
    if args.resume_from:
        from . import utils as U

        es = U.restore(args.resume_from, es)
    es, out = fu.run(sys_cfg.fusion, es, tl, tensor(imu_t), tensor(accel),
                     tensor(gyro))
    res = torch.cat([out.times[:, None], lie.pose_trans(out.poses)],
                    dim=1).cpu().numpy().astype(np.float64)
    if args.out:
        np.savetxt(args.out, res, header="t x y z")
    print(json.dumps({"events": int(res.shape[0]),
                      "t_range": [float(res[0, 0]), float(res[-1, 0])]}))


def cmd_experiments(args):
    from .eval import experiments as EX

    grid = EX.smoke_grid if args.smoke else EX.default_grid
    duration = args.duration if args.duration is not None else (
        3.0 if args.smoke else 60.0)
    specs = grid(seeds=tuple(range(args.seeds)), duration=duration)
    if args.long_row:
        # One reference-length labeled drive (the 5:45 bag shape,
        # sample_bags/README.md) joins the grid so the aggregate ROC/ATE
        # carries a reference-duration row.
        specs = list(specs) + [EX.ExperimentSpec(kind="tunnel",
                                                 duration=args.long_row,
                                                 seed=0)]
    summaries = EX.run_and_report(specs, args.cache_dir, args.report_dir,
                                  device=args.device)
    print(json.dumps(summaries, indent=2))


def cmd_bench(args):
    from . import bench

    bench.main(lanes=args.lanes, duration=args.duration, reps=args.reps,
               device=args.device)


def _device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="vil_sensor_fusion_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser(
        "run", help="run full VIL on a synthetic scenario or a raw bag")
    pr.add_argument("--scenario", default="town",
                    choices=["town", "corridor", "tunnel", "arena"])
    pr.add_argument("--duration", type=float, default=4.0)
    pr.add_argument("--bag", default="",
                    help="raw-sensor bag to replay through the full stack")
    pr.add_argument("--checkpoint", default="",
                    help="save the final engine state (npz) for resume")
    pr.add_argument("--config", default="",
                    help="system YAML (configs/carla_full.yaml): camera/"
                         "vio/frontend/lidar/filter/sensors/smoother")
    pr.add_argument("--model-devices", type=int, default=1,
                    help="spread one sequence's ICP registration over N "
                         "devices; N > 1 runs under torchrun "
                         "--nproc-per-node N")
    _device_arg(pr)
    pr.set_defaults(fn=cmd_run)

    pg = sub.add_parser(
        "record", help="render a scenario's raw sensors into a bag")
    pg.add_argument("--scenario", default="town",
                    choices=["town", "corridor", "tunnel", "arena"])
    pg.add_argument("--duration", type=float, default=2.0)
    pg.add_argument("--seed", type=int, default=0)
    pg.add_argument("--compression", default="bz2",
                    choices=["none", "bz2"])
    pg.add_argument("--out", required=True)
    _device_arg(pg)
    pg.set_defaults(fn=cmd_record)

    pc = sub.add_parser("convert", help="decode a rosbag to npz arrays")
    pc.add_argument("--bag", required=True)
    pc.add_argument("--out", required=True)
    pc.set_defaults(fn=cmd_convert)

    px = sub.add_parser(
        "fix-time",
        help="rewrite record times := header stamps (the reference's "
             "fix_rosbag_time.py for externally recorded bags)")
    px.add_argument("--bag", required=True)
    px.add_argument("--out", required=True)
    px.add_argument("--compression", default="none",
                    choices=["none", "bz2"])
    px.set_defaults(fn=cmd_fix_time)

    pf = sub.add_parser("fuse-bag", help="fusion back-end over a bag")
    pf.add_argument("--bag", required=True)
    pf.add_argument("--config", required=True)
    pf.add_argument("--out", default="")
    pf.add_argument("--resume-from", default="",
                    help="restore a checkpointed engine state before fusing")
    _device_arg(pf)
    pf.set_defaults(fn=cmd_fuse_bag)

    pb = sub.add_parser("bench", help="per-chip full-pipeline throughput "
                                      "over distinct sequences as lanes")
    pb.add_argument("--lanes", type=int, default=8,
                    help="distinct town sequences batched as lanes")
    pb.add_argument("--duration", type=float, default=4.0,
                    help="seconds per sequence")
    pb.add_argument("--reps", type=int, default=3,
                    help="timed passes after the warm one")
    _device_arg(pb)
    pb.set_defaults(fn=cmd_bench)

    pe = sub.add_parser(
        "experiments",
        help="batch {tunnel,field} x seeds grid (reference-shaped "
             "mid-drive degeneracy, >=60 s cells) with cached results and "
             "per-run reports; --smoke for the fast 3 s "
             "{town,corridor,tunnel,arena} tier")
    pe.add_argument("--seeds", type=int, default=2)
    pe.add_argument("--duration", type=float, default=None,
                    help="seconds per cell (default 60; 3 with --smoke)")
    pe.add_argument("--smoke", action="store_true",
                    help="fast smoke grid (3 s cells, all scenario kinds)")
    pe.add_argument("--long-row", type=float, default=None, metavar="SECS",
                    help="append one reference-length tunnel drive "
                         "(e.g. 345 for the 5:45 bag shape)")
    pe.add_argument("--cache-dir", default="experiment_cache")
    pe.add_argument("--report-dir", default="experiment_reports")
    _device_arg(pe)
    pe.set_defaults(fn=cmd_experiments)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
