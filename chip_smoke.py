"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. Device: require CUDA; print the card's name and power limit.
2. Build the hand-written k-NN kernel (``csrc/knn.cu``) from source.
3. Kernel vs plain PyTorch (``ops.knn.knn_torch``) on the card, at the four
   k-NN shapes of the main path and at edge cases; kernel and plain times.
4. The slice: LiDAR odometry → degeneracy gate → fusion (``fusion.vil.
   run_vil``) over the 4 s ``town`` drive at the bench's operating point,
   with a noisy VIO stand-in; counts the kernel's launches, prints ATE and
   the wall time of a warm second run.
5. CPU cross-check: the first 10 sweeps and their events again with every
   tensor on the CPU (plain k-NN), compared with the card's run.

The last two lines are a JSON object describing the kernels and
``{"ok": true, "device": {...}}``. Nothing here imports JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from vil_sensor_fusion_tpu_torch import _build, _precision
from vil_sensor_fusion_tpu_torch import fusion as fu
from vil_sensor_fusion_tpu_torch import graph as G
from vil_sensor_fusion_tpu_torch.data import scenarios
from vil_sensor_fusion_tpu_torch.data import synthetic as syn
from vil_sensor_fusion_tpu_torch.degeneracy import gate as DG
from vil_sensor_fusion_tpu_torch.frontends import lidar as L
from vil_sensor_fusion_tpu_torch.frontends.lidar import voxelmap as vm
from vil_sensor_fusion_tpu_torch.fusion import vil as VIL
from vil_sensor_fusion_tpu_torch.ops import knn as K

# The four k-NN launches of one sweep (Q queries × M targets): line and
# plane fits of the scan-to-scan stage, then of the scan-to-map stage.
MAIN_PATH_SHAPES = ((192, 1920), (384, 3984), (1920, 2048), (3984, 4096))
DURATION = 4.0          # s of the town drive: 40 sweeps, 80 VIO events
CROSS_SWEEPS = 10       # sweeps rerun on the CPU
VIO_TRANS_NOISE = 0.02  # m, white noise of the VIO stand-in
VIO_ROT_NOISE = 0.002   # rad


class Failed(Exception):
    """A phase's check did not hold."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Failed(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# --------------------------------------------------------------------------
# Phase 3: kernel vs plain
# --------------------------------------------------------------------------

def _cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` back-to-back calls, CUDA events."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def time_pair(kernel, plain, rounds: int = 6, reps: int = 20):
    """Median ms of the kernel and the plain version, measured in turns
    (plain, kernel, kernel, plain, ...) after a warm-up."""
    for f in (kernel, plain):
        for _ in range(3):
            f()
    torch.cuda.synchronize()
    tk, tp = [], []
    for r in range(rounds):
        order = ((plain, tp), (kernel, tk))
        for f, acc in (order if r % 2 == 0 else order[::-1]):
            acc.append(_cuda_ms(f, reps))
    return statistics.median(tk), statistics.median(tp)


def _map_cloud(n: int, g: torch.Generator) -> torch.Tensor:
    """Points in a 40 m box about 100 m from the origin, as map
    coordinates are."""
    return torch.rand(n, 3, generator=g) * 40.0 + 100.0


def knn_cases(g: torch.Generator) -> list[tuple[str, torch.Tensor,
                                                torch.Tensor, torch.Tensor]]:
    cases = []
    for Q, M in MAIN_PATH_SHAPES:
        q, t = _map_cloud(Q, g), _map_cloud(M, g)
        m = (torch.rand(M, generator=g) > 0.05).float()
        cases.append((f"main_{Q}x{M}", q, t, m))
    q, t = _map_cloud(77, g), _map_cloud(4097, g)       # one past a tile
    cases.append(("ragged_77x4097", q, t, torch.ones(4097)))
    q, t = _map_cloud(1000, g), _map_cloud(3000, g)
    cases.append(("masked30_1000x3000", q, t,
                  (torch.rand(3000, generator=g) > 0.3).float()))
    q, t = _map_cloud(33, g), _map_cloud(16, g)
    m = torch.zeros(16)
    m[[2, 9, 11]] = 1.0
    cases.append(("three_valid_33x16", q, t, m))
    base = _map_cloud(300, g)
    t = torch.cat([base, base.flip(0), base[:50]])      # exact duplicates
    q = base[:200] + 0.05 * torch.randn(200, 3, generator=g)
    cases.append(("duplicates_200x650", q, t, torch.ones(650)))
    t = torch.full((64, 3), 101.5)                      # all targets equal
    m = torch.ones(64)
    m[[0, 2]] = 0.0
    cases.append(("all_equal_5x64", _map_cloud(5, g), t, m))
    cases.append(("single_query_1x4096", _map_cloud(1, g), _map_cloud(4096, g),
                  torch.ones(4096)))
    return cases


def kernel_vs_plain(dev: torch.device) -> dict:
    """Compare the kernel with knn_torch on the card; time the main-path
    shapes. Returns the numbers for the kernels line."""
    g = torch.Generator().manual_seed(1)
    max_err = 0.0
    times = {}
    eps = torch.finfo(torch.float32).eps
    for name, q, t, m in knn_cases(g):
        q, t, m = q.to(dev), t.to(dev), m.to(dev)
        M = t.shape[0]
        i_k, d_k = K.knn_cuda(q, t, m)
        torch.cuda.synchronize()
        # The plain version's 6th neighbour gives the gap after the 5th.
        i_p6, d_p6 = K.knn_torch(q, t, m, k=6)
        torch.cuda.synchronize()
        i_p, d_p = i_p6[:, :5], d_p6[:, :5]
        # Both sides evaluate ‖q‖² − 2q·t + ‖t‖² in f32 but sum in another
        # order, so a distance may move by a few ulps of its largest term:
        # tol = 4 ulps of max ‖q‖² + max ‖t‖² (~0.05 m² at 100 m offsets).
        tol = 4 * eps * float((q * q).sum(1).max() + (t * t).sum(1).max())
        fin = torch.isfinite(d_p)
        check(bool((torch.isfinite(d_k) == fin).all()),
              f"{name}: +inf pattern differs from the plain version")
        err = float((d_k - d_p)[fin].abs().max()) if fin.any() else 0.0
        check(err <= tol, f"{name}: dist² differs by {err} > {tol}")
        check(bool(((i_k >= 0) & (i_k < M)).all()),
              f"{name}: index outside [0, {M})")
        check(bool((d_k[:, 1:] >= d_k[:, :-1]).all()),
              f"{name}: distances not ascending")
        gaps = torch.diff(d_p6, dim=1)            # (Q, 5): d[j+1] − d[j]
        prev = torch.cat([torch.full_like(gaps[:, :1], torch.inf),
                          gaps[:, :4]], 1)
        sep = fin & (prev > tol) & (gaps > tol)
        check(bool((i_k[sep] == i_p[sep]).all()),
              f"{name}: indices differ where neighbours are separated")
        if name.startswith("all_equal"):
            want = torch.tensor([1, 3, 4, 5, 6], dtype=torch.int32,
                                device=dev).expand_as(i_k)
            check(bool((i_k == want).all()) and bool((i_p == want).all()),
                  f"{name}: ties must go to the lowest valid index")
        if name.startswith("duplicates"):
            tie = d_k[:, 1:] == d_k[:, :-1]
            check(bool((i_k[:, 1:] > i_k[:, :-1])[tie].all()),
                  f"{name}: an exact tie kept the higher index first")
        max_err = max(max_err, err)
        if name.startswith("main_"):
            t_k, t_p = time_pair(lambda: K.knn_cuda(q, t, m),
                                 lambda: K.knn_torch(q, t, m))
            times[name] = (t_k, t_p)
            print(f"  {name:22s} kernel {t_k * 1e3:9.2f} us   "
                  f"plain {t_p * 1e3:9.2f} us   max|Δd²| {err:.3g}",
                  flush=True)
        else:
            print(f"  {name:22s} ok   max|Δd²| {err:.3g}  (tol {tol:.3g})",
                  flush=True)
    # The wrapper refuses what the kernel does not take.
    q, t, m = (torch.rand(8, 3, device=dev), torch.rand(16, 3, device=dev),
               torch.ones(16, device=dev))
    for bad in (lambda: K.knn_cuda(q.double(), t.double(), m.double()),
                lambda: K.knn_cuda(q, t, m, k=4),
                lambda: K.knn_cuda(q.t().contiguous().t(), t, m),
                lambda: K.knn_cuda(q, t.cpu(), m)):
        try:
            bad()
        except (TypeError, ValueError):
            continue
        raise Failed("knn_cuda accepted an input it must refuse")
    return {"max_abs_err": max_err,
            "ms": sum(v[0] for v in times.values()),
            "plain_ms": sum(v[1] for v in times.values()),
            "per_shape_us": {k: [v[0] * 1e3, v[1] * 1e3]
                             for k, v in times.items()}}


# --------------------------------------------------------------------------
# Phase 4 and 5: the slice
# --------------------------------------------------------------------------

def main_path_config() -> VIL.VilConfig:
    """The bench's operating point (bench.py), one sequence."""
    lidar = L.LidarOdomConfig(
        icp=L.IcpConfig(iters=3, degen_eigval=5.0, fit_every=4,
                        final_refresh=False, eig_sweeps=3),
        odom_icp=L.IcpConfig(iters=4, max_corr_dist=2.0, degen_eigval=5.0,
                             fit_every=4, final_refresh=False, eig_sweeps=3),
        corner_map=vm.VoxelMapConfig(capacity=24576, leaf=0.2),
        surf_map=vm.VoxelMapConfig(capacity=49152, leaf=0.4),
        submap_corners=2048, submap_surfs=4096,
        two_stage=True, undistort=True, guess_is_delta=True)
    return VIL.VilConfig(
        lidar=lidar,
        gate=DG.GateConfig(4.0, -6.0, normalize_per_corr=True),
        fusion=fu.FusionConfig(
            smoother=G.SmootherConfig(window=6, between_slots=12, gn_iters=4),
            sensors=VIL.VilConfig().fusion.sensors, max_imu_per_gap=32))


class SliceInputs(NamedTuple):
    imu_times: torch.Tensor
    imu_accel: torch.Tensor
    imu_gyro: torch.Tensor
    vio_times: np.ndarray
    vio: VIL.VioStream
    pose0: torch.Tensor
    vel0: torch.Tensor
    lidar_times: np.ndarray
    sweeps: L.Sweep
    guess_idx: np.ndarray


def make_inputs(dev, duration: float, seed: int = 0):
    """The town drive on ``dev`` and a noisy VIO stand-in whose twist
    covariance is its pose covariance (as bench.py feeds the engine)."""
    sc = scenarios.build("town", duration=duration, dtype=torch.float32,
                         device=dev, seed=seed)
    g = torch.Generator().manual_seed(seed)
    vio = syn.sample_odometry(
        sc.traj, torch.as_tensor(sc.vio_times, dtype=torch.float32,
                                 device=dev),
        VIO_TRANS_NOISE, VIO_ROT_NOISE, generator=g)
    t0 = torch.zeros((), dtype=torch.float32, device=dev)
    inputs = SliceInputs(
        imu_times=sc.imu_times, imu_accel=sc.imu_accel, imu_gyro=sc.imu_gyro,
        vio_times=sc.vio_times,
        vio=VIL.VioStream(pose=vio.poses, cov=vio.cov, twist_cov=vio.cov),
        pose0=sc.traj.pose_fn(t0), vel0=sc.traj.vel_fn(t0),
        lidar_times=sc.lidar_times, sweeps=sc.sweeps,
        guess_idx=sc.lidar_guess_idx)
    return sc, inputs


def first_sweeps(x: SliceInputs, n: int) -> SliceInputs:
    """The first ``n`` sweeps and the VIO events up to the last of them."""
    nv = int(np.searchsorted(x.vio_times, x.lidar_times[n - 1] + 1e-9))
    return x._replace(
        vio_times=x.vio_times[:nv],
        vio=VIL.VioStream(*(f[:nv] for f in x.vio)),
        lidar_times=x.lidar_times[:n],
        sweeps=L.Sweep(*(f[:n] for f in x.sweeps)),
        guess_idx=x.guess_idx[:n])


def to_device(x: SliceInputs, dev) -> SliceInputs:
    def mv(v):
        return v.to(dev) if isinstance(v, torch.Tensor) else v
    return SliceInputs(*(type(f)(*map(mv, f)) if isinstance(f, tuple)
                         else mv(f) for f in x))


def run_slice(cfg: VIL.VilConfig, x: SliceInputs):
    """One call of the port's entry point, from fresh states."""
    dt = torch.float32
    ls = L.odometry.init(cfg.lidar, dt, pose0=x.pose0)
    es = fu.init(cfg.fusion, x.pose0, x.vel0,
                 torch.zeros(6, dtype=dt, device=x.pose0.device),
                 torch.zeros((), dtype=dt, device=x.pose0.device) - 1e-3)
    _, res = VIL.run_vil(
        cfg, x.imu_times, x.imu_accel, x.imu_gyro,
        x.vio_times, x.vio, x.pose0, x.lidar_times, x.sweeps, ls,
        lidar_guess_from_vio_idx=x.guess_idx, engine_state=es)
    return res


def ate(poses: np.ndarray, gt: np.ndarray) -> float:
    """Translation RMSE (m); both trajectories start at the true pose."""
    return float(np.sqrt(np.mean(np.sum((poses[:, 4:] - gt[:, 4:]) ** 2,
                                        axis=-1))))


def drive_slice(cfg: VIL.VilConfig, sc, x: SliceInputs) -> dict:
    """Phase 4 on the inputs' device; returns the run's numbers and the
    result of the counted run."""
    dev = x.pose0.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    T_l, T_v = len(x.lidar_times), len(x.vio_times)
    walls, launches, res = [], [], None
    for _ in range(2):                          # cold, then warm
        sync()
        K.KERNEL_LAUNCHES = 0
        t0 = time.perf_counter()
        res = run_slice(cfg, x)
        sync()
        walls.append(time.perf_counter() - t0)
        launches.append(K.KERNEL_LAUNCHES)
    fused = res.fused.poses.cpu().numpy()
    check(fused.shape == (T_l + T_v, 7), f"fused poses shape {fused.shape}")
    check(bool(np.isfinite(fused).all()), "non-finite fused pose")
    keep = res.gate.keep.cpu().numpy()
    lidar_ate = ate(res.lidar_out.pose.cpu().numpy(), sc.gt_lidar_poses)
    gt_fused = torch.func.vmap(sc.traj.pose_fn)(res.timeline.times)
    fused_ate = ate(fused, gt_fused.cpu().numpy())
    out = {"sweeps": T_l, "vio_events": T_v, "events": T_l + T_v,
           "launches": launches, "keep_share": float(keep.mean()),
           "lidar_ate_m": lidar_ate, "fused_ate_m": fused_ate,
           "cold_s": walls[0], "warm_s": walls[1],
           "events_per_s": (T_l + T_v) / walls[1],
           "healthy_share": float(res.fused.healthy.cpu().numpy().mean())}
    print("  " + json.dumps(out), flush=True)
    check(float(keep.mean()) > 0.0, "the gate kept no sweep")
    check(lidar_ate < 0.5, f"LiDAR ATE {lidar_ate} m")
    check(fused_ate < 1.0, f"fused ATE {fused_ate} m")
    return {"numbers": out, "result": res}


def cross_check(cfg: VIL.VilConfig, x: SliceInputs, res_dev,
                n: int = CROSS_SWEEPS) -> dict:
    """Phase 5: rerun the first ``n`` sweeps and their events on the CPU
    and compare with the device run, which is causal in both stages, so
    its first ``n`` sweeps and events are the same computation.

    Tolerances: the two runs take identical inputs, but f32 sums run in
    another order and the CPU's and the card's sin/cos/sqrt differ in the
    last bit. Over a chain of sweeps that flips a few line/plane gates or a
    hashed-map slot winner, each of which moves a pose by millimetres
    (the same effect bounds the port-vs-JAX f32 test at 1e-2 m). Each f32
    run is that far from a float64 run of the same code too: on this drive
    both sit up to ~8 mm and ~6% (Hessian) from it, while either device
    repeats itself bit for bit. So: poses 2e-2 m and 2e-3 in the
    quaternion, Hessians 1e-1 relative (Frobenius), n_corr 2% + 8, fused
    poses 2e-2 m."""
    xc = to_device(first_sweeps(x, n), torch.device("cpu"))
    K.KERNEL_LAUNCHES = 0
    res_c = run_slice(cfg, xc)
    check(K.KERNEL_LAUNCHES == 0, "the CPU rerun launched the CUDA kernel")
    ld, lc = res_dev.lidar_out, res_c.lidar_out
    nv = len(xc.vio_times)
    pd = ld.pose[:n].cpu().numpy()
    pc = lc.pose.numpy()
    Hd = ld.hessian[:n].cpu().double().numpy()
    Hc = lc.hessian.double().numpy()
    nd, nc = ld.n_corr[:n].cpu().numpy(), lc.n_corr.numpy()
    fd = res_dev.fused.poses[:n + nv].cpu().numpy()
    fc = res_c.fused.poses.numpy()
    h_rel = (np.linalg.norm(Hd - Hc, axis=(1, 2))
             / np.maximum(np.linalg.norm(Hc, axis=(1, 2)), 1e-9))
    out = {"sweeps": n, "events": n + nv,
           "lidar_trans_err_m": float(np.abs(pd[:, 4:] - pc[:, 4:]).max()),
           "lidar_quat_err": float(np.abs(pd[:, :4] - pc[:, :4]).max()),
           "hessian_rel_err": float(h_rel.max()),
           "n_corr_err": float(np.abs(nd - nc).max()),
           "fused_trans_err_m": float(np.abs(fd[:, 4:] - fc[:, 4:]).max()),
           "fused_quat_err": float(np.abs(fd[:, :4] - fc[:, :4]).max())}
    print("  " + json.dumps(out), flush=True)
    check(out["lidar_trans_err_m"] <= 2e-2, "LiDAR positions differ")
    check(out["lidar_quat_err"] <= 2e-3, "LiDAR rotations differ")
    check(out["hessian_rel_err"] <= 1e-1, "Hessians differ")
    check(bool((np.abs(nd - nc) <= 0.02 * np.abs(nc) + 8).all()),
          "n_corr differs")
    check(out["fused_trans_err_m"] <= 2e-2, "fused positions differ")
    check(out["fused_quat_err"] <= 2e-3, "fused rotations differ")
    return out


def main() -> int:
    # Phase 1: the device.
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on an NVIDIA "
              "card only", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = gpu_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    _precision.require_full_f32()

    # Phase 2: build the kernel.
    t0 = time.perf_counter()
    K.knn_cuda(torch.zeros(1, 3, device=dev), torch.zeros(1, 3, device=dev),
               torch.ones(1, device=dev))
    torch.cuda.synchronize()
    log, build_s = _build.build_info("knn")
    print(f"[build] knn kernel ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build_s:.2f} s)\n{log.strip()}", flush=True)

    # Phase 3: kernel vs plain.
    print("[kernel vs plain] k-NN, k=5", flush=True)
    kv = kernel_vs_plain(dev)

    # Phase 4: the slice on the card.
    print(f"[slice] town drive {DURATION} s at the bench operating point",
          flush=True)
    cfg = main_path_config()
    sc, x = make_inputs(dev, DURATION)
    drive = drive_slice(cfg, sc, x)
    n = drive["numbers"]
    check(n["launches"] == [4 * n["sweeps"]] * 2,
          f"k-NN kernel launches {n['launches']}, want 4 per sweep "
          f"({4 * n['sweeps']})")

    # Phase 5: CPU cross-check.
    print(f"[cross-check] first {CROSS_SWEEPS} sweeps on the CPU", flush=True)
    cross_check(cfg, x, drive["result"])

    print(f"card: {card}")
    print(json.dumps({"kernels": [{
        "name": "knn5_f32", "route": "cuda",
        "source": "vil_sensor_fusion_tpu_torch/csrc/knn.cu",
        "replaces": "vil_sensor_fusion_tpu/ops/knn.py:114",
        "launches": n["launches"][1],
        "max_abs_err": kv["max_abs_err"],
        "ms": kv["ms"], "plain_ms": kv["plain_ms"],
        "ms_of": "one sweep: sum of the 4 main-path shapes",
        "per_shape_us": kv["per_shape_us"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
