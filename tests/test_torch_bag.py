"""The port's raw-sensor bag path against the JAX package's, on identical
inputs: the rosbag writer (byte for byte), the native reader binding,
``fix_bag_time``, the frame conventions, ``rangeimage.organize``, the exact
``voxelmap.insert``, ``ingest.load_bag``, ``scenarios.write_scenario_bag``
and ``fusion.vil.run_vil_from_bag``.

Tolerances, stated per comparison:
- bytes, bag contents, organized xyz and masks, voxel maps: exact;
- organized ranges: 1 ulp (rtol 1.2e-7 in f32). The range is a square
  root, and torch's vectorised CPU sqrt and XLA's differ by an ulp on a
  few values; the cell assignment and the collision winners do not move;
- conventions: 1e-12 in float64;
- ``run_vil_from_bag`` in float64 over a 0.5 s drive at a 128×96 camera:
  the band of ``test_torch_vil.py`` (VIO and fused poses 1e-7, LiDAR poses
  1e-5, n_corr ±2, gate decisions exact); measured 3e-16 / 2e-16 / 3e-15
  and equal n_corr.
"""

import filecmp

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vil_sensor_fusion_tpu import fusion as JFU
from vil_sensor_fusion_tpu import graph as JG
from vil_sensor_fusion_tpu.core import lie as JL
from vil_sensor_fusion_tpu.data import bagtools as JBT
from vil_sensor_fusion_tpu.data import conventions as JCV
from vil_sensor_fusion_tpu.data import ingest as JIG
from vil_sensor_fusion_tpu.data import rosbag_writer as JW
from vil_sensor_fusion_tpu.data import scenarios as JSC
from vil_sensor_fusion_tpu.degeneracy import gate as JDG
from vil_sensor_fusion_tpu.frontends import lidar as JLi
from vil_sensor_fusion_tpu.frontends import vio as JV
from vil_sensor_fusion_tpu.frontends.lidar import rangeimage as JRI
from vil_sensor_fusion_tpu.frontends.lidar import voxelmap as JVM
from vil_sensor_fusion_tpu.frontends.vio import frontend as JF
from vil_sensor_fusion_tpu.fusion import vil as JVIL
from vil_sensor_fusion_tpu_torch import convert
from vil_sensor_fusion_tpu_torch.data import bagtools as TBT
from vil_sensor_fusion_tpu_torch.data import conventions as TCV
from vil_sensor_fusion_tpu_torch.data import ingest as TIG
from vil_sensor_fusion_tpu_torch.data import rosbag_io as TIO
from vil_sensor_fusion_tpu_torch.data import rosbag_writer as TW
from vil_sensor_fusion_tpu_torch.data import scenarios as TSC
from vil_sensor_fusion_tpu_torch.frontends.lidar import rangeimage as TRI
from vil_sensor_fusion_tpu_torch.frontends.lidar import voxelmap as TVM
from vil_sensor_fusion_tpu_torch.fusion import vil as TVIL
from vil_sensor_fusion_tpu_torch.ops import knn as TK

EPOCH = 1.7e9       # a ROS epoch: not representable in f32


def _write_sample(W, path, compression, seed=0):
    """The same IMU / PointCloud2 / Image (mono8, rgb8) / Odometry messages
    through writer module ``W``."""
    rng = np.random.default_rng(seed)
    with W.BagWriter(path, compression=compression,
                     chunk_threshold=4096) as w:
        for i in range(40):
            w.write_msg("/imu", "sensor_msgs/Imu", EPOCH + 0.005 * i,
                        rng.normal(size=3), rng.normal(size=3))
        w.write_msg("/lidar", "sensor_msgs/PointCloud2", EPOCH + 0.1,
                    rng.normal(size=(60, 3)))
        w.write_msg("/cam", "sensor_msgs/Image", EPOCH + 0.05,
                    rng.integers(0, 256, (6, 8), dtype=np.uint8))
        w.write_msg("/rgb", "sensor_msgs/Image", EPOCH + 0.05,
                    rng.integers(0, 256, (6, 8, 3), dtype=np.uint8))
        w.write_msg("/odo", "nav_msgs/Odometry", EPOCH + 0.05,
                    np.array([1.0, 0, 0, 0, 1, 2, 3]), np.eye(6),
                    2 * np.eye(6))
    return rng


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_writer_writes_the_jax_bytes(tmp_path, compression):
    pj, pt = tmp_path / "j.bag", tmp_path / "t.bag"
    _write_sample(JW, pj, compression)
    _write_sample(TW, pt, compression)
    assert filecmp.cmp(pj, pt, shallow=False)


def test_reader_round_trips(tmp_path):
    path = tmp_path / "s.bag"
    _write_sample(TW, path, "bz2")
    rng = np.random.default_rng(0)
    imu = [(rng.normal(size=3), rng.normal(size=3)) for _ in range(40)]
    cloud = rng.normal(size=(60, 3)).astype(np.float32)
    mono = rng.integers(0, 256, (6, 8), dtype=np.uint8)
    rgb = rng.integers(0, 256, (6, 8, 3), dtype=np.uint8)
    with TIO.BagReader(path) as bag:
        assert bag.topics() == {
            "/imu": "sensor_msgs/Imu", "/lidar": "sensor_msgs/PointCloud2",
            "/cam": "sensor_msgs/Image", "/rgb": "sensor_msgs/Image",
            "/odo": "nav_msgs/Odometry"}
        assert bag.count("/imu") == 40
        t, a, g = bag.read_imu("/imu")
        np.testing.assert_allclose(t, EPOCH + 0.005 * np.arange(40),
                                   atol=1e-6)
        np.testing.assert_array_equal(g, [x[0] for x in imu])
        np.testing.assert_array_equal(a, [x[1] for x in imu])
        np.testing.assert_array_equal(bag.stamps("/imu"), t)
        st, xyz = bag.read_pointcloud("/lidar", 0)
        assert st == pytest.approx(EPOCH + 0.1, abs=1e-6)
        np.testing.assert_array_equal(xyz, cloud)
        _, img, enc = bag.read_image("/cam", 0)
        assert enc == "mono8"
        np.testing.assert_array_equal(img, mono)
        _, img, enc = bag.read_image("/rgb", 0)
        assert enc == "rgb8"
        np.testing.assert_array_equal(img, rgb)
        _, p, pc, tc = bag.read_odometry("/odo")
        np.testing.assert_array_equal(p[0], [1, 0, 0, 0, 1, 2, 3])
        np.testing.assert_array_equal(pc[0], np.eye(6))
        np.testing.assert_array_equal(tc[0], 2 * np.eye(6))
        rec_t, payload = bag.read_record("/odo", 0)
        assert rec_t == pytest.approx(EPOCH + 0.05, abs=1e-6)
        assert len(payload) > 0
    with pytest.raises(IOError):
        TIO.BagReader(tmp_path / "missing.bag")


def test_fix_bag_time_writes_the_jax_file(tmp_path):
    """Record times in wall clock 2 s behind the header stamps: both
    packages rewrite them to the headers, to the same bytes."""
    src = tmp_path / "skewed.bag"
    rng = np.random.default_rng(3)
    with TW.BagWriter(src) as w:
        w.add_topic("/imu", "sensor_msgs/Imu")
        w.add_topic("/odo", "nav_msgs/Odometry")
        for i in range(20):
            stamp = EPOCH + 0.01 * i
            w.write("/imu", stamp + 2.0, TW.imu_msg(
                stamp, rng.normal(size=3), rng.normal(size=3)))
        w.write("/odo", EPOCH + 3.0, TW.odometry_msg(
            EPOCH + 1.0, np.array([1.0, 0, 0, 0, 0, 0, 0])))
    rj = JBT.fix_bag_time(src, tmp_path / "j.bag", compression="bz2")
    rt = TBT.fix_bag_time(src, tmp_path / "t.bag", compression="bz2")
    assert rt == rj
    assert rt["rewritten"] == 21 and rt["max_skew_s"] == pytest.approx(2.0)
    assert filecmp.cmp(tmp_path / "j.bag", tmp_path / "t.bag",
                       shallow=False)


# ---------------------------------------------------------------------------
# conventions
# ---------------------------------------------------------------------------

_RNG = np.random.default_rng(7)
_V = _RNG.normal(size=(5, 3))
_A = _RNG.normal(size=(4, 3, 3))
_COV = _A @ np.swapaxes(_A, -1, -2)
_Q = _RNG.normal(size=(6, 4))
_POSES = np.concatenate([_Q / np.linalg.norm(_Q, axis=1, keepdims=True),
                         _RNG.normal(size=(6, 3))], axis=1)
_CLOUD = np.arange(64 * 8 * 4, dtype=np.float64).reshape(-1, 4)
_IMG_U8 = _RNG.integers(0, 256, (2, 5, 7, 3), dtype=np.uint8)
_IMG_F = _RNG.uniform(0, 255, (5, 7, 3))
_IMU_A, _IMU_G = _RNG.normal(size=(30, 3)), _RNG.normal(size=(30, 3))

CONVENTION_CASES = {
    "rotate_vectors": lambda CV: [CV.rotate_vectors(R, _V) for R in (
        CV.ROS_FROM_LOAM, CV.LOAM_FROM_ROS, CV.ROS_FROM_VELODYNE,
        CV.VELODYNE_FROM_ROS, CV.ROS_FROM_CAMERA, CV.CAMERA_FROM_ROS,
        CV.ROS_FROM_CARLA)],
    "rotate_covariance": lambda CV: [
        CV.rotate_covariance(CV.ROS_FROM_CAMERA, _COV)],
    "transform_imu_stream": lambda CV: list(CV.transform_imu_stream(
        CV.ROS_FROM_VELODYNE, _V, _V[::-1].copy(), _COV, _COV[::-1].copy())),
    "transform_points": lambda CV: [
        CV.transform_points(CV.ROS_FROM_LOAM, _V)],
    "loam_odom_to_ros": lambda CV: [CV.loam_odom_to_ros(_POSES)],
    "downsample_cloud": lambda CV: [
        CV.downsample_cloud(_CLOUD, channels=64, vert_downsample=4,
                            horiz_downsample=2),
        CV.downsample_cloud(_CLOUD, channels=16, vert_downsample=2,
                            horiz_downsample=3, rings_major=True)],
    "flip_image": lambda CV: [CV.flip_image(_IMG_U8[..., 0])],
    "rgb_to_mono": lambda CV: [CV.rgb_to_mono(_IMG_U8),
                               CV.rgb_to_mono(_IMG_F)],
    "imu_moving_average": lambda CV: list(
        CV.imu_moving_average(_IMU_A, _IMU_G, window=4)),
}


class _Args:
    """Hands a case's arrays to one package's function through ``wrap``."""

    def __init__(self, module, wrap):
        self._m, self._w = module, wrap

    def __getattr__(self, name):
        attr = getattr(self._m, name)
        if not callable(attr):
            return attr
        return lambda *a, **k: attr(*(self._w(x) for x in a), **k)


def _jax_arg(x):
    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


def _torch_arg(x):
    """Data as CPU tensors; the 3×3 convention matrices stay numpy, as a
    caller passes the module's constants."""
    if isinstance(x, np.ndarray) and x.shape != (3, 3):
        return torch.as_tensor(x)
    return x


@pytest.mark.parametrize("name", sorted(CONVENTION_CASES))
def test_conventions_match_jax(name):
    want = CONVENTION_CASES[name](_Args(JCV, _jax_arg))
    got = CONVENTION_CASES[name](_Args(TCV, _torch_arg))
    for w, g in zip(want, got, strict=True):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# organize
# ---------------------------------------------------------------------------

def _organize_both(pts, val, **kw):
    sj = JRI.organize(jnp.asarray(pts), jnp.asarray(val), **kw)
    st = TRI.organize(torch.as_tensor(pts), torch.as_tensor(val), **kw)
    return sj, st


def _assert_sweeps_equal(sj, st):
    np.testing.assert_array_equal(st.xyz.numpy(), np.asarray(sj.xyz))
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask))
    np.testing.assert_allclose(st.rng.numpy(), np.asarray(sj.rng),
                               rtol=1.2e-7, atol=0)


def _vlp16_cloud(rng, n):
    """Points near VLP-16 rays: ring elevations and random azimuths,
    ranges 2-60 m, with repeated rays (collisions)."""
    elev = np.deg2rad(rng.choice(np.linspace(-15, 15, 16), n)
                      + rng.normal(0, 0.3, n))
    az = rng.uniform(-np.pi, np.pi, n)
    r = rng.uniform(2.0, 60.0, n)
    pts = np.stack([r * np.cos(elev) * np.cos(az),
                    r * np.cos(elev) * np.sin(az), r * np.sin(elev)], 1)
    pts[n // 2: n // 2 + n // 8] = pts[: n // 8] * rng.uniform(
        0.5, 1.5, (n // 8, 1))
    return pts.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_organize_matches_jax_on_random_clouds(seed):
    rng = np.random.default_rng(seed)
    pts = _vlp16_cloud(rng, 4000)
    val = (rng.uniform(size=4000) > 0.1).astype(np.float32)
    pts[-300:], val[-300:] = 0.0, 0.0         # padding, as ingest pads
    sj, st = _organize_both(pts, val)
    assert float(st.mask.sum()) > 2500
    _assert_sweeps_equal(sj, st)


# On a 4×4 grid (4 rings, 90° azimuth bins): (3, 4, 1) and (4, 3, 1) share
# cell (3, 2) at the same range 5.099 — the same float, since 9 + 16 and
# 16 + 9 are both exactly 25; (-3, 4, 1) and its double (-6, 8, 2) fall in
# the last cell (3, 3), the nearer one winning.
_EQ_A, _EQ_B = [3.0, 4.0, 1.0], [4.0, 3.0, 1.0]
_LAST_WIN, _LAST_LOSE = [-3.0, 4.0, 1.0], [-6.0, 8.0, 2.0]
_OTHER = [[1.0, -2.0, 0.1], [-2.0, -1.0, -0.5], [0.05, 0.0, 0.0]]
ORGANIZE_CASES = {
    # Equal-range winners of one cell: the later index stays.
    "equal_ranges": ([_EQ_A, _EQ_B] + _OTHER, None),
    "equal_ranges_reversed": ([_EQ_B, _EQ_A] + _OTHER, None),
    # A loser of the last cell after its winner: zeros stay there.
    "last_cell_loser_after": ([_LAST_WIN] + _OTHER + [_LAST_LOSE], None),
    # The last cell's winner after its loser keeps its point.
    "last_cell_winner_after": ([_LAST_LOSE] + _OTHER + [_LAST_WIN], None),
    # Padded invalid (0, 0, 0) points after real ones, and an invalid
    # real point.
    "padding": ([_LAST_WIN, _EQ_A] + _OTHER + [[0.0, 0.0, 0.0]] * 4,
                [1, 1, 1, 0, 1, 0, 0, 0, 0]),
}


@pytest.mark.parametrize("case", sorted(ORGANIZE_CASES))
def test_organize_matches_jax_on_collisions(case):
    pts, val = ORGANIZE_CASES[case]
    pts = np.asarray(pts, np.float32)
    val = np.ones(len(pts), np.float32) if val is None \
        else np.asarray(val, np.float32)
    sj, st = _organize_both(pts, val, rings=4, azimuth=4)
    _assert_sweeps_equal(sj, st)
    if case == "last_cell_loser_after":
        assert float(st.mask[3, 3]) == 1.0
        assert st.xyz[3, 3].tolist() == [0.0, 0.0, 0.0]
    if case == "last_cell_winner_after":
        assert st.xyz[3, 3].tolist() == _LAST_WIN
    if case == "equal_ranges":
        assert st.xyz[3, 2].tolist() == _EQ_B


def test_organize_batches_over_leading_axes():
    rng = np.random.default_rng(5)
    pts = np.stack([_vlp16_cloud(rng, 1000) for _ in range(3)])
    val = (rng.uniform(size=(3, 1000)) > 0.2).astype(np.float32)
    st = TRI.organize(torch.as_tensor(pts), torch.as_tensor(val))
    assert st.xyz.shape == (3, 16, 1800, 3)
    for i in range(3):
        one = TRI.organize(torch.as_tensor(pts[i]), torch.as_tensor(val[i]))
        for a, b in zip(st, one):
            assert torch.equal(a[i], b)


# ---------------------------------------------------------------------------
# voxelmap.insert (exact)
# ---------------------------------------------------------------------------

def test_exact_insert_matches_jax():
    """Four inserts into a 256-point map: new points duplicating old
    voxels and each other, points beyond keep_radius (their −inf scores
    tie), invalid points, and more survivors than capacity."""
    cfg = JVM.VoxelMapConfig(capacity=256, leaf=0.5, keep_radius=15.0,
                             hashed=False)
    tcfg = convert.to_torch(cfg, "cpu")
    rng = np.random.default_rng(11)
    mj = JVM.empty(cfg, jnp.float64)
    mt = TVM.empty(tcfg, torch.float64, device="cpu")
    for _ in range(4):
        pts = rng.uniform(-20.0, 20.0, (300, 3))
        pts[100:160] = pts[:60] + 0.01           # duplicate voxels
        pts[200:230] = np.asarray(mj.points)[:30]  # old points again
        msk = (rng.uniform(size=300) > 0.1).astype(np.float64)
        c = rng.uniform(-2.0, 2.0, 3)
        mj = JVM.insert(mj, jnp.asarray(pts), jnp.asarray(msk),
                        jnp.asarray(c), cfg)
        mt = TVM.insert_auto(mt, torch.as_tensor(pts), torch.as_tensor(msk),
                             torch.as_tensor(c), tcfg)
        np.testing.assert_array_equal(mt.points.numpy(),
                                      np.asarray(mj.points))
        np.testing.assert_array_equal(mt.mask.numpy(), np.asarray(mj.mask))
    assert 0 < float(mt.mask.sum()) < 256      # −inf ties fill the rest


# ---------------------------------------------------------------------------
# scenario bag → load_bag → run_vil_from_bag
# ---------------------------------------------------------------------------

CAM_W, CAM_H = 128, 96


def _config():
    """test_torch_vil.py's narrow operating point on a 128×96 camera."""
    cam = JV.camera.Camera(fx=85.6, fy=85.6, cx=CAM_W / 2, cy=CAM_H / 2,
                           width=CAM_W, height=CAM_H)
    vio = JV.VioConfig(num_landmarks=12, update_iters=2, cam=cam,
                       pose_ic=tuple(np.asarray(
                           JF.forward_camera_extrinsics(jnp.float64))))
    lidar = JLi.LidarOdomConfig(
        icp=JLi.IcpConfig(iters=3, degen_eigval=5.0, fit_every=4,
                          final_refresh=False, eig_sweeps=3),
        odom_icp=JLi.IcpConfig(iters=4, max_corr_dist=2.0, degen_eigval=5.0,
                               fit_every=4, final_refresh=False,
                               eig_sweeps=3),
        corner_map=JVM.VoxelMapConfig(capacity=4096, leaf=0.2),
        surf_map=JVM.VoxelMapConfig(capacity=8192, leaf=0.4),
        submap_corners=512, submap_surfs=1024,
        two_stage=True, undistort=True, guess_is_delta=True)
    cfg = JVIL.VilConfig(
        vio=vio, lidar=lidar,
        gate=JDG.GateConfig(4.0, -6.0, normalize_per_corr=True),
        fusion=JFU.FusionConfig(
            smoother=JG.SmootherConfig(window=4, between_slots=8,
                                       gn_iters=3),
            sensors=JVIL.VilConfig().fusion.sensors, max_imu_per_gap=32))
    fe = JF.FrontendConfig(cam=cam, n_candidates=32, min_dist=8.0,
                           min_score=0.5)
    return cfg, fe


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs its files side by side, one
    worker each, and these tests run many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenario_bag(tmp_path_factory):
    """A 0.5 s town drive built by the port on the CPU (5 sweeps, 10
    frames rendered at 128×96), written by the port's
    ``write_scenario_bag`` with bz2 chunks."""
    cfg, _ = _config()
    tcfg = convert.to_torch(cfg, "cpu")
    sc = TSC.build("town", duration=0.5, vio_cfg=tcfg.vio,
                   dtype=torch.float32, device="cpu")
    images, _, _ = TSC.render_frontend_inputs(sc, tcfg.vio.cam,
                                              tcfg.vio.pose_ic)
    sc = sc._replace(images=images)
    path = tmp_path_factory.mktemp("bags") / "town.bag"
    TSC.write_scenario_bag(path, sc, compression="bz2")
    return path, sc


def test_write_scenario_bag_writes_the_jax_bytes(scenario_bag, tmp_path):
    path, sc = scenario_bag
    JSC.write_scenario_bag(tmp_path / "j.bag", convert.to_numpy(sc),
                           compression="bz2")
    assert filecmp.cmp(path, tmp_path / "j.bag", shallow=False)
    with pytest.raises(ValueError, match="no images"):
        TSC.write_scenario_bag(tmp_path / "x.bag", sc._replace(images=None))


def test_load_bag_matches_jax(scenario_bag):
    path, sc = scenario_bag
    bj = JIG.load_bag(path, gt_topic="/gt/odometry")
    bt = TIG.load_bag(path, gt_topic="/gt/odometry", device="cpu")
    for f in ("imu_times", "imu_accel", "imu_gyro", "lidar_times",
              "cam_times", "images", "gt_times", "gt_poses"):
        np.testing.assert_array_equal(getattr(bt, f), getattr(bj, f), f)
    assert bt.t0 == bj.t0
    _assert_sweeps_equal(bj.sweeps, bt.sweeps)
    assert bt.sweeps.xyz.shape == (5, 16, 1800, 3)
    # The re-based stamps are the scenario's own.
    np.testing.assert_allclose(bt.lidar_times, sc.lidar_times, atol=1e-6)
    wj = JIG.imu_windows_from_stream(bj.imu_times, bj.imu_accel, bj.imu_gyro,
                                     bj.cam_times, dtype=jnp.float64)
    wt = TIG.imu_windows_from_stream(bt.imu_times, bt.imu_accel, bt.imu_gyro,
                                     bt.cam_times, dtype=torch.float64,
                                     device="cpu")
    for a, b in zip(wj, wt, strict=True):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_ingest_defaults_to_the_card():
    """Left without a device, ingestion puts its tensors on the card; on a
    host without CUDA it raises rather than landing on the CPU."""
    args = (np.arange(10) * 0.01, np.zeros((10, 3)), np.zeros((10, 3)),
            np.array([0.05, 0.1]))
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            TIG.imu_windows_from_stream(*args)
        return
    assert all(w.is_cuda for w in TIG.imu_windows_from_stream(*args))


def test_run_vil_from_bag_matches_jax(scenario_bag):
    path, _ = scenario_bag
    cfg, fe = _config()
    topics = dict(gt_topic="/gt/odometry")
    esj, rj, _ = JVIL.run_vil_from_bag(path, cfg=cfg, fe_cfg=fe,
                                       topics=topics, dtype=jnp.float64)
    est, rt, bt = TVIL.run_vil_from_bag(
        path, cfg=convert.to_torch(cfg, "cpu"),
        fe_cfg=convert.to_torch(fe, "cpu"), topics=topics,
        dtype=torch.float64, device="cpu")
    for f in ("pose", "vel", "cov"):
        np.testing.assert_allclose(getattr(rt.vio_out, f).numpy(),
                                   np.asarray(getattr(rj.vio_out, f)),
                                   atol=1e-7)
    np.testing.assert_allclose(rt.lidar_out.pose.numpy(),
                               np.asarray(rj.lidar_out.pose), atol=1e-5)
    np.testing.assert_allclose(rt.lidar_out.n_corr.numpy(),
                               np.asarray(rj.lidar_out.n_corr), atol=2)
    np.testing.assert_array_equal(rt.gate.keep.numpy(),
                                  np.asarray(rj.gate.keep))
    np.testing.assert_allclose(rt.fused.poses.numpy(),
                               np.asarray(rj.fused.poses), atol=1e-7)
    np.testing.assert_array_equal(rt.fused.solved.numpy(),
                                  np.asarray(rj.fused.solved))
    assert rt.fused.poses.shape == (15, 7)
    assert rt.gate.keep.numpy()[1:].sum() > 0
    # The engine states agree too (what a checkpoint of the run holds).
    np.testing.assert_allclose(est.smoother.states.poses.numpy(),
                               np.asarray(esj.smoother.states.poses),
                               atol=1e-7)
    # On the CPU as asked, and near the recorded GT.
    assert rt.vio_out.pose.device.type == "cpu"
    idx = np.clip(np.searchsorted(bt.gt_times, rt.fused.times.numpy()),
                  0, len(bt.gt_times) - 1)
    assert np.abs(rt.fused.poses.numpy()[:, 4:]
                  - bt.gt_poses[idx][:, 4:]).max() < 0.5


def test_run_vil_from_bag_refuses_photometric(scenario_bag, monkeypatch):
    """The photometric mode of ``run_vil_from_bag`` (once refused) against
    JAX's: images → pyramids and candidates → the direct photometric EKF,
    then LiDAR odometry, the gate and fusion, in float64 within the band
    of the geometric run above; the port's k-NN calls are 4 per sweep."""
    path, _ = scenario_bag
    cfg, fe = _config()
    cfg = cfg._replace(vio=cfg.vio._replace(use_photometric=True))
    topics = dict(gt_topic="/gt/odometry")
    _, rj, _ = JVIL.run_vil_from_bag(path, cfg=cfg, fe_cfg=fe,
                                     topics=topics, dtype=jnp.float64)
    calls = []
    knn = TK.knn

    def count(*a, **k):
        calls.append(a[0].shape[0])
        return knn(*a, **k)
    monkeypatch.setattr(TK, "knn", count)
    c = convert.to_torch(cfg, "cpu")
    _, rt, bt = TVIL.run_vil_from_bag(
        path, cfg=c, fe_cfg=convert.to_torch(fe, "cpu"), topics=topics,
        dtype=torch.float64, device="cpu")
    for f in ("pose", "vel", "cov"):
        np.testing.assert_allclose(getattr(rt.vio_out, f).numpy(),
                                   np.asarray(getattr(rj.vio_out, f)),
                                   atol=1e-7)
    np.testing.assert_allclose(rt.lidar_out.pose.numpy(),
                               np.asarray(rj.lidar_out.pose), atol=1e-5)
    np.testing.assert_allclose(rt.lidar_out.n_corr.numpy(),
                               np.asarray(rj.lidar_out.n_corr), atol=2)
    np.testing.assert_array_equal(rt.gate.keep.numpy(),
                                  np.asarray(rj.gate.keep))
    np.testing.assert_allclose(rt.fused.poses.numpy(),
                               np.asarray(rj.fused.poses), atol=1e-7)
    assert rt.fused.poses.shape == (15, 7)
    assert np.isfinite(rt.vio_out.cov.numpy()).all()
    # Two-stage ICP: line and plane fits of the scan-to-scan and the
    # scan-to-map stage, every sweep.
    assert len(calls) == 4 * len(bt.lidar_times)
    err = np.abs(rt.vio_out.pose.numpy()[:, 4:] - bt.gt_poses[
        np.clip(np.searchsorted(bt.gt_times, bt.cam_times), 0,
                len(bt.gt_times) - 1)][:, 4:]).max()
    assert err < 0.5


class _Stop(Exception):
    pass


def test_run_vil_from_bag_starts_at_identity_without_gt(scenario_bag,
                                                        monkeypatch):
    """Without a GT topic the run starts from the identity at rest on the
    requested device (the reference's identity prior)."""
    path, _ = scenario_bag
    cfg, fe = _config()
    seen = {}

    def spy(vcfg, pose0, vel0, bias0):
        seen.update(pose0=pose0, vel0=vel0)
        raise _Stop
    monkeypatch.setattr(TVIL.V, "init", spy)
    with pytest.raises(_Stop):
        TVIL.run_vil_from_bag(path, cfg=convert.to_torch(cfg, "cpu"),
                              fe_cfg=convert.to_torch(fe, "cpu"),
                              device="cpu")
    assert seen["pose0"].tolist() == [1.0, 0, 0, 0, 0, 0, 0]
    assert seen["pose0"].device.type == "cpu"
    assert seen["vel0"].tolist() == [0.0, 0.0, 0.0]
