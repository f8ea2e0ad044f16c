"""YAML configuration — same shape as the reference's
gtsam_fusion/config/*/fusion_params.yaml (sensors registry, imu covariances,
filter thresholds), so a reference user's config ports by renaming keys
they recognize.

Port of ``vil_sensor_fusion_tpu/config.py``: the same files build the
port's config NamedTuples, equal field for field to the JAX package's.

Example (mirrors config/carla/fusion_params.yaml):

    sensors:
      lidar:
        odom_topic: /laser_odom
        optimize_after_odom: false
        use_odom_covariance: false
        covariance_linear: 0.2
        covariance_angular: 0.2
        max_time_skip: 0.1
      vio:
        odom_topic: /rovio/odometry
        optimize_after_odom: true
        covariance_linear: 0.1
        covariance_angular: 0.1
        max_time_skip: 0.1
    imu:
      topic: /imu/fusion
      cov_bias_acc: 0.0001
      cov_bias_omega: 0.000001
      cov_accel: 0.000001
      cov_gyro: 0.000001
      cov_integration: 0.00000001
      cov_bias_acc_omega_int: 0.0001
    filter:
      rot_degen_threshold: 11.5
      trans_degen_threshold: 28.9
    smoother:
      window: 8
      gn_iters: 6
"""

from __future__ import annotations

from typing import Any

from .core.preintegration import ImuParams
from .degeneracy.gate import GateConfig
from .fusion.engine import FusionConfig, SensorSpec
from .graph.smoother import SmootherConfig


def _load_yaml(path: str) -> dict:
    import yaml  # PyYAML: a lazy import, needed only to read a file

    with open(path) as f:
        return yaml.safe_load(f)


def imu_params_from_dict(d: dict) -> ImuParams:
    return ImuParams(
        cov_accel=float(d.get("cov_accel", 1e-6)),
        cov_gyro=float(d.get("cov_gyro", 1e-6)),
        cov_integration=float(d.get("cov_integration", 1e-8)),
        cov_bias_acc=float(d.get("cov_bias_acc", 1e-4)),
        cov_bias_omega=float(d.get("cov_bias_omega", 1e-6)),
        cov_bias_acc_omega_int=float(d.get("cov_bias_acc_omega_int", 1e-4)),
        gravity=float(d.get("gravity", 9.81)),
    )


def sensor_spec_from_dict(name: str, d: dict) -> SensorSpec:
    return SensorSpec(
        name=name,
        use_odom_covariance=bool(d.get("use_odom_covariance", False)),
        use_pose_covariance=bool(d.get("use_pose_covariance", False)),
        covariance_linear=float(d.get("covariance_linear", 0.1)),
        covariance_angular=float(d.get("covariance_angular", 0.1)),
        optimize_after_odom=bool(d.get("optimize_after_odom", False)),
        max_time_skip=float(d.get("max_time_skip", 0.1)),
        absolute_anchor=bool(d.get("absolute_anchor", False)),
        anchor_cov_scale=float(d.get("anchor_cov_scale", 25.0)),
    )


def gate_config_from_dict(d: dict) -> GateConfig:
    return GateConfig(
        rot_threshold=float(d.get("rot_degen_threshold", 11.5)),
        trans_threshold=float(d.get("trans_degen_threshold", 28.9)),
        normalize_per_corr=bool(d.get("normalize_per_corr", False)),
    )


def smoother_config_from_dict(d: dict, imu: ImuParams) -> SmootherConfig:
    return SmootherConfig(
        window=int(d.get("window", 8)),
        between_slots=int(d.get("between_slots", 16)),
        gn_iters=int(d.get("gn_iters", 8)),
        damping=float(d.get("damping", 1e-9)),
        prior_rot_sigma=float(d.get("prior_rot_sigma", 1e-6)),
        prior_trans_sigma=float(d.get("prior_trans_sigma", 5e-5)),
        prior_vel_sigma=float(d.get("prior_vel_sigma", 1e-5)),
        prior_bias_sigma=float(d.get("prior_bias_sigma", 1e-7)),
        info_cap=float(d.get("info_cap", 1e6)),
        imu=imu,
    )


def camera_from_dict(d: dict):
    """``camera:`` section → Camera. Either explicit intrinsics
    (fx/fy/cx/cy) or width/height/fov_deg (the sensors.json style)."""
    from .frontends.vio.camera import Camera, carla_camera

    w = int(d.get("width", 800))
    h = int(d.get("height", 600))
    if "fx" in d:
        return Camera(fx=float(d["fx"]), fy=float(d.get("fy", d["fx"])),
                      cx=float(d.get("cx", w / 2.0)),
                      cy=float(d.get("cy", h / 2.0)), width=w, height=h)
    return carla_camera(width=w, height=h,
                        fov_deg=float(d.get("fov_deg", 100.0)))


def vio_config_from_dict(d: dict, cam):
    """``vio:`` section → VioConfig (the rovio.cfg equivalents)."""
    from .frontends import vio as V
    from .frontends.vio import frontend as F

    pose_ic = d.get("imu_t_camera")
    if pose_ic is None:
        # A config value: Python floats of the float32 mounting, computed
        # on the host (no device holds a config).
        pose_ic = tuple(float(v) for v in F.forward_camera_extrinsics(
            device="cpu"))
    else:
        pose_ic = tuple(float(v) for v in pose_ic)   # (qw qx qy qz x y z)
    return V.VioConfig(
        num_landmarks=int(d.get("num_landmarks", 24)),
        cov_accel=float(d.get("cov_accel", 1e-3)),
        cov_gyro=float(d.get("cov_gyro", 1e-5)),
        cov_bias_acc=float(d.get("cov_bias_acc", 1e-6)),
        cov_bias_omega=float(d.get("cov_bias_omega", 1e-8)),
        gravity=float(d.get("gravity", 9.81)),
        pixel_sigma=float(d.get("pixel_sigma", 1.0)),
        update_iters=int(d.get("update_iters", 2)),
        chi2_gate=float(d.get("chi2_gate", 9.21)),
        use_depth_update=bool(d.get("use_depth_update", True)),
        depth_sigma_update=float(d.get("depth_sigma_update", 0.5)),
        use_gravity_update=bool(d.get("use_gravity_update", True)),
        gravity_sigma=float(d.get("gravity_sigma", 0.3)),
        gravity_accel_gate=float(d.get("gravity_accel_gate", 0.4)),
        use_zero_velocity_update=bool(
            d.get("use_zero_velocity_update", True)),
        zuv_sigma=float(d.get("zuv_sigma", 0.1)),
        zuv_gyro_th=float(d.get("zuv_gyro_th", 0.02)),
        zuv_accel_th=float(d.get("zuv_accel_th", 0.15)),
        # Direct photometric mode (rovio.cfg patchSize/nLevels/
        # UpdateNoise.pix — see frontends.vio.photometric).
        use_photometric=bool(d.get("use_photometric", False)),
        patch_radius=int(d.get("patch_radius", 3)),
        photo_levels=int(d.get("photo_levels", 2)),
        photo_sigma=float(d.get("photo_sigma", 4.0)),
        photo_chi2_per_dof=float(d.get("photo_chi2_per_dof", 4.0)),
        cam=cam, pose_ic=pose_ic,
    )


def frontend_config_from_dict(d: dict, cam):
    """``frontend:`` section → FrontendConfig (tracker knobs)."""
    from .frontends.vio import frontend as F

    return F.FrontendConfig(
        cam=cam,
        pyramid_levels=int(d.get("pyramid_levels", 3)),
        klt_radius=int(d.get("klt_radius", 4)),
        klt_iters=int(d.get("klt_iters", 8)),
        klt_max_error=float(d.get("klt_max_error", 12.0)),
        n_candidates=int(d.get("n_candidates", 64)),
        min_score=float(d.get("min_score", 0.5)),
        min_dist=float(d.get("min_dist", 16.0)),
        nms_radius=int(d.get("nms_radius", 8)),
        border=int(d.get("border", 12)),
        # Back-compat: older configs expressed the association reach as
        # (depth_search) cells of (depth_grid) px; both map onto the
        # direct pixel radius of the nearest-in-image association.
        depth_radius_px=float(d.get(
            "depth_radius_px",
            (int(d.get("depth_search", 1)) + 0.5)
            * int(d.get("depth_grid", 8)))),
        max_depth=float(d.get("max_depth", 120.0)),
    )


def _icp_from_dict(d: dict, base):
    return base._replace(
        iters=int(d.get("iters", base.iters)),
        max_corr_dist=float(d.get("max_corr_dist", base.max_corr_dist)),
        degen_eigval=float(d.get("degen_eigval", base.degen_eigval)),
        line_eig_ratio=float(d.get("line_eig_ratio", base.line_eig_ratio)),
        plane_fit_tol=float(d.get("plane_fit_tol", base.plane_fit_tol)),
        fit_every=int(d.get("fit_every", base.fit_every)),
        final_refresh=bool(d.get("final_refresh", base.final_refresh)),
        eig_sweeps=int(d.get("eig_sweeps", base.eig_sweeps)),
    )


def lidar_config_from_dict(d: dict):
    """``lidar:`` section → LidarOdomConfig (the loam_params.yaml
    equivalents: odometry/mapping iteration budgets, degeneracy eigenvalue
    thresholds, map leafs/capacities, two-stage + undistortion toggles)."""
    from .frontends import lidar as L

    base = L.LidarOdomConfig()
    icp = _icp_from_dict(d.get("mapping", {}),
                         base.icp._replace(iters=6, degen_eigval=5.0))
    odom_icp = _icp_from_dict(d.get("odometry", {}), base.odom_icp)
    cm, sm = base.corner_map, base.surf_map
    md = d.get("corner_map", {})
    cm = cm._replace(capacity=int(md.get("capacity", cm.capacity)),
                     leaf=float(md.get("leaf", cm.leaf)),
                     keep_radius=float(md.get("keep_radius", cm.keep_radius)),
                     hashed=bool(md.get("hashed", cm.hashed)))
    sd = d.get("surf_map", {})
    sm = sm._replace(capacity=int(sd.get("capacity", sm.capacity)),
                     leaf=float(sd.get("leaf", sm.leaf)),
                     keep_radius=float(sd.get("keep_radius", sm.keep_radius)),
                     hashed=bool(sd.get("hashed", sm.hashed)))
    return base._replace(
        icp=icp, odom_icp=odom_icp,
        two_stage=bool(d.get("two_stage", True)),
        undistort=bool(d.get("undistort", True)),
        emit_dists=bool(d.get("emit_dists", False)),
        corner_map=cm, surf_map=sm,
        submap_corners=int(d.get("submap_corners", 4096)),
        submap_surfs=int(d.get("submap_surfs", 8192)),
        submap_radius=float(d.get("submap_radius", 100.0)),
        submap_approx=bool(d.get("submap_approx", True)),
        guess_is_delta=bool(d.get("guess_is_delta", True)),
    )


class SystemConfig:
    """Parsed top-level config: the full VIL system surface — fusion
    back-end (fusion_params.yaml shape), camera rig + VIO (rovio.cfg /
    rovio_camera.yaml roles), LiDAR odometry (loam_params.yaml role), and
    the degeneracy gate."""

    def __init__(self, raw: dict):
        self.raw = raw
        imu_d = raw.get("imu", {})
        self.imu = imu_params_from_dict(imu_d)
        self.imu_topic = imu_d.get("topic", "/imu/fusion")
        sensors = raw.get("sensors", {})
        self.sensor_specs = tuple(
            sensor_spec_from_dict(k, v) for k, v in sensors.items())
        self.sensor_topics = {
            k: v.get("odom_topic") for k, v in sensors.items()}
        self.gate = gate_config_from_dict(raw.get("filter", {}))
        self.smoother = smoother_config_from_dict(
            raw.get("smoother", {}), self.imu)
        self.fusion = FusionConfig(
            smoother=self.smoother,
            sensors=self.sensor_specs or (SensorSpec(),),
            max_imu_per_gap=int(raw.get("max_imu_per_gap", 32)),
            ref_pose_delta=bool(raw.get("ref_pose_delta", True)),
        )
        # Front-end surface (lazy: only built when the sections exist or a
        # full VilConfig is requested).
        self._cam_d = raw.get("camera", {})
        self._vio_d = raw.get("vio", {})
        self._fe_d = raw.get("frontend", {})
        self._lidar_d = raw.get("lidar", {})

    @property
    def camera(self):
        return camera_from_dict(self._cam_d)

    @property
    def vio(self):
        return vio_config_from_dict(self._vio_d, self.camera)

    @property
    def frontend(self):
        return frontend_config_from_dict(self._fe_d, self.camera)

    @property
    def lidar(self):
        return lidar_config_from_dict(self._lidar_d)

    def vil(self):
        """Complete VilConfig from YAML alone — what `cli run --config`
        builds (reference: the per-dataset config directories
        gtsam_fusion/config/{carla,san_rafael}/)."""
        from .fusion import vil as VIL

        vio = self.vio
        fe = self.frontend
        if vio.photo_levels > fe.pyramid_levels:
            raise ValueError(
                f"vio.photo_levels={vio.photo_levels} exceeds "
                f"frontend.pyramid_levels={fe.pyramid_levels}: the direct "
                f"photometric update samples the tracker's pyramid and "
                f"cannot reach deeper levels than it builds")
        return VIL.VilConfig(vio=vio, lidar=self.lidar, gate=self.gate,
                             fusion=self.fusion)


def load(path: str) -> SystemConfig:
    return SystemConfig(_load_yaml(path))
