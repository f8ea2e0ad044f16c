"""The port's YAML configs and CLI against the JAX package's.

- Every shipped config and the inline YAMLs of ``test_config_cli.py``
  build the port's config NamedTuples equal, field for field and exactly,
  to the JAX package's.
- ``convert`` writes the same arrays and prints the same JSON as JAX's on
  the same bag; ``fuse-bag`` prints the same event count and time range
  and writes the same ``t x y z`` rows, within 1e-5 m (both run the
  fusion engine in float32, in another order of operations).
- ``record`` → ``run --bag`` (geometric and photometric VIO) and ``run
  --scenario`` run in-process on the CPU (``--device cpu``) and print the
  JAX CLI's keys; ``--model-devices 2``
  in a world of one process and ``bench --lanes 0`` raise; ``experiments``
  builds the JAX grids' spec lists.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from vil_sensor_fusion_tpu import cli as JCLI
from vil_sensor_fusion_tpu import config as JC
from vil_sensor_fusion_tpu.eval import experiments as JEX
from vil_sensor_fusion_tpu_torch import cli as TCLI
from vil_sensor_fusion_tpu_torch import config as TC
from vil_sensor_fusion_tpu_torch.eval import experiments as TEX

REPO = Path(__file__).resolve().parents[1]

# The inline YAMLs of tests/test_config_cli.py.
INLINE = {
    "min": "sensors:\n  odom: {}\n",
    "small": (
        "camera: {width: 128, height: 96}\n"
        "vio: {num_landmarks: 12}\n"
        "lidar:\n"
        "  two_stage: false\n"
        "  undistort: false\n"
        "  mapping: {iters: 3, degen_eigval: 5.0}\n"
        "filter:\n"
        "  rot_degen_threshold: 4.0\n"
        "  trans_degen_threshold: -6.0\n"
        "  normalize_per_corr: true\n"
        "sensors:\n"
        "  lidar: {optimize_after_odom: false, covariance_linear: 0.2,\n"
        "          covariance_angular: 0.2, max_time_skip: 0.2}\n"
        "  vio: {optimize_after_odom: true, covariance_linear: 0.1,\n"
        "        covariance_angular: 0.1, max_time_skip: 0.1}\n"
        "smoother: {window: 4, between_slots: 8, gn_iters: 3}\n"),
    "fuse_bag": (
        "sensors:\n"
        "  vio:\n"
        "    odom_topic: /rovio/odometry\n"
        "    optimize_after_odom: true\n"
        "    covariance_linear: 0.01\n"
        "    covariance_angular: 0.01\n"
        "    max_time_skip: 0.2\n"
        "imu:\n  topic: /imu/fusion\n"
        "smoother:\n  window: 4\n  gn_iters: 3\n"),
}

# The CLI runs here: the `cli record` rig's 160×120 camera, narrow maps.
CPU_RUN_YAML = (
    "camera: {width: 160, height: 120, fx: 107.0}\n"
    "vio: {num_landmarks: 12}\n"
    "frontend: {n_candidates: 32, min_dist: 10.0}\n"
    "lidar:\n"
    "  mapping: {iters: 3, degen_eigval: 5.0}\n"
    "  corner_map: {capacity: 4096}\n"
    "  surf_map: {capacity: 8192}\n"
    "  submap_corners: 512\n"
    "  submap_surfs: 1024\n"
    "filter:\n"
    "  rot_degen_threshold: 4.0\n"
    "  trans_degen_threshold: -6.0\n"
    "  normalize_per_corr: true\n"
    "sensors:\n"
    "  vio: {optimize_after_odom: true, covariance_linear: 0.2,\n"
    "        covariance_angular: 0.2, max_time_skip: 0.1}\n"
    "  lidar: {covariance_linear: 0.1, covariance_angular: 0.1,\n"
    "          max_time_skip: 0.2}\n"
    "smoother: {window: 4, between_slots: 8, gn_iters: 3}\n")


def _assert_same_config(j, t, path="cfg"):
    """Equal field for field: same NamedTuple names and fields, equal
    Python scalars (the port's configs hold no tensors)."""
    if isinstance(j, tuple) and hasattr(j, "_fields"):
        assert type(t).__name__ == type(j).__name__, path
        assert t._fields == j._fields, path
        for f in j._fields:
            _assert_same_config(getattr(j, f), getattr(t, f), f"{path}.{f}")
    elif isinstance(j, (tuple, list)):
        assert len(t) == len(j), path
        for i, (a, b) in enumerate(zip(j, t)):
            _assert_same_config(a, b, f"{path}[{i}]")
    else:
        assert t is None or type(t) in (bool, int, float, str), (path, t)
        assert t == j, (path, t, j)


def _config_file(name, tmp_path):
    if name in INLINE:
        p = tmp_path / f"{name}.yaml"
        p.write_text(INLINE[name])
        return str(p)
    return str(REPO / "configs" / f"{name}.yaml")


@pytest.mark.parametrize("name", ["carla", "carla_full", "san_rafael",
                                  *INLINE])
def test_config_matches_jax(name, tmp_path):
    path = _config_file(name, tmp_path)
    j, t = JC.load(path), TC.load(path)
    assert t.raw == j.raw
    _assert_same_config(j.vil(), t.vil())
    _assert_same_config(j.frontend, t.frontend)
    _assert_same_config(j.fusion, t.fusion)
    _assert_same_config(j.imu, t.imu)
    assert t.imu_topic == j.imu_topic
    assert t.sensor_topics == j.sensor_topics


def test_photo_levels_beyond_the_pyramid_refused(tmp_path):
    p = tmp_path / "bad.yaml"
    p.write_text("vio: {photo_levels: 4}\nfrontend: {pyramid_levels: 3}\n")
    with pytest.raises(ValueError, match="photo_levels"):
        TC.load(str(p)).vil()


@pytest.fixture(scope="module")
def odometry_bag(tmp_path_factory):
    """test_config_cli.py's bag: 200 IMU samples at rest, 10 odometry
    messages, one chunk."""
    sys.path.insert(0, str(REPO / "tests"))
    import test_rosbag_io as W

    recs = b""
    recs += W._conn_record(0, "/imu/fusion", "sensor_msgs/Imu")
    recs += W._conn_record(1, "/rovio/odometry", "nav_msgs/Odometry")
    for i in range(200):
        t = 0.005 * i
        recs += W._msg_record(0, t, W._imu_msg(t, [0, 0, 0], [0, 0, 9.81]))
    for i in range(10):
        t = 0.1 * (i + 1)
        recs += W._msg_record(1, t, W._odom_msg(
            t, [0.01 * i, 0, 0], [0, 0, 0, 1],
            np.eye(6).reshape(-1) * 0.01, np.eye(6).reshape(-1) * 0.01))
    bag = tmp_path_factory.mktemp("mini") / "mini.bag"
    W._write_bag(bag, recs, chunked=True)
    return bag


def _json_out(capsys):
    out = capsys.readouterr().out
    return json.loads(out[out.index("{"):])


def test_convert_matches_jax(odometry_bag, tmp_path, capsys):
    JCLI.main(["convert", "--bag", str(odometry_bag),
               "--out", str(tmp_path / "j.npz")])
    want = _json_out(capsys)
    TCLI.main(["convert", "--bag", str(odometry_bag),
               "--out", str(tmp_path / "t.npz")])
    got = _json_out(capsys)
    assert got["topics"] == want["topics"]
    with np.load(tmp_path / "j.npz") as zj, np.load(tmp_path / "t.npz") as zt:
        assert sorted(zt.files) == sorted(zj.files)
        for k in zj.files:
            np.testing.assert_array_equal(zt[k], zj[k], k)
        assert len(zt["imu_fusion_t"]) == 200


def test_fuse_bag_matches_jax(odometry_bag, tmp_path, capsys):
    cfg = _config_file("fuse_bag", tmp_path)
    JCLI.main(["fuse-bag", "--bag", str(odometry_bag), "--config", cfg,
               "--out", str(tmp_path / "j.txt")])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    TCLI.main(["fuse-bag", "--bag", str(odometry_bag), "--config", cfg,
               "--out", str(tmp_path / "t.txt"), "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["events"] == want["events"] == 10
    np.testing.assert_allclose(got["t_range"], want["t_range"], atol=1e-6)
    lj = (tmp_path / "j.txt").read_text().splitlines()
    lt = (tmp_path / "t.txt").read_text().splitlines()
    assert lt[0] == lj[0] == "# t x y z"
    np.testing.assert_allclose(np.loadtxt(tmp_path / "t.txt"),
                               np.loadtxt(tmp_path / "j.txt"), atol=1e-5)


def test_fuse_bag_resumes_from_a_checkpoint(odometry_bag, tmp_path, capsys):
    """An engine state written by `run --checkpoint` restores into the
    fuse-bag template; the wrong state's shapes are refused."""
    from vil_sensor_fusion_tpu_torch import fusion as TFU
    from vil_sensor_fusion_tpu_torch import utils as TU
    import torch

    cfg = TC.load(_config_file("fuse_bag", tmp_path))
    pose0 = torch.tensor([1.0, 0, 0, 0, 0, 0, 0])
    es = TFU.init(cfg.fusion, pose0, torch.zeros(3), torch.zeros(6),
                  torch.tensor(0.5))
    TU.save(tmp_path / "ok.npz", es)
    TCLI.main(["fuse-bag", "--bag", str(odometry_bag),
               "--config", _config_file("fuse_bag", tmp_path),
               "--resume-from", str(tmp_path / "ok.npz"), "--device", "cpu"])
    assert json.loads(capsys.readouterr().out)["events"] == 10
    big = TFU.init(cfg.fusion._replace(smoother=cfg.fusion.smoother._replace(
        window=6)), pose0, torch.zeros(3), torch.zeros(6), torch.tensor(0.5))
    TU.save(tmp_path / "bad.npz", big)
    with pytest.raises(ValueError, match="shape"):
        TCLI.main(["fuse-bag", "--bag", str(odometry_bag),
                   "--config", _config_file("fuse_bag", tmp_path),
                   "--resume-from", str(tmp_path / "bad.npz"),
                   "--device", "cpu"])


def test_fix_time_matches_jax(odometry_bag, tmp_path, capsys):
    JCLI.main(["fix-time", "--bag", str(odometry_bag),
               "--out", str(tmp_path / "j.bag")])
    want = _json_out(capsys)
    TCLI.main(["fix-time", "--bag", str(odometry_bag),
               "--out", str(tmp_path / "t.bag")])
    assert _json_out(capsys) == want
    assert (tmp_path / "t.bag").read_bytes() == \
        (tmp_path / "j.bag").read_bytes()


# The keys the JAX cli.py prints: cmd_run (cli.py:186-204) and _run_bag
# (cli.py:125-153).
RUN_KEYS = {"scenario", "events", "fused_ate_rmse_m", "gate_keep_fraction",
            "lidar_trans_logdet_mean", "healthy_fraction", "checkpoint"}
RUN_BAG_KEYS = {"bag", "events", "gate_keep_fraction",
                "lidar_trans_logdet_mean", "healthy_fraction", "checkpoint",
                "fused_ate_rmse_m"}


def test_record_then_run_bag_on_cpu(tmp_path, capsys):
    """`record` writes a raw-sensor bag of the 160×120 rig; `run --bag`
    replays it through the full stack and bounds the fused ATE
    (tests/test_bag_e2e.py:142: < 1.0 m)."""
    bag = str(tmp_path / "town.bag")
    TCLI.main(["record", "--duration", "0.5", "--out", bag,
               "--device", "cpu"])
    meta = _json_out(capsys)
    assert meta == {"bag": bag, "bytes": Path(bag).stat().st_size,
                    "imu_msgs": 120, "lidar_msgs": 5, "image_msgs": 10}
    cfg = tmp_path / "run.yaml"
    cfg.write_text(CPU_RUN_YAML)
    TCLI.main(["run", "--bag", bag, "--config", str(cfg), "--device", "cpu",
               "--checkpoint", str(tmp_path / "ck.npz")])
    out = _json_out(capsys)
    assert set(out) == RUN_BAG_KEYS
    assert out["events"] == 15 and out["healthy_fraction"] == 1.0
    assert out["fused_ate_rmse_m"] < 1.0
    assert out["gate_keep_fraction"] > 0.5
    with np.load(tmp_path / "ck.npz") as z:
        assert ".smoother//.states//.poses" in z.files


def test_run_bag_photometric_on_cpu(tmp_path, capsys):
    """`run --bag --config` with ``vio.use_photometric: true`` replays the
    bag through the direct photometric VIO (no KLT stage) and the rest of
    the stack; `run --scenario` with the same YAML raises the JAX
    ``run_vil``'s ValueError (synthetic tracks feed no photometric
    update)."""
    bag = str(tmp_path / "town.bag")
    TCLI.main(["record", "--duration", "0.5", "--out", bag,
               "--device", "cpu"])
    _json_out(capsys)
    cfg = tmp_path / "photo.yaml"
    cfg.write_text(CPU_RUN_YAML.replace(
        "vio: {num_landmarks: 12}", "vio: {num_landmarks: 12, "
        "use_photometric: true}"))
    assert TC.load(str(cfg)).vil().vio.use_photometric
    TCLI.main(["run", "--bag", bag, "--config", str(cfg), "--device", "cpu"])
    out = _json_out(capsys)
    assert set(out) == RUN_BAG_KEYS - {"checkpoint"}
    assert out["events"] == 15 and out["healthy_fraction"] == 1.0
    assert out["fused_ate_rmse_m"] < 1.0
    assert out["gate_keep_fraction"] > 0.5
    with pytest.raises(ValueError, match="requires photo_inputs"):
        TCLI.main(["run", "--scenario", "town", "--duration", "0.1",
                   "--config", str(cfg), "--device", "cpu"])


def test_run_scenario_on_cpu(tmp_path, capsys):
    cfg = tmp_path / "run.yaml"
    cfg.write_text(CPU_RUN_YAML)
    TCLI.main(["run", "--scenario", "town", "--duration", "0.5",
               "--config", str(cfg), "--device", "cpu",
               "--checkpoint", str(tmp_path / "ck.npz")])
    out = _json_out(capsys)
    assert set(out) == RUN_KEYS
    assert out["events"] == 15
    assert np.isfinite(out["fused_ate_rmse_m"])
    assert out["fused_ate_rmse_m"] < 0.1


@pytest.mark.parametrize("argv, error, match", [
    # --model-devices N > 1 in a world of one process: refused, with the
    # launcher named (tests/test_torch_multihost.py runs it in a world of 2).
    pytest.param(["run", "--model-devices", "2", "--device", "cpu"],
                 RuntimeError, "torchrun --nproc-per-node 2",
                 id="argv0-item 9"),
    pytest.param(["run", "--bag", "x.bag", "--model-devices", "2"],
                 RuntimeError, "world of 2 processes", id="argv1-item 9"),
    # bench is ported (tests/test_torch_bench.py runs it); it refuses a
    # run with no lanes before building anything.
    pytest.param(["bench", "--lanes", "0", "--device", "cpu"], ValueError,
                 "lanes >= 1", id="argv2-item 8"),
])
def test_unported_commands_raise(argv, error, match):
    with pytest.raises(error, match=match):
        TCLI.main(argv)


@pytest.mark.parametrize("argv, grid, kw", [
    (["--smoke"], "smoke_grid", dict(seeds=(0, 1), duration=3.0)),
    (["--smoke", "--seeds", "1", "--duration", "1.5"], "smoke_grid",
     dict(seeds=(0,), duration=1.5)),
    (["--seeds", "3"], "default_grid", dict(seeds=(0, 1, 2), duration=60.0)),
])
def test_experiments_builds_the_jax_grid(argv, grid, kw, monkeypatch,
                                         tmp_path, capsys):
    seen = {}

    def fake(specs, cache_dir, report_dir, device):
        seen.update(specs=specs, cache_dir=cache_dir,
                    report_dir=report_dir, device=device)
        return [{"kind": s.kind} for s in specs]
    monkeypatch.setattr(TEX, "run_and_report", fake)
    TCLI.main(["experiments", *argv, "--long-row", "345",
               "--cache-dir", str(tmp_path / "c"),
               "--report-dir", str(tmp_path / "r"), "--device", "cpu"])
    want = list(getattr(JEX, grid)(**kw)) + [
        JEX.ExperimentSpec(kind="tunnel", duration=345.0, seed=0)]
    assert [dataclasses.asdict(s) for s in seen["specs"]] == \
        [dataclasses.asdict(s) for s in want]
    assert [s.key() for s in seen["specs"]] == [s.key() for s in want]
    assert seen["device"] == "cpu"
    assert seen["cache_dir"] == str(tmp_path / "c")
    assert len(json.loads(capsys.readouterr().out)) == len(want)
