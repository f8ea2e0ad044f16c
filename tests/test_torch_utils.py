"""The port's checkpoint and tracing utilities, against the JAX package's
where they meet: a checkpoint written by either package restores into the
other's template (the fusion engine state and the LiDAR odometry state),
with the same ``.npz`` keys, values bit for bit."""

import json
import os
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vil_sensor_fusion_tpu import fusion as JFU
from vil_sensor_fusion_tpu import utils as JU
from vil_sensor_fusion_tpu.frontends import lidar as JLi
from vil_sensor_fusion_tpu.frontends.lidar import voxelmap as JVM
from vil_sensor_fusion_tpu_torch import _tree, convert
from vil_sensor_fusion_tpu_torch import fusion as TFU
from vil_sensor_fusion_tpu_torch import utils as TU
from vil_sensor_fusion_tpu_torch.frontends import lidar as TLi

DT = jnp.float32
POSE0 = np.array([0.9, 0.1, -0.3, 0.3, 1.0, 2.0, 0.5])
POSE0[:4] /= np.linalg.norm(POSE0[:4])


def _engine_states():
    """(JAX state, port template) of one fusion engine configuration."""
    cfg = JFU.FusionConfig()
    j = JFU.init(cfg, jnp.asarray(POSE0, DT), jnp.zeros(3, DT),
                 jnp.zeros(6, DT), jnp.asarray(0.25, DT))
    c = convert.to_torch(cfg, "cpu")
    t = TFU.init(c, torch.tensor(POSE0, dtype=torch.float32),
                 torch.zeros(3), torch.zeros(6), torch.tensor(0.25))
    return j, t


def _lidar_states():
    cfg = JLi.LidarOdomConfig(corner_map=JVM.VoxelMapConfig(capacity=512),
                              surf_map=JVM.VoxelMapConfig(capacity=1024))
    j = JLi.odometry.init(cfg, DT, pose0=jnp.asarray(POSE0, DT))
    t = TLi.odometry.init(convert.to_torch(cfg, "cpu"), torch.float32,
                          pose0=torch.tensor(POSE0, dtype=torch.float32))
    return j, t


STATES = {"engine": _engine_states, "lidar_odometry": _lidar_states}


def _filled_numpy(tree, seed):
    """Random values of each leaf's shape and dtype (integers small, bools
    random), as numpy, in ``jax.tree_util`` leaf order."""
    rng = np.random.default_rng(seed)
    out = []
    for x in jax.tree_util.tree_leaves(tree):
        x = np.asarray(x)
        if x.dtype.kind == "f":
            out.append(rng.normal(size=x.shape).astype(x.dtype))
        elif x.dtype.kind == "b":
            out.append(rng.uniform(size=x.shape) > 0.5)
        else:
            out.append(rng.integers(0, 9, x.shape).astype(x.dtype))
    return out


def _keys(path):
    with np.load(path) as z:
        return set(z.files)


@pytest.mark.parametrize("state", sorted(STATES))
def test_checkpoint_keys_match_jax(state, tmp_path):
    j, t = STATES[state]()
    JU.save(tmp_path / "j.npz", j)
    TU.save(tmp_path / "t.npz", t)
    assert _keys(tmp_path / "t.npz") == _keys(tmp_path / "j.npz")
    assert len(_keys(tmp_path / "t.npz")) == len(jax.tree_util.tree_leaves(j))


@pytest.mark.parametrize("state", sorted(STATES))
def test_jax_checkpoint_restores_into_port_template(state, tmp_path):
    j, t = STATES[state]()
    leaves = _filled_numpy(j, seed=1)
    j = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(j),
                                     [jnp.asarray(x) for x in leaves])
    JU.save(tmp_path / "j.npz", j)
    back = TU.restore(tmp_path / "j.npz", t)
    assert type(back) is type(t)
    got = _tree.tree_leaves(back)
    assert len(got) == len(leaves)
    for g, tmpl, want in zip(got, _tree.tree_leaves(t), leaves):
        assert isinstance(g, torch.Tensor) and g.dtype == tmpl.dtype
        np.testing.assert_array_equal(g.numpy(), want)


@pytest.mark.parametrize("state", sorted(STATES))
def test_port_checkpoint_restores_into_jax_template(state, tmp_path):
    j, t = STATES[state]()
    leaves = _filled_numpy(j, seed=2)
    it = iter(leaves)
    t = _tree.tree_map(lambda x: torch.as_tensor(next(it)), t)
    TU.save(tmp_path / "t.npz", t)
    back = JU.restore(tmp_path / "t.npz", j)
    for g, want in zip(jax.tree_util.tree_leaves(back), leaves, strict=True):
        np.testing.assert_array_equal(np.asarray(g), want)


def test_none_leaves_are_dropped_as_jax_drops_them(tmp_path):
    jt = {"b": (jnp.ones(2), None), "a": None, "c": [jnp.zeros(3)]}
    tt = {"b": (torch.ones(2), None), "a": None, "c": [torch.zeros(3)]}
    JU.save(tmp_path / "j.npz", jt)
    TU.save(tmp_path / "t.npz", tt)
    assert _keys(tmp_path / "t.npz") == _keys(tmp_path / "j.npz") == {
        "['b']//[0]", "['c']//[0]"}
    back = TU.restore(tmp_path / "j.npz", tt)
    assert back["a"] is None and back["b"][1] is None
    assert torch.equal(back["b"][0], torch.ones(2))


def test_checkpoint_round_trip(tmp_path):
    _, es = _engine_states()
    es = _tree.tree_map(lambda x: x + 1 if x.is_floating_point() else x, es)
    TU.save(tmp_path / "es.npz", es)
    _, template = _engine_states()
    template = _tree.tree_map(
        lambda x: x * 0 - 1.0 if x.is_floating_point() else x, template)
    back = TU.restore(tmp_path / "es.npz", template)
    assert type(back) is type(es)
    for a, b in zip(_tree.tree_leaves(es), _tree.tree_leaves(back)):
        assert b.dtype == a.dtype and b.device == a.device
        assert torch.equal(a, b)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp.npz")]


@pytest.mark.parametrize("template, error", [
    ({"a": torch.zeros(4)}, ValueError),               # shape
    ({"a": torch.zeros(3, dtype=torch.int32)}, ValueError),  # dtype kind
    ({"b": torch.zeros(3)}, KeyError),                 # missing leaf
])
def test_checkpoint_refusals(tmp_path, template, error):
    TU.save(tmp_path / "s.npz", {"a": torch.zeros(3)})
    with pytest.raises(error):
        TU.restore(tmp_path / "s.npz", template)


def test_checkpoint_manager_retention_and_resume(tmp_path):
    mgr = TU.CheckpointManager(str(tmp_path), keep=2)
    _, es = _engine_states()
    for step in (1, 5, 9):
        mgr.save(step, es)
    assert mgr.steps() == [5, 9]
    assert mgr.latest_step() == 9
    assert sorted(os.listdir(tmp_path)) == ["ckpt_000000005.npz",
                                            "ckpt_000000009.npz"]
    step, state = mgr.restore_latest(es)
    assert step == 9
    for a, b in zip(_tree.tree_leaves(es), _tree.tree_leaves(state)):
        assert torch.equal(a, b)
    empty = TU.CheckpointManager(str(tmp_path / "none"))
    step, state = empty.restore_latest(es)
    assert step is None and state is es


def test_stage_timer_sums():
    timer = TU.StageTimer()
    for _ in range(3):
        with timer.stage("a") as out:
            time.sleep(0.01)
            out.value = torch.ones(2) * 2
    got = timer.time("b", lambda x: x + 1, torch.zeros(3))
    assert torch.equal(got, torch.ones(3))
    s = timer.summary()
    assert s["a"]["calls"] == 3 and s["b"]["calls"] == 1
    assert s["a"]["total_s"] == pytest.approx(3 * s["a"]["mean_s"])
    assert s["a"]["min_s"] >= 0.01 and s["a"]["max_s"] >= s["a"]["min_s"]
    assert json.loads(timer.json()) == s


def test_annotate_and_device_trace_on_the_cpu(tmp_path):
    """``device_trace`` records the program's spans (the port's counterpart
    of JAX's ``annotate`` is ``span``) and writes them into its trace as a
    track of their own, on the profiler's clock, without putting them among
    the profiler's events."""
    a, b = torch.ones(64, 64), torch.ones(64, 64)
    with TU.device_trace(str(tmp_path), device="cpu") as prof:
        with TU.span("port_stage"):
            TU.count("port_items", 2)
            a @ b
    assert "port_stage" not in {e.key for e in prof.key_averages()}
    doc = json.loads((tmp_path / "trace.json").read_text())
    events = doc["traceEvents"]
    stage, = [e for e in events if e.get("name") == "port_stage"]
    mm, = [e for e in events if e.get("name") == "aten::mm"]
    assert stage["cat"] == "program_span" and stage["args"]["parent"] == -1
    assert stage["pid"] != mm["pid"]
    assert stage["ts"] <= mm["ts"] + 1.0           # µs; float rounding
    assert mm["ts"] + mm["dur"] <= stage["ts"] + stage["dur"] + 1.0
    assert doc["programCounts"] == {"port_items": 2}
