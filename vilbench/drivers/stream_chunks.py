"""Streaming: one drive handed to the estimator in short chunks, every
stage's state carried from chunk to chunk, the next chunk handed in when
the last one's fused poses are synced (a closed loop of one online
client). A unit is one chunk: ``frontend.pyramids_batch`` →
``candidates_batch`` → ``soak.estimator_chunk``, as ``soak.run_soak``'s
loop runs it.

Configuration: the soak's rig (``cam_w``, ``cam_h``, ``landmarks``), the
``world`` and its ``world_length_m``, the drive's ``speed_mps``,
``chunk_s`` and the streamed ``duration_s``, all rendered in set-up by the
reference's generator (``reference/pipeline.render_chunk``) on a world
drawn from the seed. The drive is long enough that no window runs out of
it at several times today's rate; a drive that does run out starts again
from a fresh state, and the run says so. Traffic parameters (``params``):
``warm_chunks`` streamed in set-up, after which the window continues with
the carried state; ``own_chunks`` and ``compare_pairs`` for the check;
``trace_chunks`` in the profiler slice.

The check runs the reference over the drive's first ``own_chunks`` chunks
from its own fresh state, and over ``compare_pairs`` pairs of consecutive
window chunks drawn from the seed, each from the program's state before
the pair, taken over leaf by leaf by field path: the reference cannot
replay the whole window inside its length, and the pair's second chunk
holds the handoff (its VIO and the first chunk's sweep at its first
solve). Each compared chunk's outputs and the state it carries out are
compared.
"""

from __future__ import annotations

import time

import torch

from vilbench.harness import Spans
from vilbench.reference import compare as C
from vilbench.reference import pipeline as R

STAGES = ("frontend_pyr", "frontend_detect", "estimator")
DTYPE = torch.float32


def tree_paths(tree, prefix: str = "") -> dict:
    """Every leaf of a state by its field path (``engine.smoother.key0``):
    NamedTuple fields and dict keys by name, tuple items by index."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, (tuple, list)):
        items = [(f"{i}", v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    out = {}
    for name, v in items:
        out.update(tree_paths(v, f"{prefix}.{name}" if prefix else name))
    return out


def schema_gaps(template, state) -> list[str]:
    """What keeps ``state`` from standing in for ``template``: each leaf
    the template has and the state lacks, or holds with another shape or
    dtype, by its path. Leaves only the state has are the program's own
    and are not read."""
    have = tree_paths(state)
    gaps = []
    for path, t in tree_paths(template).items():
        if path not in have:
            gaps.append(f"{path}: missing")
            continue
        v = have[path]
        if isinstance(t, torch.Tensor):
            if not isinstance(v, torch.Tensor):
                gaps.append(f"{path}: not a tensor")
            elif v.shape != t.shape or v.dtype != t.dtype:
                gaps.append(f"{path}: {tuple(v.shape)} {v.dtype}, the "
                            f"reference's {tuple(t.shape)} {t.dtype}")
    return gaps


def take_over(template, state):
    """The program's ``state`` in the reference's types, leaf by leaf by
    field path; raises naming every leaf that does not fit."""
    gaps = schema_gaps(template, state)
    if gaps:
        raise ValueError("the program's carried state does not fit the "
                         "reference's: " + "; ".join(gaps))
    have = tree_paths(state)
    leaves = iter([have[p] for p in tree_paths(template)])

    def take(_):
        v = next(leaves)
        return v.clone() if isinstance(v, torch.Tensor) else v

    return R.tree_map(take, template)


def _exact(path: str, leaf) -> bool:
    """Leaves a sound run reproduces exactly: counters, keys and flags."""
    last = path.rsplit(".", 1)[-1]
    return isinstance(leaf, torch.Tensor) and (
        not leaf.dtype.is_floating_point or last.endswith("valid")
        or last == "has_last")


def state_readings(prog_state, ref_state) -> dict:
    """The carried state after a chunk: ``flags_mismatch`` counts the
    entries of the engine's exact leaves (keys, ring pointers, factor and
    IMU validity, ``has_last``) and of the tracker's and VIO's slot
    validity that differ; ``engine_gap_m`` is the largest translation gap
    of the engine's window and last poses."""
    have = tree_paths(prog_state)
    flags, gap = 0, 0.0
    for path, r in tree_paths(ref_state).items():
        p = have[path]
        if path.startswith("engine.") and _exact(path, r) or path in (
                "tracker.valid", "vio.lm_valid"):
            flags += int((p.detach().cpu() != r.detach().cpu()).sum())
        elif path in ("engine.smoother.states.poses", "engine.last_pose"):
            gap = max(gap, C.trans_gap(p, r))
    return dict(flags_mismatch=flags, engine_gap_m=gap)


def chunk_readings(prog_out, ref_out, prog_state, ref_state) -> dict:
    fields = ("vio", "lidar", "fused")
    r = C.readings({f: getattr(prog_out, f) for f in fields},
                   {f: getattr(ref_out, f) for f in fields})
    s = state_readings(prog_state, ref_state)
    flags = sum(C.mismatches(getattr(prog_out.fused, f),
                             getattr(ref_out.fused, f))
                for f in ("healthy", "solved"))
    flags += C.mismatches(prog_out.gate.keep, ref_out.gate.keep)
    return dict(r, flags_mismatch=s["flags_mismatch"] + flags,
                engine_gap_m=s["engine_gap_m"])


def merge(a: dict, b: dict) -> dict:
    """Two chunks' readings as one: lists joined, the larger number kept
    (a NaN kept)."""
    out = dict(a)
    for k, v in b.items():
        if k not in out:
            out[k] = v
        elif isinstance(v, list):
            out[k] = out[k] + v
        elif out[k] == out[k] and (v != v or v > out[k]):
            out[k] = v
    return out


class StreamCell:
    stage_names = STAGES

    def __init__(self, ctx):
        conf, p = ctx.config, ctx.params
        self.ctx, self.limits = ctx, ctx.limits
        if conf.get("photometric", False):
            raise ValueError("the reference has no photometric VIO")
        dev = ctx.device
        self.chunk = float(conf["chunk_s"])
        self.n_chunks = int(round(float(conf["duration_s"]) / self.chunk))
        self.warm_chunks = int(p["warm_chunks"])
        self.own_chunks = int(p["own_chunks"])
        self.compare_pairs = int(p["compare_pairs"])
        self.trace_units = int(p["trace_chunks"])
        if not 1 <= self.own_chunks <= self.warm_chunks + 1:
            raise ValueError("own_chunks runs from 1 to warm_chunks + 1: "
                             "the check needs them all streamed")
        self.ref_rig = R.soak_rig(int(conf["cam_w"]), int(conf["cam_h"]),
                                  int(conf["landmarks"]))
        self.traj = R.soak_trajectory(float(conf["speed_mps"]))
        make_world = getattr(R.rc, f"{conf['world']}_world")
        world = make_world(length=float(conf["world_length_m"]),
                           seed=ctx.seed, dtype=DTYPE, device=dev)
        self.ref_idx = R.chunk_indices(self.chunk, DTYPE, dev)
        self.inputs = [R.render_chunk(world, self.traj, self.ref_rig,
                                      self.ref_idx, k * self.chunk,
                                      self.chunk, DTYPE, dev)
                       for k in range(self.n_chunks)]
        self.t_off = [torch.as_tensor(k * self.chunk, dtype=DTYPE,
                                      device=dev)
                      for k in range(self.n_chunks)]
        Tv, Tl = len(self.ref_idx.vio_rel), len(self.ref_idx.lidar_rel)
        self.events_per_unit = Tv + Tl
        self.counts = {"step": Tv + Tl, "sweep": Tl, "frame": Tv}
        if ctx.side == "program":
            self._setup_program(conf)
        else:
            self._setup_control()
        self.state = self.fresh()
        self.k = 0
        self.restarts = 0
        self.history = []       # (chunk, state before, state after, output)

    def _setup_program(self, conf):
        from vil_sensor_fusion_tpu_torch import soak as S
        from vil_sensor_fusion_tpu_torch.frontends.lidar import Sweep
        from vil_sensor_fusion_tpu_torch.frontends.vio import frontend as F
        from vil_sensor_fusion_tpu_torch.ops import knn as K

        self.K = K
        dev = self.ctx.device
        if dev.type == "cuda":
            K.build_kernel()
        rig = S.soak_rig(int(conf["cam_w"]), int(conf["cam_h"]),
                         int(conf["landmarks"]), dtype=DTYPE)
        idx = S.chunk_indices(self.chunk, DTYPE, dev)
        self.fresh = lambda: S.fresh_state(rig, self.traj, DTYPE, dev)
        sweeps = [Sweep(*x.sweeps) for x in self.inputs]

        def step(k, state, rec):
            x = self.inputs[k]
            py = rec.time("frontend_pyr", F.pyramids_batch, rig.frontend,
                          x.images)
            cand = rec.time("frontend_detect", F.candidates_batch,
                            rig.frontend, x.images, x.pts_cam, x.sw_msk)
            return rec.time("estimator", S.estimator_chunk, rig, idx, state,
                            py, *cand, x.imu_w, sweeps[k], self.t_off[k],
                            *x.imu)

        self.step = step

    def _setup_control(self):
        dev = self.ctx.device
        self.fresh = lambda: R.fresh_state(self.ref_rig, self.traj, DTYPE,
                                           dev)

        def step(k, state, rec):
            with R.tf32(True):
                return self._ref_chunk(k, state)

        self.step = step

    def _ref_chunk(self, k, state):
        x, fe = self.inputs[k], self.ref_rig.frontend
        py = R.F.pyramids_batch(fe, x.images)
        cand = R.F.candidates_batch(fe, x.images, x.pts_cam, x.sw_msk)
        return R.estimator_chunk(self.ref_rig, self.ref_idx, state, py,
                                 *cand, x.imu_w, x.sweeps, self.t_off[k],
                                 *x.imu)

    def _advance(self, rec):
        if self.k == self.n_chunks:          # the drive ran out
            self.state, self.k = self.fresh(), 0
            self.restarts += 1
            self.ctx.log(f"the drive ran out after {self.n_chunks} chunks; "
                         "it starts again from a fresh state")
        k, before = self.k, self.state
        self.state, out = self.step(k, before, rec)
        self.k += 1
        self.history.append((k, before, self.state, out))

    def warm(self):
        launches = getattr(self, "K", None) and self.K.KERNEL_LAUNCHES
        for _ in range(self.warm_chunks):
            self._advance(Spans())
        self.ctx.sync()
        if launches is not None:
            per_chunk = (self.K.KERNEL_LAUNCHES - launches) / self.warm_chunks
            self.ctx.log(f"k-NN kernel launches per chunk: {per_chunk}")

    def unit(self, rec):
        t0 = time.perf_counter()
        self._advance(rec)
        self.ctx.sync()
        return {"latency_s": time.perf_counter() - t0,
                "counts": dict(self.counts)}

    def release(self):
        self.state = self.step = self.fresh = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, rng):
        """The drive's first ``own_chunks`` chunks from the reference's own
        fresh state, then pairs of consecutive later chunks from the
        program's state before each pair: a LiDAR sweep reaches the fused
        poses only at the next chunk's first solve, so each pair's second
        chunk holds the first one's registration."""
        h, self.history = self.history, []
        own = h[:self.own_chunks]
        pairs = [h[i:i + 2] for i in range(self.own_chunks, len(h) - 1)
                 if h[i + 1][0] == h[i][0] + 1]
        pick = sorted(rng.choice(len(pairs), size=min(len(pairs),
                                                      self.compare_pairs),
                                 replace=False).tolist())
        template = R.fresh_state(self.ref_rig, self.traj, DTYPE,
                                 self.ctx.device)
        out = []
        for case in [own] + [pairs[i] for i in pick]:
            own_start = case is own
            ref_state = (template if own_start
                         else take_over(template, case[0][1]))
            reading = {}
            for k, _, prog_after, prog in case:
                gaps = schema_gaps(template, prog_after)
                if gaps:
                    raise ValueError(f"chunk {k} carries a state that does "
                                     "not fit the reference's: "
                                     + "; ".join(gaps))
                with R.tf32(False):
                    ref_state, ref = self._ref_chunk(k, ref_state)
                reading = merge(reading, chunk_readings(prog, ref,
                                                        prog_after,
                                                        ref_state))
                self.ctx.log(
                    f"check chunk {k} ({'own' if own_start else 'pair'}): "
                    "events rejected by the health guard "
                    f"{int((prog.fused.healthy == 0).sum())} / "
                    f"{int((ref.fused.healthy == 0).sum())}, solves "
                    f"{int(prog.fused.solved.sum())} / "
                    f"{int(ref.fused.solved.sum())}, sweeps kept "
                    f"{int(prog.gate.keep.sum())} / {int(ref.gate.keep.sum())}"
                    " (program / reference)")
            out.append(reading)
        self.ctx.sync()
        return out, self.limits


def setup(ctx):
    return StreamCell(ctx)
