"""One run of one cell: set-up, a timed window of whole units, an optional
profiler slice, the check against the reference, and the result line.

A cell (``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``), its driver (``drivers/<driver>.py``) and the
driver's traffic parameters. A driver's ``setup(ctx)`` returns a cell
object with:

- ``events_per_unit``: fused odometry events one unit completes (all
  lanes);
- ``warm()``: the warm-up, on the cell's own shapes;
- ``unit(rec)``: one unit of work, ending in a device sync; returns a dict
  with ``latency_s`` (from handing the unit in to its results being
  synced) and ``counts`` (what the unit did, for the span metrics);
- ``trace_units``: how many units the profiler slice covers;
- ``check(rng)``: after the window, the comparison with the reference, as
  ``(readings per unit compared, limits)``;
- ``release()``: drops what the check does not need.

``rec`` is the span recorder: the driver hands it to the program's stage
entry points as their timer (``.time(name, fn, *args)``).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace

import numpy as np

BASE = Path(__file__).resolve().parent
ROOT = BASE.parent

# Top-level module names a run must not hold once its window has closed.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "vil_sensor_fusion_tpu")


def load_json(base: Path, kind: str, name: str) -> dict:
    path = base / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(base: Path, kind: str, name: str) -> ModuleType:
    """``<base>/<kind>/<name>.py`` as module ``vilbench.<kind>.<name>``."""
    path = base / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    mod_name = f"vilbench.{kind}.{name.replace('-', '_').replace('.', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_spec(root: Path, name: str) -> dict:
    """Everything a run of cell ``name`` needs, by name: its entry in
    ``BENCHMARK.json``, its workload and configuration files, the units of
    its end-to-end metrics and the per-layer metrics it reports."""
    base = root / "vilbench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    work = load_json(base, "workloads", name)
    if work["config"] != entry["config"]:
        raise ValueError(f"{name}: BENCHMARK.json names configuration "
                         f"{entry['config']!r}, its file {work['config']!r}")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())

    def applies(m):
        return name in m.get("workloads", [name])

    return dict(
        name=name, base=base, entry=entry, workload=work, config=config,
        chips=int(entry["chips"]),
        end_to_end={m["name"]: m for m in bench["end_to_end"] if applies(m)},
        per_layer={m["name"]: m for m in bench["per_layer"] if applies(m)})


class Spans:
    """The harness's span recorder, handed to the program as its stage
    timer. Off (the timed run), ``time`` only calls. On, it waits for the
    stage's device work and adds its wall to the stage's total; with
    ``label`` it also names the stage in a profiler trace."""

    def __init__(self, sync=None, label: bool = False):
        self._sync = sync
        self._label = label
        self.total: dict[str, float] = {}

    def time(self, name: str, fn, *args, **kwargs):
        if self._label:
            import torch

            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        if self._sync is None:
            return fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self._sync()
        self.total[name] = self.total.get(name, 0.0) + time.perf_counter() - t0
        return out


def window(cell, seconds: float, rec: Spans) -> dict:
    """Whole units back to back until ``seconds`` have passed; no unit
    starts after that. The rate is every event of the completed units over
    the time from the window's start to the end of the last unit."""
    units = []
    t0 = time.perf_counter()
    while True:
        c0 = time.process_time()
        info = cell.unit(rec)
        t1 = time.perf_counter()
        units.append(dict(info, cpu_s=time.process_time() - c0))
        if t1 - t0 >= seconds:
            break
    return summarize(units, t1 - t0, cell.events_per_unit)


def summarize(units: list, elapsed: float, events_per_unit: int) -> dict:
    events = events_per_unit * len(units)
    lat = [u["latency_s"] for u in units]
    counts: dict[str, int] = {}
    for u in units:
        for k, v in u.get("counts", {}).items():
            counts[k] = counts.get(k, 0) + v
    return dict(units=len(units), events=events, elapsed_s=elapsed,
                events_per_s=events / elapsed, latencies_s=lat,
                cpu_s=[u.get("cpu_s", 0.0) for u in units],
                update_p90_s=p90(lat), counts=counts)


def p90(values) -> float:
    """The 90th percentile, linear between order statistics (numpy's
    default, ``statistics.quantiles(method="inclusive")``)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), 90))


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN_MODULES})


def judge(readings: list[dict], limits: dict) -> tuple[dict, int]:
    """Each number beside its limit, and how many units exceed some limit.
    A number is its worst reading over the units compared, or, for a list
    per unit (``*_median``), the median of all the units' values pooled,
    which fails every unit when it is over. A NaN fails."""
    worst: dict = {}
    bad = [False] * len(readings)
    for k, lim in limits.items():
        if readings and isinstance(readings[0][k], list):
            pooled = [float(v) for r in readings for v in r[k]]
            v = float(np.median(pooled)) if pooled else 0.0
            worst[k] = v
            if not (v <= lim):
                bad = [True] * len(readings)
            continue
        for i, r in enumerate(readings):
            v = float(r[k])
            if not (v <= lim):
                bad[i] = True
            w = worst.get(k)
            if w is None or v != v or (w == w and v > w):
                worst[k] = v          # a NaN, once read, stays the worst
    return ({k: {"value": worst[k], "limit": limits[k]} for k in limits},
            sum(bad))


def run(name: str, seed: int, seconds: float, trace: bool, device,
        root: Path = ROOT, side: str = "program", log=None,
        t_start: float | None = None,
        readings_out: list | None = None) -> tuple[dict, list[str]]:
    """One run of cell ``name`` on ``device``: returns the result line and
    the check lines for standard error. ``side`` is ``program`` (the port)
    or ``control`` (the reference at the next precision down in the port's
    place, for setting limits). ``readings_out``, where given, receives
    every unit's readings, those that no limit judges too."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: None)
    spec = cell_spec(root, name)
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    work = spec["workload"]
    driver = load_module(spec["base"], "drivers", work["driver"])
    t_imp = time.perf_counter()
    ctx = SimpleNamespace(device=dev, seed=int(seed), config=spec["config"],
                          traffic=work["traffic"], params=work["params"],
                          limits=work["limits"],
                          side=side, sync=sync, log=log)
    cell = driver.setup(ctx)
    sync()
    t_inputs = time.perf_counter()
    cell.warm()
    sync()
    t_warm = time.perf_counter()
    setup_s = t_warm - t_start
    log(f"setup {setup_s:.3f} s: imports {t_imp - t_start:.3f}, inputs and "
        f"states {t_inputs - t_imp:.3f}, warm-up {t_warm - t_inputs:.3f}")
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    gc.collect()
    gc.freeze()       # set-up's objects out of the collector's way

    rec = Spans(sync=sync if trace else None)
    gc_before = [g["collections"] for g in gc.get_stats()]
    win = window(cell, seconds, rec)
    gc_runs = [g["collections"] - b for g, b in zip(gc.get_stats(),
                                                     gc_before)]
    gc.unfreeze()
    log(f"window: {win['units']} units, {win['events']} events in "
        f"{win['elapsed_s']:.3f} s; unit latencies "
        + " ".join(f"{v:.3f}" for v in win["latencies_s"])
        + "; their process CPU seconds "
        + " ".join(f"{v:.3f}" for v in win["cpu_s"])
        + f"; garbage collections by generation {gc_runs}")

    result: dict = {}
    if trace:
        from . import trace as TR

        readers = {m: load_module(spec["base"], "metrics", m)
                   for m in spec["per_layer"]}
        observed = {m: [] for m, r in readers.items() if hasattr(r, "observe")}
        sl = TR.profile_slice(cell, sync, cuda, log, [
            readers[m].observe(observed[m]) for m in observed])
        log(f"profiler slice: {sl.units} units, {sl.events} events in "
            f"{sl.wall_s:.3f} s, {len(sl.cpu_ops)} host ops, "
            f"{len(sl.device_ops)} device ops (read in {sl.read_s:.1f} s)")
        mctx = SimpleNamespace(spans=rec.total, counts=win["counts"],
                               window=win, slice=sl, observed=observed)
        metrics = {}
        for mname, m in spec["per_layer"].items():
            v = readers[mname].read(mctx)
            if v is not None:
                metrics[mname] = {"value": float(v), "unit": m["unit"]}
        busy = TR.busy_seconds(sl)
        device_extra = {"busy_s": busy, "window_s": sl.wall_s}
        result["breakdown"] = TR.breakdown(sl)
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"},
                   "events_per_s": {"value": win["events_per_s"],
                                    "unit": "events/s"}}
        if "update_p90_s" in spec["end_to_end"]:
            log(f"update_p90_s over {len(win['latencies_s'])} updates")
            metrics["update_p90_s"] = {"value": win["update_p90_s"],
                                       "unit": "s"}
        metrics = {k: dict(v, unit=spec["end_to_end"][k]["unit"])
                   for k, v in metrics.items() if k in spec["end_to_end"]}
        device_extra = {}
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0

    cell.release()
    rng = np.random.default_rng(int(seed) & 0xFFFFFFFFFFFF)
    readings, limits = cell.check(rng)
    if readings_out is not None:
        readings_out.extend(readings)
    checks, failed = judge(readings, limits)
    correct = failed == 0 and bool(readings)
    lines = [f"check {k}: {c['value']!r} limit {c['limit']!r}"
             for k, c in checks.items()]
    lines.append(f"check units compared: {len(readings)}, over a limit: "
                 f"{failed}")
    result = dict(
        correct=correct, attempted=win["units"], failed=failed,
        metrics=metrics,
        device=dict(platform="gpu" if cuda else dev.type,
                    kind=(torch.cuda.get_device_name(dev) if cuda
                          else "cpu"),
                    count=spec["chips"] if cuda else 1,
                    memory_peak_bytes=peak, **device_extra),
        **result, checks=checks)
    return result, lines

