"""The port's oracle report (``vil_sensor_fusion_tpu_torch/oracle_report.py``)
against the JAX package's ``scripts/oracle_report.py`` on the same problem:
the 10 m circle over 1.5 s with 0.02 m of odometry noise drawn from
``numpy.random.default_rng(0)``, windows 4 and 6.

Both sides are float64 with the same Gauss-Newton; the batch MAP's
assembly sums in another order (a scatter-add against a loop over
factors), so every number of a case is held to 1e-9 (absolute, in metres
for the gaps and errors) and the counts exactly; the walls are the
machines' own and are not compared. The JAX side runs in a child process
while the port computes (the spawned child imports this file)."""

import json
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import jax
import numpy as np
import pytest
import torch

from scripts import oracle_report as JOR
from vil_sensor_fusion_tpu_torch import oracle_report as TOR

DUR, NOISE, WINDOWS = 1.5, 0.02, (4, 6)
TOL = 1e-9


def _jax_report(dur, noise, windows):
    """JAX's problem (as numpy) and its case per window."""
    jax.config.update("jax_enable_x64", True)
    pj = JOR.build_problem(dur, noise)
    cases = {w: JOR.run_window(pj, dur, noise, w) for w in windows}
    return jax.tree_util.tree_map(np.asarray, pj), cases


@pytest.fixture(scope="module")
def jax_side():
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(1, mp_context=ctx) as pool:
        yield pool.submit(_jax_report, DUR, NOISE, WINDOWS)


@pytest.fixture(scope="module")
def problems(jax_side):
    """(JAX's problem, the port's problem, JAX's cases, the port's cases)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        pt = TOR.build_problem(DUR, NOISE, device="cpu")
        cases = {w: TOR.run_window(pt, DUR, NOISE, w) for w in WINDOWS}
    finally:
        torch.set_num_threads(n)
    pj, jax_cases = jax_side.result()
    return pj, pt, jax_cases, cases


def _close(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        if k.startswith("wall_"):
            continue
        if isinstance(v, int):
            assert got[k] == v, k
        else:
            assert abs(got[k] - v) <= TOL, (k, got[k], v)


def test_build_problem_matches_jax(problems):
    """The timeline (stamps, noisy poses, sources), the IMU stream, the
    batch MAP's trajectory, its ATE and between count."""
    pj, pt, _, _ = problems
    for f in ("times", "source", "odo_pose", "odo_cov", "keep", "valid"):
        np.testing.assert_allclose(getattr(pt["tl"], f).numpy(),
                                   np.asarray(getattr(pj["tl"], f)),
                                   rtol=0, atol=1e-12, err_msg=f)
    for f in ("times", "accel", "gyro"):
        np.testing.assert_allclose(getattr(pt["imu"], f).numpy(),
                                   np.asarray(getattr(pj["imu"], f)),
                                   rtol=0, atol=1e-10, err_msg=f)
    assert pt["batch"].poses.dtype == torch.float64
    np.testing.assert_allclose(pt["batch_tr"], pj["batch_tr"], rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(pt["gt_tr"], pj["gt_tr"], rtol=0, atol=1e-12)
    assert pt["n_between"] == pj["n_between"] > 40
    assert abs(pt["ate_batch"] - pj["ate_batch"]) <= TOL


@pytest.mark.parametrize("window", WINDOWS)
def test_run_window_matches_jax(problems, window):
    _, _, want, got = problems
    want, got = want[window], got[window]
    _close(got, want)
    assert got["events"] == 45 and got["window"] == window
    assert got["delta_max_m"] < 0.35


def test_main_writes_the_report_on_the_cpu(tmp_path, capsys):
    """``--device cpu --out PATH``: one JSON line per case on stdout and
    the report at PATH; the repository's ORACLE.json is not touched."""
    out = tmp_path / "oracle.json"
    rep = TOR.main(["--durations", "0.3", "--windows", "4", "--noise", "0.0",
                    "--device", "cpu", "--out", str(out)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0]) == rep["cases"][0]
    assert lines[-1] == f"wrote {out}"
    assert json.loads(out.read_text()) == rep
    (case,) = rep["cases"]
    assert case["events"] == 9 and case["delta_max_m"] < 0.05


def test_main_runs_on_the_card_by_default():
    """No ``--device``: the card; without one it raises, never falls back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks a host without one")
    with pytest.raises(RuntimeError, match="CUDA card"):
        TOR.main(["--durations", "0.5", "--windows", "4"])
