"""The port's quick window sweep
(``vil_sensor_fusion_tpu_torch/window_sweep_quick.py``) against the JAX
package's ``scripts/window_sweep_quick.py`` on the same problem: the 10 m
circle over 1.0 s with 0.02 m of odometry noise drawn from
``numpy.random.default_rng(0)``, windows 4 and 6, float64 on both sides.

The stream ATE is held to 1e-9 m against JAX (the same Gauss-Newton in
float64; the sums run in another order). Against the port's own oracle
report (``oracle_report.run_window``, which runs the same stream problem
and stream run) it is equal bit for bit. The JAX side runs in a child
process, started before the first test, while the port computes (the
spawned child imports this file); the comparisons come last."""

import importlib
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import pytest
import torch

from vil_sensor_fusion_tpu_torch import oracle_report as TOR
from vil_sensor_fusion_tpu_torch import window_sweep_quick as TWS

DUR, NOISE, WINDOWS = 1.0, 0.02, (4, 6)
TOL = 1e-9


def _jax_ates(dur, noise, windows):
    import jax

    jax.config.update("jax_enable_x64", True)
    jws = importlib.import_module("scripts.window_sweep_quick")
    return {w: jws.run_case(dur, noise, w) for w in windows}


@pytest.fixture(scope="module", autouse=True)
def jax_side():
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(1, mp_context=ctx) as pool:
        yield pool.submit(_jax_ates, DUR, NOISE, WINDOWS)


@pytest.fixture(scope="module")
def port_ates(jax_side):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return {w: TWS.run_case(DUR, NOISE, w, device="cpu")
                for w in WINDOWS}
    finally:
        torch.set_num_threads(n)


SHORT = 0.2     # s: 6 events, where the batch MAP is quick


@pytest.fixture(scope="module")
def short_ate():
    return TWS.run_case(SHORT, NOISE, 4, device="cpu")


def test_run_case_is_the_oracle_reports_stream_ate(short_ate):
    """One stream problem and one stream run behind both modules: the
    oracle report's ``ate_stream_m`` is the window sweep's ATE exactly."""
    prob = TOR.build_problem(SHORT, NOISE, device="cpu")
    assert TOR.run_window(prob, SHORT, NOISE, 4)["ate_stream_m"] \
        == short_ate


def test_main_prints_the_jax_lines_on_the_cpu(capsys, short_ate):
    """One ``W=  4  ate_stream=... m`` line per window; ``--gn-iters``
    reaches the smoother (one iteration gives another ATE than the
    default five)."""
    rep = TWS.main(["--duration", str(SHORT), "--windows", "4,6", "--gn-iters",
                    "1", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == [f"W={w:3d}  ate_stream={rep['ate_stream_m'][w]:.5f} m"
                     for w in (4, 6)]
    assert lines[0].startswith("W=  4  ate_stream=0.0")
    assert rep["device"] == "cpu" and rep["gn_iters"] == 1
    assert short_ate != rep["ate_stream_m"][4]


def test_main_runs_on_the_card_by_default():
    """No ``--device``: the card; without one it raises, never falls back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks a host without one")
    with pytest.raises(RuntimeError, match="CUDA card"):
        TWS.main(["--duration", "0.5", "--windows", "4"])


@pytest.mark.parametrize("window", WINDOWS)
def test_run_case_matches_jax(jax_side, port_ates, window):
    want = jax_side.result()[window]
    got = port_ates[window]
    assert abs(got - want) <= TOL, (got, want)
    assert 0.0 < got < 0.05
