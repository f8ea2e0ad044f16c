"""The port's multi-host bench
(``vil_sensor_fusion_tpu_torch/multihost_bench.py``) on the CPU: ``launch``
with 2 hosts × 1 device as gloo worker processes started by
``run_cluster`` (``python -m ... worker``), at 6 events per sequence and
one timed pass. The table carries the JAX script's keys, and the global
batch spans every rank (weak scaling: ``global_events`` = batch × ranks ×
events). Without a card, ``--device cuda`` (the default) raises before any
process starts."""

import numpy as np
import pytest
import torch

from vil_sensor_fusion_tpu_torch import multihost_bench as TMB

N_EVENTS = 6


@pytest.fixture(scope="module")
def table():
    return TMB.main(["launch", "--hosts", "2", "--devices", "1", "--device",
                     "cpu", "--n-events", str(N_EVENTS), "--reps", "1"])


def test_launch_prints_the_jax_keys(table, capsys):
    assert set(table) == {"single_host", "multi_host", "hosts",
                          "scaling_efficiency", "target", "meets_target"}
    assert table["hosts"] == 2 and table["target"] == 0.8
    one, many = table["single_host"], table["multi_host"]
    assert {"processes", "local_devices", "global_events",
            "events_per_s"} <= set(one) == set(many)
    eff = many["events_per_s"] / (2 * one["events_per_s"])
    assert table["scaling_efficiency"] == round(eff, 3)
    assert table["meets_target"] == (eff >= 0.8)


def test_global_events_span_every_rank(table):
    """batch (1) × ranks × events per sequence."""
    one, many = table["single_host"], table["multi_host"]
    assert (one["processes"], many["processes"]) == (1, 2)
    assert one["global_events"] == 1 * 1 * N_EVENTS
    assert many["global_events"] == 1 * 2 * N_EVENTS
    for r in (one, many):
        assert np.isfinite(r["events_per_s"]) and r["events_per_s"] > 0
        assert r["device"] == "cpu" and r["local_devices"] == 1


def test_runs_on_the_card_by_default():
    """No ``--device``: the card; without one it raises, never falls back
    to the CPU, and ``run_cluster`` refuses a world larger than the cards
    before starting a process."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks a host without one")
    with pytest.raises(RuntimeError, match="CUDA card"):
        TMB.main(["launch", "--hosts", "1", "--devices", "1"])
    with pytest.raises(RuntimeError, match="needs 2 cards"):
        TMB.run_cluster(2, 1, n_events=N_EVENTS, reps=1)
