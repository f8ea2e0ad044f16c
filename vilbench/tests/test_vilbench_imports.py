"""No run loads JAX or the JAX package; the reference loads nothing of the
port; nothing here reads the root bench.py or a record of the JAX round."""

from __future__ import annotations

import re
import subprocess
import sys

import pytest

from vilbench.tests.vilbench_tiny import LANES, REPO, STREAM

FORBIDDEN = ("jax", "jaxlib", "flax", "vil_sensor_fusion_tpu")


def _modules_after(code: str, cwd=REPO) -> set[str]:
    p = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                        "print(' '.join(sorted({m.split('.')[0] for m in "
                        "sys.modules})))"], cwd=cwd, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(p.stdout.split("\n")[-2].split())


@pytest.mark.parametrize("cell", [LANES, STREAM])
def test_a_dry_run_of_each_driver_loads_no_jax(cell, tmp_path):
    code = (f"import torch; torch.set_num_threads(2)\n"
            f"from vilbench.tests.vilbench_tiny import make_root\n"
            f"from vilbench import harness\n"
            f"from pathlib import Path\n"
            f"root = make_root(Path({str(tmp_path)!r}))\n"
            f"res, _ = harness.run({cell!r}, 7, 0.01, False, 'cpu',"
            f" root=root)\n"
            f"assert res['correct'], res\n")
    top = _modules_after(code)
    assert "vil_sensor_fusion_tpu_torch" in top
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)


def test_the_reference_imports_nothing_of_the_port():
    top = _modules_after("import vilbench.reference.pipeline, "
                         "vilbench.reference.compare")
    assert not top & {"vil_sensor_fusion_tpu_torch", *FORBIDDEN}


def test_no_source_reads_the_jax_round_or_its_records():
    imports = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|"
                         r"vil_sensor_fusion_tpu)(\.|\s|$)", re.M)
    records = re.compile(r"BENCH_r0|MULTICHIP_r0|SOAK_345|BASELINE\.|"
                         r"[\"']bench\.py[\"']")
    sources = [f for f in (REPO / "vilbench").rglob("*.py")
               if f.parent.name != "tests"]
    assert len(sources) > 10
    for f in sources:
        text = f.read_text()
        assert not imports.search(text), f
        assert not records.search(text), f
