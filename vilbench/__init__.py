"""The benchmark of ``vil_sensor_fusion_tpu_torch`` on an NVIDIA card.

One run of one cell::

    python3 -m vilbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: a cell is ``workloads/<cell>.json`` (its
configuration, driver and traffic), a configuration
``configs/<config>.json``, a driver ``drivers/<driver>.py`` and a per-layer
metric's reader ``metrics/<metric>.py``. ``reference/`` holds the plain
reference that decides ``correct``. Nothing here imports JAX or the JAX
package.
"""
