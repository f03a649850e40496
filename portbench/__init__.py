"""The benchmark of ``ofdm_ls_mrc_tpu_torch`` on one NVIDIA H100.

Driven by data: ``BENCHMARK.json`` at the root of the checkout names the
cells, and each cell's configuration, traffic mix and metrics are files of
their own under this folder, found by name:

  configs/<config>.json       the deployment's sizes, its source and limits
  traffic/<traffic>.json      the parameters the one generator (loops.py) reads
  metrics/<metric>.py         a reader ``read(run)`` over the run's record
  references/<reference>.py   a plain reference named by a configuration

A cell, configuration, traffic mix or metric is added by adding files.

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Nothing here imports ``jax`` or the JAX package ``ofdm_ls_mrc_tpu``; the
references import nothing of the port either.
"""
