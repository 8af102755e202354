"""The benchmark of ``qaig_tpu_torch`` on an NVIDIA GPU: one cell a run,
``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``, driven by ``BENCHMARK.json`` and the files beside this
one (see ``harness.py``)."""
