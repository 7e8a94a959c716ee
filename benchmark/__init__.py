"""The benchmark of ``photon_ml_tpu_torch`` on NVIDIA GPUs.

``python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line. Everything that belongs to one configuration, traffic mix, driver or
per-layer metric sits in a file of its own, found by name:
``configs/<config>.json``, ``traffic/<traffic>.json`` (whose ``driver``
names ``drivers/<driver>.py``), ``metrics/<metric>.py`` and
``limits/<workload>.json``. ``yardstick/`` (the modelled work and the
card's peaks) and ``reference/`` (plain PyTorch) are frozen here, apart
from the program they measure.
"""
