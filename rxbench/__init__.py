"""Benchmark of ``liquiddsp_tpu_torch``, the PyTorch and CUDA receiver farm.

One run drives one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) through the program's served entry on one card for a fixed
window, then holds every chunk the window produced against this folder's
own plain receiver (``reference.py``) and the frames its own transmitter
(``tx.py``) sent. Run it from the root of a checkout:

    python3 -m rxbench.run --workload v27golay.chunks --seed 7 --seconds 30 --trace 0

Everything that belongs to one configuration, traffic mix, entry or metric
is a file of its own, found by name: ``configs/<config>.json``,
``traffic/<traffic>.json`` (the cell's ``traffic``), ``entries/<entry>.py``, ``limits/<cell>.json`` and
``metrics/<metric>.py``. Nothing here imports the JAX package or JAX; only
``entries/`` imports the program, and only when a run builds its receiver.
"""
