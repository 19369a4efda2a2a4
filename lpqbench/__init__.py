"""The benchmark of the PyTorch and CUDA port (``repro_torch``): served
exhaustive k-NN search over Eq. 1 codes on one NVIDIA H100.

One command runs one cell once (``lpqbench/run.py``).  Everything that
belongs to one configuration, traffic mix, cell or per-layer metric sits in
a file of its own, found by the name ``BENCHMARK.json`` gives it:

    configs/<config>.json     a deployment: source, rows, width, metric,
                              k, factory string, data generator, cuts
    traffic/<mix>.json        a traffic mix: loop, arrivals, request sizes
                              (read by the one generator, ``loadgen.py``)
    workloads/<cell>.json     a cell: its config and mix, its rate, the
                              requests its check samples, and its limits
    metrics/<metric>.py       a per-layer reader (``<name>.py``, else the
                              part of the name before its first dot)

What the benchmark itself owns, and no change to the program can alter:
the data generators (``data/``), traffic generation (``loadgen.py``), the
work count and the published peaks (``roofline.py``), the reduction of
the device trace (``trace.py``), the end-to-end arithmetic
(``endtoend.py``) and the plain reference that decides ``correct``
(``reference/``).  Nothing here imports ``jax``, ``jaxlib`` or the JAX
package ``repro``; ``reference/`` imports nothing of ``repro_torch``.
"""
