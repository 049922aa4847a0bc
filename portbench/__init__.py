"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``: the closed-loop
window over ``repro_torch.solver.solve``, the end-to-end metrics (or,
traced, the per-layer ones), and the comparison with the plain reference
in ``portbench/reference`` that decides ``correct``. Configurations,
traffic mixes, cells and per-layer metrics are data files and small
readers found by the names ``BENCHMARK.json`` gives them.
"""
