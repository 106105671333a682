"""The paper's figures and tables on the port: one module per figure
script of the reference's ``benchmarks/run.py``, under the same names
(``fig1_motivation``, ``fig3_topologies``, ``comm_overlap``,
``ml_workloads``, ``sched_micro``, ``roofline_table``), each with the
``run(quick=..., ...) -> rows`` / ``check(rows) -> errors`` contract, and
the harness ``run`` behind ``python -m repro_torch.launch.figures``.

They run the port's numpy simulator on the host, as ``launch/sweep.py``
does; ``tests/test_torch_figures.py`` holds every row and check equal to
the reference's but for the clock fields.
"""
