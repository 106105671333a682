"""Settings for every test session of the repo.

Under pytest-xdist each worker is a process of its own, and PyTorch's CPU
thread pool takes one thread a core in each: six workers on eight cores
run six times as many torch threads as there are cores.  Torch's many
small parallel regions then wait on threads the scheduler has not run,
and a smoke train step that takes 0.03 s alone takes seconds.  So each
worker takes its share of the cores, as ``launch/mesh.py`` gives each rank
its share; processes the tests start inherit it through
``OMP_NUM_THREADS`` unless a test sets its own.  An ``OMP_NUM_THREADS``
set before the session is kept.
"""

import os


def pytest_configure(config):
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return
    share = max(1, len(os.sched_getaffinity(0)) // int(workers))
    os.environ.setdefault("OMP_NUM_THREADS", str(share))
    import torch

    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
