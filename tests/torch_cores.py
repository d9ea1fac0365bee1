"""Caps torch's intra-op threads of a test process at its share of the
host's cores.

Under ``pytest -n N`` (pytest-xdist) N workers run side by side; each
worker's torch would otherwise open one OpenMP thread per core, and N
such pools on the same cores slow one another by an order of magnitude
(ROADMAP.md H23).  Every ``tests/test_torch_*.py`` imports this module
before its first torch computation; a plain ``pytest`` (no
``PYTEST_XDIST_WORKER_COUNT``) keeps every core.  XLA's threads are left
as they are.
"""
import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
THREADS = max(1, (os.cpu_count() or 1) // WORKERS)
torch.set_num_threads(THREADS)
