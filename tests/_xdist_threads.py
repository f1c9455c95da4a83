"""Share the CPU among pytest-xdist workers: under `-n N` each worker
gets cpu_count // N PyTorch intra-op threads (at least one).  With the
default (every core in every worker) the OpenMP threads of N workers
oversubscribe the cores and spin at their barriers: the port's tests
took 206 s under `-n 6` on an 8-core host, and 47 s with one thread per
worker.  Imported by the cascade's test modules (test_torch_{render,
geometry,icp,detector,cascade}.py); every xdist worker imports every
test module while collecting, so the setting holds for the whole run.
A run without xdist keeps PyTorch's default."""

import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _WORKERS:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))
