"""Torch's CPU threads for the port's heavier test files: each test
worker process gets its share of the host's cores.

The suite runs in several worker processes (pytest-xdist). Each PyTorch
process starts as many OpenMP threads as the host has cores, so N
workers run N times that many, and every small operation then waits on
threads that have no core: one forward of the ``tiny`` UNet took 0.02 s
alone and 8 s with six such processes on eight cores. A test file that
imports :func:`cpu_share` runs its tests with cores // workers threads
(at least one; all the cores without xdist) and gives the count back at
its end. The cores are those the process may run on (its affinity,
which a container's CPU set narrows), not all of the machine's. Every result of the file is computed under that one count, so
its bitwise comparisons hold as before; its comparisons with the JAX
package keep their tolerances."""

import os

import pytest
import torch


def usable_cores() -> int:
    """The cores this process may run on."""
    if hasattr(os, "sched_getaffinity"):
        return len(os.sched_getaffinity(0))
    return os.cpu_count() or 1


@pytest.fixture(scope="module", autouse=True)
def cpu_share():
    workers = max(1, int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 1))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, usable_cores() // workers))
    yield
    torch.set_num_threads(before)
