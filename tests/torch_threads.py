"""A fixture for the CPU test files that train the port's models: the box's
cores shared among the test workers. The tier-1 run starts several pytest
worker processes on one box (pytest-xdist sets PYTEST_XDIST_WORKER_COUNT),
and a training loop that spreads over every core in each of them
oversubscribes the CPU many times over: the five entry-point files took
323 s on 5 workers with torch's default threads, 90 s with two each. In one
process the default stays.

Import it into a test module (``from torch_threads import share_cores``)
to have it apply to every test there."""

import math
import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def share_cores():
    threads = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, math.ceil((os.cpu_count() or 1) / workers)) if workers > 1
                          else threads)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
