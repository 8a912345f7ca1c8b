"""The intra-op thread pool of every process that runs the port's tests.

The suite runs in several processes at once (``pytest -n 6``), and each
torch process sizes its intra-op pool to every core by default: N
processes then keep N pools of spinning OpenMP threads on the same
cores, and on an 8-core host six processes of 8 threads ran a test set
18 times slower than six of 1 or 2 threads (exp/port_test_threads.py).
Every test process imports this module at collection, which pins
torch's pool to ``TEST_THREADS`` for the whole session (the gloo ranks
the tests spawn pin themselves to one thread each,
tests/workloads/torch_*.py). Results depend on the
pool's size only in the last bits of a reduction: the port's bitwise
pins compare computations in one process, and its pins against the JAX
package carry tolerances."""

from __future__ import annotations

import torch

TEST_THREADS = 2

torch.set_num_threads(TEST_THREADS)


def test_the_pool_is_pinned():
    assert torch.get_num_threads() == TEST_THREADS
