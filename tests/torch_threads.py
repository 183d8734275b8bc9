"""One torch intra-op thread for the port's CPU tests.

The port's plain versions run on the CPU in thousands of small torch ops
(a plain VM step is about a hundred ops on a (rows, 96, 15) tensor). At
these shapes a second intra-op thread saves nothing, and under a
parallel test run (``pytest -n 6`` on 8 cores) each worker's default pool
of one thread per core oversubscribes the host: a 2,048-step program on
2 rows took 148.6 s with the default pool on a loaded 8-core host and 3.7
s with one thread. Every ``tests/test_torch_*.py`` calls ``one_thread()``
when it is imported, so a worker's pool is one thread from its first
port test on.
"""
import torch


def one_thread() -> None:
    torch.set_num_threads(1)
