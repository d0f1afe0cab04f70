"""torch for the port's tests: imported (the test module is skipped
without it) and run on one intra-op thread.

The suite runs in several worker processes at once (pytest-xdist).  With
torch's default of one OpenMP thread a core in every worker, the workers'
threads oversubscribe the cores and each small op waits on them; the
tests' tensors are smoke-sized, where one thread is as fast as many.
Import it in place of ``torch``::

    from _torch_tests import torch
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
