"""One torch intra-op thread per test process.

The tier-1 command runs the tests in 6 pytest-xdist workers on the CPU;
PyTorch's default of one OpenMP thread per core in each of them
oversubscribes the cores, and the spinning threads slow the port's tests by
more than an order of magnitude. Every port test file that computes with
torch on the CPU imports this module, which sets the count at import, so
the count holds whichever files a run collects. Test subprocesses that
compare CPU floats bit for bit pass the parent's count on
(`OMP_NUM_THREADS`).
"""

import torch

torch.set_num_threads(1)


def test_one_torch_thread_a_process():
    assert torch.get_num_threads() == 1
