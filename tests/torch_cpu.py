"""One torch intra-op thread in this process, for the port's CPU tests.

The port's tests run tensors of a few kilobytes, where torch's default pool
of one thread a core buys nothing, and the tier-1 run has six pytest
workers on one machine: six such pools oversubscribe its cores. Measured on
six of the port's test files under six workers: 1325 s of worker time with
the default pools, 417 s with one thread each, every case passing either
way. Every ``tests/test_torch_*.py`` imports this module, so a file run
alone behaves as it does in the whole run.
"""

import torch

torch.set_num_threads(1)
