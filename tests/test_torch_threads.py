"""One torch CPU thread a test process.

Every ``tests/test_torch_*.py`` imports this module first. The suite runs in
several worker processes at once (``-n 6 --dist loadfile``), and torch sizes
each process's intra-op pool to every core: six such pools spin against each
other on an eight-core host, and a test that takes 10 s alone then takes
minutes. One thread a process keeps each worker to its own core. The cap is
set once, at import, before the importing file does any torch work; it
changes no result beyond the tolerances each test states.
"""

import torch

torch.set_num_threads(1)


def test_torch_runs_on_one_thread():
    assert torch.get_num_threads() == 1
