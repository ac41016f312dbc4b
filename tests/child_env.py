"""The environment of a Python child a port test starts.

The suite runs in several pytest-xdist workers at once, and each port
test file keeps torch in its worker on one intra-op thread.  A child
started without that rule spreads torch over every core beside the
busy workers, and in the full suite ran 20-57 times slower than alone.
The scripts themselves keep every core when run on their own (on the
card's machine); only their children in the suite take one thread.
"""

import os


def one_thread(env=None, **extra) -> dict:
    """env (default: this process's environment) with extra set and one
    intra-op thread for torch's OpenMP and MKL pools."""
    return dict(os.environ if env is None else env, OMP_NUM_THREADS="1",
                MKL_NUM_THREADS="1", **extra)
