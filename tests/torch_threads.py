"""One CPU thread in every process that runs the port's tests.

Every ``tests/test_torch_*.py`` imports this module first.  Test workers
that share the cores each run torch's intra-op pool and OpenBLAS's pool at
the full core count: six copies of one history pin at once on an 8-core
host took 207-209 s each, and 3.0-3.3 s each on one thread.  The thread
count also moves the f64 SA set-up at ~1e-5, so one value everywhere (the
one ``parallel.comm.launch`` gives its ranks) keeps the pinned results
independent of the host.

The variables reach child processes (the CLI runs, the ranks, the native
builds) and pools that load later; ``threadpoolctl`` limits the pools that
are already loaded.
"""

import os

THREADS = 1

for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = str(THREADS)

import torch  # noqa: E402

torch.set_num_threads(THREADS)

try:
    import threadpoolctl
except ImportError:     # not a dependency: pools then read the variables
    pass
else:
    threadpoolctl.threadpool_limits(THREADS)
