"""Root test configuration: each pytest-xdist worker gets its share of the CPUs for torch."""

import os

# Every worker's torch would start a pool of one thread per CPU, so workers x pool oversubscribe
# the CPUs; the plain versions' many parallel regions then wait on descheduled threads and run
# 30-100x slower. A single process keeps torch's default pool.
_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _workers:
    import torch

    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // _workers))
