"""Global configuration: host parallelism and the compute dtype.

The counterpart of :mod:`glimpse_tpu.config`:

- host-side thread pools for I/O-bound fan-out (image decode, file caches);
- a MapReduce-style pool over threads with the ``sharedmem.MapReduce``
  calling convention the host modules use;
- the compute dtype of the device hot paths (float32 only in this package).
"""
import concurrent.futures
import os
from typing import Optional

# Dtype used for device-side image and SSE math.
compute_dtype = "float32"

# Number of host worker threads for I/O-bound fan-out (image decode, caches).
host_workers: int = max(4, (os.cpu_count() or 4))

# Name of the axis over which points/tracks are split across devices.
points_axis: str = "points"

# matmul switch kept under upstream's name; there are no fork-based workers
# here, so it is always safe to leave True.
matmul = True


def thread_pool(max_workers: Optional[int] = None):
    """Return a thread pool for host-side I/O fan-out."""
    return concurrent.futures.ThreadPoolExecutor(max_workers or host_workers)


class _MapReduceBackend:
    """Minimal MapReduce-style pool over threads.

    Supports the subset of the sharedmem.MapReduce API the host modules use:
    ``with backend(np=n) as pool: pool.map(func, sequence, reduce=, star=)``.
    Work is I/O-bound on the host (decode, pickle caches), so threads suffice;
    device math never runs under this pool.
    """

    def __init__(self, np: int = 0):
        self.np = np

    def __enter__(self):
        return self

    def __exit__(self, *args):
        return False

    def map(self, func, sequence, reduce=None, star: bool = False):
        call = (lambda item: func(*item)) if star else func
        if self.np and self.np > 1:
            with concurrent.futures.ThreadPoolExecutor(self.np) as pool:
                results = list(pool.map(call, sequence))
        else:
            results = [call(item) for item in sequence]
        if reduce is not None:
            # sharedmem-compatible reduce: tuples are star-unpacked, None maps
            # to a call with defaults; map returns the reduce return values.
            def apply(r):
                if r is None:
                    return reduce()
                if isinstance(r, tuple):
                    return reduce(*r)
                return reduce(r)

            results = [apply(r) for r in results]
        return results


backend = _MapReduceBackend
