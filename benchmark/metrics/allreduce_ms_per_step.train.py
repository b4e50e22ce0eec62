"""Device time of NCCL's kernels on rank 0's card a traced step, ms (the gradients' all-reduce, the mask counts' and the metrics' sums)."""

from benchmark.lib import collectives


def read(record):
    return collectives.allreduce_ms_per_step(record)
