"""The part of NCCL's kernel time on rank 0's card in which no other kernel, memcpy or memset runs, a traced step, ms."""

from benchmark.lib import collectives


def read(record):
    return collectives.allreduce_exposed_ms_per_step(record)
