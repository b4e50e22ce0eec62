"""Faults planted under a data-parallel cell's timed path, which its check
has to find not correct. ``benchmark/calibrate_ddp.py`` reads them on the
card and ``benchmark/tests`` on the CPU; the benchmark's own runs never
plant one.

- ``half``: every rank leaves out half of its batch, the means taken over
  the rest;
- ``unsynced``: the gradients' exchange between the ranks left out, each
  rank stepping on its own batch's gradient;
- ``left_out``: the last rank's gradient left out of the sum;
- ``averaged``: the gradients averaged over the ranks where the port sums
  them (DDP's own reduction);
- ``swapped``: the last rank's batches replaced by the rank before's.

The first four change the program as it is built (the gradient hook that
``mesh.wrap`` registers, or the batch each step gets); the last changes
what the last rank is given.
"""

from __future__ import annotations

import contextlib
import dataclasses

from benchmark.lib import port_ddp

FAULTS = ("half", "unsynced", "left_out", "averaged", "swapped")


def _hook(kind: str):
    import torch
    import torch.distributed as dist

    def hook(process_group, bucket):
        buf = bucket.buffer()
        if kind == "unsynced":
            fut = torch.futures.Future()
            fut.set_result(buf)
            return fut
        world = dist.get_world_size(process_group)
        if kind == "left_out" and dist.get_rank(process_group) == world - 1:
            buf.zero_()
        work = dist.all_reduce(buf, group=process_group, async_op=True)
        if kind == "averaged":
            return work.get_future().then(lambda fut: fut.value()[0].div_(world))
        return work.get_future().then(lambda fut: fut.value()[0])

    return hook


@contextlib.contextmanager
def _planted_hook(kind: str):
    from tcs_tpu_torch.parallel import mesh

    saved = mesh._sum_hook
    mesh._sum_hook = _hook(kind)
    try:
        yield
    finally:
        mesh._sum_hook = saved


class HalfBatch(port_ddp.TrainStep):
    def __call__(self, batch, mark=None):
        h = batch.image1.shape[0] // 2
        cut = dataclasses.replace(batch, **{f.name: getattr(batch, f.name)[:h]
                                            for f in dataclasses.fields(batch)})
        return super().__call__(cut, mark)


def build(fault: str, ctx, state_dict):
    """The program of one rank with ``fault`` planted."""
    if fault == "half":
        return HalfBatch(ctx.config, state_dict, ctx.device)
    if fault in ("unsynced", "left_out", "averaged"):
        with _planted_hook(fault):
            return port_ddp.TrainStep(ctx.config, state_dict, ctx.device)
    if fault == "swapped":
        return port_ddp.TrainStep(ctx.config, state_dict, ctx.device)
    raise ValueError(f"fault {fault!r}: one of {FAULTS}")


def pool(fault: str, ctx, rank: int, world: int, rows):
    """The batches that ``rank`` is given under ``fault``."""
    if fault == "swapped" and rank == world - 1:
        from benchmark.drivers import train_ddp

        return train_ddp.rank_pool(ctx, world - 2, world)
    return rows
