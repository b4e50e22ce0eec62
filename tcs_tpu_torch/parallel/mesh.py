"""Data parallelism over processes, one per card (the port's counterpart of
``tcs_tpu/parallel/mesh.py``; reference ``train_stereo.py:275-292``).

``tcs_tpu`` runs one jitted program over a batch sharded on a 1-axis device
mesh, so each of its reductions (the losses' masked means, batch norm's
statistics, the metrics) is over the global batch. The port runs one process
per card under ``torch.distributed`` (NCCL between cards, Gloo on the CPU)
and computes the same function: at world size W with a batch of B on every
rank, what one process computes on the W·B batch of the ranks' batches
stacked in rank order (``tcs_tpu``'s ``global_batch_from_local``).

- Each rank's loss is its own numerator over the global count of the mask:
  the train step counts the masks before the forward and sums the counts
  over the ranks (:func:`all_reduce_sum`) while the forward runs. The sum of
  the ranks' gradients is then the global gradient, so :func:`wrap`
  registers a communication hook that makes DDP sum the gradients where it
  would average them.
- Batch norm takes its statistics over the process group in training
  (:class:`tcs_tpu_torch.models.layers.BatchNorm`, which :func:`wrap`
  attaches to the group); evaluation streams one sequence per rank and does
  not sync.
- The metrics are summed over the ranks once a step
  (:func:`sum_over_ranks`), so every rank reads the same numbers and takes
  the same branch.

The reference's own DDP averages per-rank means instead; the port follows
``tcs_tpu`` and has no switch for it, as ``tcs_tpu`` has none. Without a
process group every function here is the single-process identity.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
from torch.nn.parallel import DistributedDataParallel

from tcs_tpu_torch import device as device_lib
from tcs_tpu_torch.models.layers import BatchNorm


def launcher_args(environ: Mapping[str, str] = os.environ) -> Tuple:
    """(coordinator, num_processes, process_id) for
    :func:`initialize_distributed` from the environment that ``python -m
    torch.distributed.run`` gives each process (``WORLD_SIZE``, ``RANK``);
    (None, None, None), one process, outside it. The coordinator is
    ``env://``: the launcher's own store at ``MASTER_ADDR:MASTER_PORT``,
    which its processes join as clients (rank 0 cannot open a second store
    on that port)."""
    if "WORLD_SIZE" not in environ:
        return None, None, None
    return "env://", int(environ["WORLD_SIZE"]), int(environ["RANK"])


def _local_device(device, process_id: int) -> torch.device:
    dev = device_lib.resolve(device)
    if dev.type == "cpu" or dev.index is not None:
        return dev
    local = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", int(local) if local is not None
                        else process_id % torch.cuda.device_count())


def local_device(device="cuda") -> torch.device:
    """This process's device: the CPU when asked for, else its card,
    ``cuda:LOCAL_RANK`` under the launcher or ``cuda:(rank % cards)``. A
    device with an index is taken as it is. Raises without a GPU unless the
    caller asked for the CPU."""
    return _local_device(device, rank())


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None, device="cuda") -> None:
    """Join the process group of ``num_processes`` ranks as ``process_id``,
    the rendezvous at ``coordinator`` (``host:port``, where rank 0 opens the
    store, or a URL such as ``file:///path`` or ``env://``). A no-op when ``num_processes`` is None: one process,
    no group. The backend is NCCL for a card and Gloo for the CPU; pass
    ``backend="gloo"`` for ranks that share one card, which NCCL refuses.
    On a card the process's current device becomes its :func:`local_device`.
    """
    if num_processes is None:
        return
    if coordinator is None or process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"a process group of {num_processes} needs the coordinator's "
                         f"address and a rank below it: {coordinator!r}, {process_id!r}")
    dev = _local_device(device, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=init_method, world_size=num_processes,
                            rank=process_id)


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def is_primary() -> bool:
    """Rank 0, which alone writes checkpoints and records."""
    return rank() == 0


def barrier() -> None:
    if active():
        dist.barrier()


def destroy() -> None:
    """Leave the process group, if there is one."""
    if active():
        dist.destroy_process_group()


def _sum_hook(process_group, bucket):
    """DDP communication hook: the bucket's gradients summed over the ranks
    (DDP's own reduction divides the sum by the world size). It returns a
    future of the tensor; DDP refuses a return annotation that it cannot
    compare, such as this module's string annotations."""
    work = dist.all_reduce(bucket.buffer(), group=process_group, async_op=True)
    return work.get_future().then(lambda fut: fut.value()[0])


def wrap(model: nn.Module) -> nn.Module:
    """``model`` for data-parallel training under the process group:
    ``DistributedDataParallel`` with :func:`_sum_hook`, and with more than
    one rank its batch norms on the group's statistics. The model itself
    without a group.

    Every rank builds the model from the same seed, so DDP's broadcast of
    rank 0's weights changes nothing. ``find_unused_parameters``: the hidden
    updater gets no gradient at one iteration, and frame 0 bootstraps
    without the temporal modules. The model has no buffers to broadcast.
    """
    if not active():
        return model
    if world_size() > 1:
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.process_group = dist.group.WORLD
    dev = next(model.parameters()).device
    ddp = DistributedDataParallel(model, device_ids=[dev.index] if dev.type == "cuda" else None,
                                  broadcast_buffers=False, find_unused_parameters=True)
    ddp.register_comm_hook(None, _sum_hook)
    return ddp


def all_reduce_sum(t: torch.Tensor, async_op: bool = False):
    """Sum ``t`` over the ranks in place; with ``async_op`` returns the work
    to ``wait()`` on (None without a group)."""
    if not active():
        return None
    return dist.all_reduce(t, async_op=async_op)


def sum_over_ranks(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """0-d fp32 tensors, each summed over the ranks in one all-reduce."""
    if not active():
        return values
    keys = list(values)
    flat = torch.stack([values[k].reshape(()).to(torch.float32) for k in keys])
    dist.all_reduce(flat)
    return dict(zip(keys, flat.unbind()))


def process_generator(seed: int) -> torch.Generator:
    """A generator seeded from (``seed``, rank): a stream of its own on each
    rank (``tcs_tpu``'s ``process_rng_key``; reference per-rank seed :292)."""
    state = np.random.SeedSequence((seed, rank())).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))
