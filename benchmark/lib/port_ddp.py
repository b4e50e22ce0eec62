"""The system under test for a data-parallel cell: one rank of the port's
training under DDP, built as the port's trainer builds it
(``tcs_tpu_torch/train/trainer.py``): ``mesh.initialize_distributed``, the
model, ``mesh.wrap``, ``make_train_step``. Like :mod:`benchmark.lib.port`,
whose model and recipe it uses, it is a module of the harness that imports
``tcs_tpu_torch``."""

from __future__ import annotations

from benchmark.lib import port


def initialize(address: str, world: int, rank: int, device) -> None:
    """Join the process group of ``world`` ranks at ``address`` (``host:port``,
    rank 0 opens the store): NCCL between cards, Gloo on the CPU."""
    from tcs_tpu_torch.parallel import mesh

    mesh.initialize_distributed(address, world, rank, device=device)


def destroy() -> None:
    from tcs_tpu_torch.parallel import mesh

    mesh.destroy()


def load_kernels(device) -> None:
    """Build (a checkout's first run) and load the hand kernels' library, so
    that one process builds it before the others start."""
    if device.type == "cuda":
        from tcs_tpu_torch.ops import _kernels

        _kernels.lib()


class TrainStep(port.TrainStep):
    """One rank's ``make_train_step`` on ``mesh.wrap`` of the seeded model:
    ``step(batch[, mark]) → (loss, grad norm)``, both the global batch's.
    Each step carries ``stop`` in the step's own sum over the ranks, as the
    trainer carries its SIGTERM flag; ``stopped`` is that sum's verdict,
    read on the host after the step, the same on every rank."""

    def __init__(self, config: dict, state_dict, device):
        from tcs_tpu_torch.parallel import mesh
        from tcs_tpu_torch.train import make_train_step

        self.model = port.model(config, state_dict, device)
        self.step = make_train_step(mesh.wrap(self.model), port.train_config(config))
        self.stop = False
        self.stopped = False

    def __call__(self, batch, mark=None):
        m = self.step(batch, mark, extra={"stop": float(self.stop)})
        self.stopped = float(m.pop("stop")) > 0
        return m["live_loss"], m["grad_norm"]
