"""The system under test, built from a configuration file: the port's model
with the benchmark's seeded weights, its streaming evaluator and its
training step. The only module of the harness that imports ``tcs_tpu_torch``
besides the counter of hand-kernel launches the drivers read."""

from __future__ import annotations

import dataclasses
from typing import Dict

BETA1 = 0.9  # AdamW's first-moment decay in every recipe


def model_config(config: dict):
    from tcs_tpu_torch import ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                          for k, v in config["model"].items() if k in names})


def model(config: dict, state_dict, device):
    from tcs_tpu_torch.models import TCStereo

    net = TCStereo(model_config(config), device=device, seed=0)
    net.load_state_dict(state_dict, strict=True)
    return net


def evaluator(config: dict, state_dict, device):
    """``TemporalEvaluator`` on the seeded weights at the configured iterations."""
    from tcs_tpu_torch.evaluate import TemporalEvaluator

    return TemporalEvaluator(model(config, state_dict, device), model_config(config),
                             iters=config["stream"]["iters"], device=device)


def train_config(config: dict):
    """The port's recipe with the configuration's values."""
    from tcs_tpu_torch.config import RECIPES

    r = config["train"]
    return dataclasses.replace(
        RECIPES[r["recipe"]](), model=model_config(config), batch_size=r["batch_size"],
        image_size=tuple(r["image_size"]), frame_length=r["frame_length"],
        train_iters=r["train_iters"], lr=r["lr"], wdecay=r["wdecay"], grad_clip=r["grad_clip"],
        num_steps=r["num_steps"], loss_gamma=r["loss_gamma"], init_k=r["init_k"],
        normal_loss_weight=r["normal_loss_weight"], grad_loss_weight=r["grad_loss_weight"],
        train_dataset=r["dataset"], restore_ckpt=None)


class TrainStep:
    """``make_train_step`` on the seeded model: ``step(batch[, mark]) →
    (loss, grad norm)`` as device tensors."""

    def __init__(self, config: dict, state_dict, device):
        from tcs_tpu_torch.train import make_train_step

        self.model = model(config, state_dict, device)
        self.step = make_train_step(self.model, train_config(config))

    def __call__(self, batch, mark=None):
        m = self.step(batch) if mark is None else self.step(batch, mark)
        return m["live_loss"], m["grad_norm"]

    def named_parameters(self):
        return self.model.named_parameters()

    def first_grads(self) -> Dict[str, "torch.Tensor"]:
        """Each leaf's clipped gradient of the first step, m / (1 − β₁), on the
        host; zeros for a leaf with no state."""
        state = self.step.optimizer.state
        return {n: (state[p]["exp_avg"].detach().double().cpu() / (1.0 - BETA1)
                    if "exp_avg" in state.get(p, {}) else p.detach().double().cpu() * 0)
                for n, p in self.model.named_parameters()}


def batch(tensors: dict):
    """The port's ``SequenceBatch`` of the pool's tensors."""
    from tcs_tpu_torch.train import SequenceBatch

    return SequenceBatch(**tensors)


def launches() -> dict:
    """The port's count of hand-kernel launches so far."""
    from tcs_tpu_torch.ops import _kernels

    return dict(_kernels.launches)
