"""The control: the reference put in the program's place and computed in the
precision below the one the configurations state (fp8 operands for the bf16
convolution stacks and pyramid; ``benchmark.reference.precision``). The
check has to find it not correct. ``benchmark/calibrate.py`` runs it on
the card; the harness's own runs never do."""

from __future__ import annotations

from benchmark.reference import precision
from benchmark.reference.model import Arch, TCStereo as RefNet
from benchmark.reference.stream import Stream
from benchmark.reference.train import Step


def _net(ctx, state_dict, mode: str):
    net = RefNet(Arch.from_config(ctx.config["model"]), mode=mode).to(ctx.device)
    net.load_state_dict(state_dict)
    return net


class StreamControl:
    """The evaluator's interface over the reference stream in ``mode``."""

    def __init__(self, ctx, state_dict, mode: str = "fp8"):
        self.stream = Stream(_net(ctx, state_dict, mode), ctx.config["stream"]["iters"], ctx.device)

    def reset(self):
        self.stream.reset()

    @property
    def state(self):
        return self.stream.state

    def __call__(self, *frame):
        with precision.fp32_matmuls():
            return self.stream(*frame).cpu().numpy()


class TrainControl:
    """The train step's interface over the reference step in ``mode``."""

    def __init__(self, ctx, state_dict, mode: str = "fp8"):
        self.net = _net(ctx, state_dict, mode)
        self.step = Step(self.net, dict(ctx.config["train"],
                                        init_thres=ctx.config["model"]["init_thres"]))

    def __call__(self, batch, mark=None):
        with precision.fp32_matmuls():
            out = self.step(batch)
        return out["loss"], out["grad_norm"]

    def named_parameters(self):
        return self.net.named_parameters()

    def first_grads(self):
        names = [n for n, _ in self.net.named_parameters()]
        return {n: g.detach().double().cpu() for n, g in zip(names, self.step.first_grads)}


def stream(ctx, state_dict):
    return StreamControl(ctx, state_dict)


def train(ctx, state_dict):
    return TrainControl(ctx, state_dict)
