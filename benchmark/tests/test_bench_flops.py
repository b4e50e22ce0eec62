"""The benchmark's FLOP count (``benchmark/flops``) against the port's own
count (``tcs_tpu_torch/utils/flops.py``), which runs the program on the CPU:
equal to the FLOP at 64×96, and at the recipes' sizes the numbers PERF.md
prints."""

import dataclasses

import pytest

from benchmark.flops import count
from benchmark.reference.model import Arch

RECIPE = dict(dataset="sceneflow", loss_gamma=0.9, init_k=3, init_thres=0.5,
              normal_loss_weight=0.25, grad_loss_weight=5.0, train_iters=5)


def _port_config():
    from tcs_tpu_torch import ModelConfig

    return ModelConfig(mixed_precision=False, corr_dtype="float32")


@pytest.mark.parametrize("iters", [2, 5])
def test_carried_frame_equals_the_ports_count(iters):
    from tcs_tpu_torch.utils import flops

    port = flops.inference_flops(_port_config(), 64, 96, iters, device="cpu")
    mine = count.frame(Arch(), 1, 64, 96, iters, carried=True)
    assert mine.total == port.total
    assert mine.taps["lookup"] == port.by_op()["corr_lookup"]
    assert mine.taps["splat"] == port.by_op()["splat_sum"]


def test_two_frame_step_equals_the_ports_count():
    from tcs_tpu_torch.config import sceneflow_recipe
    from tcs_tpu_torch.utils import flops

    tc = dataclasses.replace(sceneflow_recipe(), model=_port_config(), batch_size=1,
                             image_size=(64, 96), frame_length=2)
    port, _ = flops.train_step_flops(tc, device="cpu")
    mine = count.train_step(Arch(), RECIPE, 1, 64, 96, 2)
    assert mine.total == port.total


def test_recipe_sizes_read_what_perf_md_prints():
    frame = count.frame(Arch(), 1, 384, 1280, 5, carried=True)
    assert round(frame.total / 1e9, 4) == 1938.7888
    step = count.train_step(Arch(), RECIPE, 4, 320, 720, 2)
    assert round(step.total / 1e9, 1) == 22570.1


def test_bootstrap_and_carried_differ_by_the_warp():
    boot, carried = count.stream_call(Arch(), 2, 64, 96, 2)
    assert "splat" not in boot.taps and carried.taps["splat"] == 8 * 2 * 16 * 24 * 258
    assert boot.dense > 0 and carried.total > boot.total
