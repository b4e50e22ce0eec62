"""The check's control and its faults, on the CPU at a size a test can hold.

Each test skips the harness's look for a card, drives the rest of a run of
a real cell (its driver, its limits, its check against the reference) and
reads ``correct``: true for the program as it is, false for the control
(the reference in fp8 put in the program's place) and for each fault the
cell can have, planted underneath the timed path: a state left unchanged,
half of the batch left out, an answer altered where it is produced.
"""

import dataclasses
import json
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from benchmark.lib import control, harness

_CELLS = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())
STREAM = [w["name"] for w in _CELLS["workloads"] if w["traffic"] == "stream"]
TRAIN = ["kitti-train", "sceneflow-train"]  # parked: see conftest.PARKED


def _failing(ctx) -> set:
    """The names of the run's numbers over their limits (none: correct)."""
    driver = harness.load_module(harness.BENCH / "drivers" / f"{ctx.traffic['driver']}.py")
    rec = driver.run(ctx)
    checks = harness.judged(rec["readings"], ctx.limits)
    checks["failed_calls"] = {"value": rec["failed"], "limit": 0}
    assert harness.passes(checks) == (not {n for n, c in checks.items()
                                           if not c["value"] <= c["limit"]})
    return {n for n, c in checks.items() if not c["value"] <= c["limit"]}


@pytest.mark.parametrize("cell", STREAM + TRAIN)
def test_the_program_is_correct(cell, small):
    assert _failing(small(cell)) == set()


@pytest.mark.parametrize("cell", STREAM + TRAIN)
def test_the_control_is_not_correct(cell, small):
    ctx = small(cell)
    ctx.program = control.stream if cell in STREAM else control.train
    assert _failing(ctx)


def test_stream_answer_altered(small):
    """Two streams' answers swapped where the model produces them."""
    from tcs_tpu_torch.models import tc_stereo

    forward = tc_stereo.TCStereo.forward

    def altered(self, *args, **kwargs):
        out = forward(self, *args, **kwargs)
        out.flow[[0, 1]] = out.flow[[1, 0]].clone()
        return out

    with mock.patch.object(tc_stereo.TCStereo, "forward", altered):
        assert "boot_l2" in _failing(small("kitti-stream"))


def test_stream_half_the_batch_left_out(small):
    from tcs_tpu_torch.evaluate import TemporalEvaluator

    call = TemporalEvaluator.__call__

    def half(self, image1, image2, K, baseline, T):
        h = len(image1) // 2
        out = call(self, image1[:h], image2[:h], K[:h], baseline[:h], T[:h])
        return np.concatenate([out, out])

    with mock.patch.object(TemporalEvaluator, "__call__", half):
        assert {"state_fmap", "state_net"} <= _failing(small("kitti-stream", batch=4))


def test_stream_state_left_unchanged(small):
    from tcs_tpu_torch.evaluate import TemporalEvaluator

    call = TemporalEvaluator.__call__

    def stale(self, *args):
        kept = self.state
        out = call(self, *args)
        self.state = kept
        return out

    with mock.patch.object(TemporalEvaluator, "__call__", stale):
        assert {"state_fmap", "state_net"} <= _failing(small("kitti-stream"))


@pytest.mark.parametrize("cell", TRAIN)
def test_train_state_left_unchanged(cell, small):
    with mock.patch.object(torch.optim.AdamW, "step", lambda self, closure=None: None):
        assert {"grad_leaf", "change_leaf", "grad_diff_q25_leaf"} <= _failing(small(cell, frames=2))


@pytest.mark.parametrize("cell", TRAIN)
def test_train_half_the_batch_left_out(cell, small):
    from tcs_tpu_torch.train import train_step

    accumulate = train_step.accumulate_window_grads

    def half(model, cfg, batch, mark=None):
        h = batch.image1.shape[0] // 2
        cut = dataclasses.replace(batch, **{f.name: getattr(batch, f.name)[:h]
                                            for f in dataclasses.fields(batch)})
        return accumulate(model, cfg, cut, mark)

    with mock.patch.object(train_step, "accumulate_window_grads", half):
        assert "loss_rel" in _failing(small(cell, frames=2))
