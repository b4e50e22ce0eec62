"""The frozen reference (``benchmark/reference``) against the port's CPU path
in fp32 at 64×96: streaming frames with the state carried, and training
steps with AdamW, from the benchmark's seeded weights. This shows the copy
faithful as it was frozen; the card's bf16 program is held to it by the
cells' checks."""

import dataclasses

import numpy as np
import torch

from benchmark.lib import scenes, weights
from benchmark.reference.model import Arch, TCStereo as RefNet
from benchmark.reference.stream import Stream
from benchmark.reference.train import Step

H, W = 64, 96


def _port_model(sd):
    from tcs_tpu_torch import ModelConfig
    from tcs_tpu_torch.models import TCStereo

    cfg = ModelConfig(mixed_precision=False, corr_dtype="float32")
    net = TCStereo(cfg, device="cpu", seed=0)
    net.load_state_dict(sd, strict=True)
    return net, cfg


def test_parameter_names_and_shapes_are_the_programs():
    net, _ = _port_model(weights.make(Arch(), 1, "cpu"))
    ref = RefNet(Arch())
    assert {n: p.shape for n, p in net.named_parameters()} == \
        {n: p.shape for n, p in ref.named_parameters()}
    assert sum(p.numel() for p in ref.parameters()) == 16735005


def test_stream_agrees_with_the_ports_evaluator():
    from tcs_tpu_torch.evaluate import TemporalEvaluator

    sd = weights.make(Arch(), 2**31 + 11, "cpu")
    net, cfg = _port_model(sd)
    ev = TemporalEvaluator(net, cfg, iters=3, device="cpu")
    ref = RefNet(Arch())
    ref.load_state_dict(sd)
    rs = Stream(ref, 3, "cpu")
    cl = scenes.clips(2, 3, 60, 90, scenes.principal_k(45.0, 60, 90), 0.5, 5)
    K = np.stack([c["K"] for c in cl])
    b = np.array([c["baseline"] for c in cl])
    for k in range(3):
        i1 = np.stack([c["image1"][k] for c in cl]).astype(np.uint8)
        i2 = np.stack([c["image2"][k] for c in cl]).astype(np.uint8)
        T = np.stack([c["T"][k] for c in cl])
        got, want = ev(i1, i2, K, b, T), rs(i1, i2, K, b, T).numpy()
        assert got.shape == (2, 60, 90)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_train_steps_agree_with_the_ports_step():
    from tcs_tpu_torch.config import kitti_raw_recipe
    from tcs_tpu_torch.train import SequenceBatch, make_train_step

    sd = weights.make(Arch(), 77, "cpu")
    net, cfg = _port_model(sd)
    tc = dataclasses.replace(kitti_raw_recipe(), model=cfg, batch_size=1, image_size=(H, W),
                             frame_length=2, train_iters=2)
    step = make_train_step(net, tc)
    ref = RefNet(Arch())
    ref.load_state_dict(sd)
    rstep = Step(ref, dict(dataset="kitti_raw", loss_gamma=0.9, init_k=3, init_thres=0.5,
                           normal_loss_weight=0.25, grad_loss_weight=5.0, train_iters=2,
                           grad_clip=1.0, lr=tc.lr, num_steps=tc.num_steps, wdecay=tc.wdecay))
    for s in range(2):
        cl = scenes.clips(1, 2, H, W, scenes.principal_k(W / 2, H, W), 0.5, 10 + s)
        batch = SequenceBatch.from_numpy(cl, "cpu")
        m = step(batch)
        r = rstep({k: getattr(batch, k) for k in ("image1", "image2", "flow", "valid", "T",
                                                   "K", "baseline")})
        assert abs(float(m["live_loss"]) - float(r["loss"])) <= 1e-5 * abs(float(r["loss"]))
        assert abs(float(m["grad_norm"]) - float(r["grad_norm"])) <= 1e-5 * float(r["grad_norm"])
    mine = dict(net.named_parameters())
    for n, p in ref.named_parameters():
        torch.testing.assert_close(mine[n], p, rtol=0, atol=1e-7)
