"""The architecture variants of the port against tcs_tpu, in fp32, in test
mode and in train mode.

Three configurations touch every variant once: the group and instance
context norms with the non-shared backbone (``fnet``) and the slow-fast GRU
schedule, and the batch context norm on the shared backbone. The port is
built from a torch seed, its norm parameters drawn away from ones and zeros,
and ``convert.params_from_state_dict`` gives the tcs_tpu parameters (the
tools converter leaves out the norm parameters of the group and batch
context encoders). With batch
norm on the shared backbone, tcs_tpu computes the batch-stacked trunk only
with ``packed_dual_encoder=False`` (its packed trunk asserts on per-sample
norms, ROADMAP Queue 3); that is the function the port computes.

In train mode (2 frames, 2 iterations) each variant compiles one tcs_tpu
program, the frame's forward and losses; its gradients are held, as
``tests/test_torch_grad_witness.py`` holds the default architecture's, against
a float64 run of the port with every ReLU unit, and every L1 term of the
losses, on the float64 run's side of its kink (``tcs_tpu_torch/utils/
kinks.py``, ``Kinks(l1=True)``), which needs no JAX gradient.
Measured on an 8-core x86 CPU (torch 2.13.0+cpu, 2 threads): flows ≤ 3.2e-4
px, losses ≤ 2.1e-6 relative, pinned gradients ≤ 1.6e-5 of the float64
gradient's largest entry (batch-shared's frame 0 ``cnet.conv1.weight``,
1.58e-5), held at 1e-4. With the ReLUs alone pinned that leaf read 9.75e-4:
one residual of the gradient loss's L1 term, −1.2e-5 in float64 and 6.5e-6
in fp32 (iteration 0, cell (5, 19), the y gradient), takes its gradient
with the other sign; at 4 threads the fp32 run keeps float64's sign and the
leaf reads 9.5e-6. ``python scripts/torch_grad_parity_seeds.py --cpu
--variant batch-shared`` holds this configuration over eight seed pairs
(frame 0, batch 1): pinned 7.7e-6 to 1.9e-5 (median 9.4e-6; the worst leaf
with a live gradient 3.5e-5), free 2.0e-4 to 1.9e-2; with the L1 terms free,
pair (70, 5) read 5.1e-3, a sequence-loss residual of flow_init at −3.9e-5
px in float64 and 2.7e-5 in fp32. Batch norm's backward is not the cause:
each of that pair's 33 batch norms, on its fp32 input and upstream
gradient, is within 5e-7 of float64's.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcs_tpu.config import ModelConfig as JaxConfig
from tcs_tpu.models import CameraParams as JaxCam
from tcs_tpu.models import TCStereo as JaxTCStereo
from tcs_tpu.models import TemporalState as JaxState
from tcs_tpu.config import TrainConfig as JaxTrainConfig
from tcs_tpu.models.layers import BatchNorm as JaxBatchNorm
from tcs_tpu.train import train_step as jstep
from tcs_tpu_torch import ModelConfig, TrainConfig
from tcs_tpu_torch.convert import params_from_state_dict, state_dict_from_jax
from tcs_tpu_torch.models import CameraParams, TCStereo, TemporalState
from tcs_tpu_torch.data.synthetic import SyntheticStereoSequence
from tcs_tpu_torch.models.extractor import MultiBasicEncoder
from tcs_tpu_torch.models.layers import BatchNorm, set_compute_dtype
from tcs_tpu_torch.train import SequenceBatch, frame_losses
from tcs_tpu_torch.utils.kinks import Kinks, widened

# The test processes share the host: two intra-op threads each, so that
# several workers do not oversubscribe its cores.
torch.set_num_threads(2)

B, H, W, ITERS = 1, 64, 96, 2
FLOW_TOL = 5e-2  # px: the bound tests/test_parity.py holds tcs_tpu to against the reference
FRAMES = 2
TRAIN_KW = dict(train_iters=ITERS, batch_size=B, image_size=(H, W), frame_length=FRAMES,
                num_steps=100)
LOSS_RTOL = 1e-3  # train mode: each loss against tcs_tpu's, relative
PINNED_RTOL = 1e-4  # of the float64 gradient's largest entry, kinks pinned (measured 1.6e-5)
NAMED_LEAVES = ("cnet.conv1.weight", "update_block.gru08.convzr.weight",
                "disp_completor.conv_disp_stem.0.weight", "disp_refine.mask.2.weight")
VARIANTS = {
    "group-fnet-slowfast": dict(context_norm="group", shared_backbone=False,
                                slow_fast_gru=True),
    "batch-shared": dict(context_norm="batch"),
    "instance-fnet-slowfast": dict(context_norm="instance", shared_backbone=False,
                                   slow_fast_gru=True),
}


def _configs(name):
    kw = VARIANTS[name]
    jax_kw = dict(packed_dual_encoder=False) if kw["context_norm"] == "batch" else {}
    return (ModelConfig(mixed_precision=False, corr_dtype="float32", **kw),
            JaxConfig(mixed_precision=False, corr_dtype="float32", **kw, **jax_kw))


def _port(cfg, seed=3):
    port = TCStereo(cfg, device="cpu", seed=seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for n, p in port.named_parameters():
            if ".norm" in n:  # also the downsample branches' norm3
                lo, hi = (0.5, 1.5) if n.endswith("weight") else (-0.2, 0.2)
                p.uniform_(lo, hi, generator=g)
    return port


def _pose(k):
    T = np.eye(4, dtype=np.float32)
    T[0, 3], T[1, 3], T[2, 3] = 0.02 * k, 0.01 * k, 0.05 * k
    return T[None]


@pytest.mark.parametrize("name", VARIANTS)
def test_converted_tree_matches_init(name):
    cfg, jcfg = _configs(name)
    port = _port(cfg)
    tree = params_from_state_dict(port.state_dict(), cfg.context_norm)
    img = jnp.zeros((B, H, W, 3))
    cam = JaxCam(K=jnp.eye(3)[None], baseline=jnp.ones((B,)))
    shapes = jax.eval_shape(
        lambda key: JaxTCStereo(cfg=jcfg).init(key, img, img, JaxState.zeros(B, H, W, jcfg),
                                               cam, jnp.eye(4)[None], iters=1,
                                               test_mode=False),
        jax.random.PRNGKey(0))

    def paths(t):
        return {jax.tree_util.keystr(k): tuple(np.shape(v))
                for k, v in jax.tree_util.tree_leaves_with_path(t)}

    assert paths(tree) == paths(shapes)
    back = state_dict_from_jax(tree)
    for k, v in port.state_dict().items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("name", VARIANTS)
def test_two_frame_flows_match_tcs_tpu(name):
    """Frame 0 (argmax bootstrap) and frame 1 (warp path), one jitted step."""
    cfg, jcfg = _configs(name)
    port = _port(cfg)
    jparams = jax.tree_util.tree_map(
        jnp.asarray, params_from_state_dict(port.state_dict(), cfg.context_norm))
    jm = JaxTCStereo(cfg=jcfg)
    step = jax.jit(lambda p, a, b, s, c, T: jm.apply(p, a, b, s, c, T, iters=ITERS,
                                                      test_mode=True))
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 255, size=(2, 2, B, H, W, 3)).astype(np.float32)
    K = np.array([[[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]]], np.float32)
    js, ts = JaxState.zeros(B, H, W, jcfg), TemporalState.zeros(B, H, W, cfg, device="cpu")
    jc = JaxCam(K=jnp.asarray(K), baseline=jnp.full((B,), 0.5))
    tc = CameraParams(K=torch.from_numpy(K), baseline=torch.full((B,), 0.5))
    for k in range(2):
        jo = step(jparams, jnp.asarray(imgs[k, 0]), jnp.asarray(imgs[k, 1]), js, jc,
                  jnp.asarray(_pose(k)))
        to = port(torch.from_numpy(imgs[k, 0]), torch.from_numpy(imgs[k, 1]), ts, tc,
                  torch.from_numpy(_pose(k)), iters=ITERS)
        js, ts = jo.new_state, to.new_state
        assert to.flow.shape == (B, H, W, 1) and float(to.flow.max()) <= 0.0
        err = np.abs(np.asarray(jo.flow) - to.flow.numpy()).max()
        assert err <= FLOW_TOL, (k, err)


def test_batch_norm_in_test_mode_uses_the_batch_statistics():
    """The context encoder's output for one sample changes when another
    sample joins the batch, in the model's eval() mode; the port's BatchNorm
    is tcs_tpu's on both batches."""
    torch.manual_seed(0)
    enc = MultiBasicEncoder(norm_fn="batch").eval()
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, size=(2, 3, 32, 48)).astype(np.float32)
    with torch.no_grad():
        alone = enc(torch.from_numpy(x[:1]), dual_inp=False)[0][0][0]
        joined = enc(torch.from_numpy(x), dual_inp=False)[0][0][0][:1]
    assert (alone - joined).abs().max().item() > 1e-3

    norm = BatchNorm(8)
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5)
        norm.bias.uniform_(-0.2, 0.2)
    jnorm = JaxBatchNorm()
    params = {"params": {"scale": jnp.asarray(norm.weight.detach().numpy()),
                         "bias": jnp.asarray(norm.bias.detach().numpy())}}
    y = rng.normal(size=(2, 8, 5, 7)).astype(np.float32)
    outs = []
    for batch in (y[:1], y):
        got = norm(torch.from_numpy(batch)).detach().numpy()
        want = np.asarray(jnorm.apply(params, jnp.asarray(batch.transpose(0, 2, 3, 1))))
        np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), atol=1e-5)
        outs.append(got[:1])
    assert np.abs(outs[0] - outs[1]).max() > 1e-3


def _clip():
    """A two-plane clip whose camera also moves along y and z, so that no
    splat target falls on an integer (``tests/test_torch_train.py``)."""
    ds = SyntheticStereoSequence(frame_length=FRAMES, height=H, width=W, layered_frac=1.0)
    c = ds.load_sample(0, np.random.default_rng(7))
    for t in range(FRAMES):
        c["T"][t, 1, 3] += 0.07 * t
        c["T"][t, 2, 3] += 0.3 * t
    return [c]


def _port_frames(cfg, port_sd, batch, wide=False, replay=None):
    """The port's train-mode frames, each from the previous one's carried
    state: outputs, losses and metrics, the named leaves' gradients of each
    frame's own loss, and the kinks' record; in float64 with ``wide``."""
    tcfg = TrainConfig(model=cfg, **TRAIN_KW)
    model = TCStereo(cfg, device="cpu")
    model.load_state_dict(port_sd)
    if wide:
        model.double()
        model.dtype = torch.float64
        set_compute_dtype(model, torch.float64)
        batch = SequenceBatch(**{k: v.double() for k, v in vars(batch).items()})
    cam = CameraParams(K=batch.K, baseline=batch.baseline)
    state = TemporalState.zeros(B, H, W, cfg, device="cpu")
    frames = []
    with contextlib.ExitStack() as stack:
        if wide:
            stack.enter_context(widened())
        kinks = stack.enter_context(Kinks(replay, l1=True))
        for t in range(FRAMES):
            frame = batch.frame(t)
            out = model(frame.image1, frame.image2, state, cam, frame.T, iters=ITERS,
                        test_mode=False)
            loss, metrics = frame_losses(out, frame, tcfg)
            model.zero_grad(set_to_none=True)
            loss.backward()
            frames.append(dict(out=out, loss=loss.item(),
                               metrics={k: v.item() for k, v in metrics.items()},
                               grads={k: model.get_parameter(k).grad.double().clone()
                                      for k in NAMED_LEAVES}))
            state = out.new_state
    return frames, kinks


@pytest.mark.parametrize("name", VARIANTS)
def test_train_mode_matches_tcs_tpu(name):
    """Two frames in train mode: flows, the four losses and their metrics
    against tcs_tpu's forward, each side on its own carry; then the port's
    fp32 gradients of the named leaves, kinks pinned, against float64."""
    cfg, jcfg = _configs(name)
    port = _port(cfg)
    sd = port.state_dict()
    jparams = jax.tree_util.tree_map(jnp.asarray,
                                     params_from_state_dict(sd, cfg.context_norm))
    jtcfg = JaxTrainConfig(model=jcfg, **TRAIN_KW)
    jm = JaxTCStereo(cfg=jcfg)

    @jax.jit
    def jax_frame(params, frame, state, cam):
        out = jm.apply(params, frame.image1, frame.image2, state, cam, frame.T, iters=ITERS,
                       test_mode=False)
        loss, metrics = jstep.frame_losses(out, frame, jtcfg)
        return loss, metrics, out

    batch = SequenceBatch.from_numpy(_clip(), "cpu")
    jbatch = jstep.SequenceBatch(**{k: jnp.asarray(getattr(batch, k).numpy())
                                    for k in ("image1", "image2", "flow", "valid", "T",
                                              "K", "baseline")})
    fp32, free = _port_frames(cfg, sd, batch)
    jcam, js = JaxCam(K=jbatch.K, baseline=jbatch.baseline), JaxState.zeros(B, H, W, jcfg)
    for t, r in enumerate(fp32):
        jl, jmets, jo = jax_frame(jparams, jbatch.frame(t), js, jcam)
        js, to = jo.new_state, r["out"]
        for field, a, b in (("flow", jo.flow, to.flow),
                            ("flow_init", jo.flow_init, to.flow_init),
                            ("flow_mono", jo.flow_mono, to.flow_mono),
                            ("flow_predictions", jo.flow_predictions[0], to.flow_predictions[0]),
                            ("refined", jo.flow_predictions[1], to.flow_predictions[1])):
            err = np.abs(np.asarray(a) - b.detach().numpy()).max()
            print(f"[{name}] frame {t} {field}: {err:.2e} px")
            assert err <= FLOW_TOL, (t, field, err)
        for k, want in (("loss", float(jl)), *((m, float(jmets[m])) for m in (
                "init_loss", "norm_loss", "grad_loss", "epe"))):
            got = r["loss"] if k == "loss" else r["metrics"][k]
            print(f"[{name}] frame {t} {k}: port {got:.6f} tcs_tpu {want:.6f}")
            assert abs(got - want) <= LOSS_RTOL * abs(want), (t, k, got, want)

    wide, k64 = _port_frames(cfg, sd, batch, wide=True)
    pinned, k32 = _port_frames(cfg, sd, batch, replay=k64.sides)
    print(f"[{name}] {free.crossed(k64.sides)} of "
          f"{sum(m.numel() for m in k64.sides)} ReLU units fall on another side in fp32")
    for t in range(FRAMES):
        for leaf in NAMED_LEAVES:
            ref = wide[t]["grads"][leaf]
            share = ((pinned[t]["grads"][leaf] - ref).abs().max() / ref.abs().max()).item()
            print(f"[{name}] frame {t} {leaf}: {share:.2e} of the float64 gradient's largest "
                  "entry")
            assert np.isfinite(share) and share <= PINNED_RTOL, (t, leaf, share)
