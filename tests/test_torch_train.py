"""The port's train mode, frame losses, schedule and train step against
tcs_tpu, in fp32 at 64×96 with 2 frames and 2 iterations.

The weights start in the port (a torch seed), go to tcs_tpu through
``convert_state_dict`` and come back through ``state_dict_from_jax``, as in
``test_torch_model.py``. Gradients come back the same way: a tcs_tpu gradient
tree has the structure of its parameter tree, so ``state_dict_from_jax(grads)``
names and lays them out as the port's parameters.

Two JAX programs are compiled, each once per module: ``value_and_grad`` of one
frame's loss (it also returns the frame's outputs; the carried state's
``valid`` flag is traced, so it serves frame 0 and frame 1) and the train
step.

Every gradient test runs on two (weights, scene) seed pairs. Bounds, with the
largest reading over both pairs on an 8-core x86 CPU beside them:
- train-mode outputs: 5e-2 px on flows (measured ≤ 2.5e-4), 1e-3 on the
  refined gradients and the cost volume (≤ 5.2e-5);
- loss: 1e-3 relative (measured ≤ 4e-7; its metrics ≤ 7e-7);
- the four named leaves: 3e-2 of the leaf's largest gradient entry, the
  free-kink limit that ``chip_smoke.py`` phase 6 holds them to (see below);
  the whole gradient and the median leaf at 1e-2 in
  ``test_frame_gradient_of_every_parameter``;
- ``live_loss`` and ``grad_norm`` of two steps: 1e-3 relative (measured
  ≤ 4e-7 and ≤ 6e-6).

A 4-frame window (the fl4 recipes') runs frame by frame through the same
compiled one-frame program, each side on its own carry, so frames 2 and 3
take the state carried out of a warped frame. They are held to the bounds
above: flows ≤ 2.3e-3 px, refined gradients and cost volume ≤ 5.3e-4, loss
≤ 1.6e-6 relative, named leaves ≤ 2.6e-2 (seed pair (62, 17); (61, 7) reads
≤ 2.3e-4). The carry lets the two sides drift apart frame by frame, and in
frame 2 of seed pair (62, 17) a sequence-loss residual lies 2.4e-7 px from
the kink of |r|, closer than the two sides' flows are to each other: its
gradient's sign is not fixed by fp32. That is kink noise, as the ReLUs' is:
there the port's own fp32 run is 4.8e-2 of the largest entry from a float64
run of the port on ``disp_refine.mask.2.weight``, and 9.2e-5 once its ReLU
and L1 kinks are pinned (``tests/test_torch_grad_witness.py``). So the
4-frame comparison puts the port's L1 kinks on tcs_tpu's sides
(:func:`_l1_sign_pin`, exact but for terms within rounding of zero); the
ReLU kinks stay free.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tcs_tpu.config import ModelConfig as JaxModelConfig
from tcs_tpu.config import TrainConfig as JaxTrainConfig
from tcs_tpu.data.synthetic import SyntheticStereoSequence as JaxSynthetic
from tcs_tpu.models import CameraParams as JaxCam
from tcs_tpu.models import TCStereo as JaxTCStereo
from tcs_tpu.models import TemporalState as JaxState
from tcs_tpu.train import optim as joptim
from tcs_tpu.train import train_step as jstep
from tcs_tpu_torch import ModelConfig, TrainConfig
from tcs_tpu_torch import losses as L
from tcs_tpu_torch.convert import state_dict_from_jax
from tcs_tpu_torch.data.synthetic import SyntheticStereoSequence
from tcs_tpu_torch.models import CameraParams, TCStereo, TemporalState
from tcs_tpu_torch.train import (
    SequenceBatch,
    frame_losses,
    make_train_step,
    onecycle_linear_schedule,
)
from tools.convert_torch_ckpt import convert_state_dict

# The test processes share the host: two intra-op threads each, so that
# several workers do not oversubscribe its cores.
torch.set_num_threads(2)

B, H, W, ITERS, FRAMES = 1, 64, 96, 2, 2
FLOW_TOL, FIELD_TOL = 5e-2, 1e-3
LOSS_RTOL = 1e-3
GRAD_RTOL = 1e-2  # of a leaf's largest gradient entry: whole gradient, median leaf
NAMED_GRAD_RTOL = 3e-2  # a named leaf, kinks free: chip_smoke.SMALL_GRAD_RTOL_FREE
NAMED_LEAVES = ("cnet.conv1.weight", "update_block.gru08.convzr.weight",
                "disp_completor.conv_disp_stem.0.weight", "disp_refine.mask.2.weight")
SEED_PAIRS = ((61, 7), (62, 17))  # (weights, scene)
MCFG = ModelConfig(mixed_precision=False, corr_dtype="float32")
CFG = TrainConfig(model=MCFG, train_iters=ITERS, batch_size=B, image_size=(H, W),
                  frame_length=FRAMES, num_steps=100)
JMCFG = JaxModelConfig(mixed_precision=False, corr_dtype="float32")
JCFG = JaxTrainConfig(model=JMCFG, train_iters=ITERS, batch_size=B, image_size=(H, W),
                      frame_length=FRAMES, num_steps=100)


def _clip(seed=7, frames=FRAMES):
    """Two-plane synthetic clips. The dataset's camera slides along x by a
    whole number of pixels, which puts every splat target on an integer: the
    coverage mask of the warp then hangs on the last bit of the projection.
    A parity test needs a generic pose, so frame t also moves along y and z."""
    ds = SyntheticStereoSequence(frame_length=frames, height=H, width=W,
                                 layered_frac=1.0)
    clips = [ds.load_sample(i, np.random.default_rng(seed + i)) for i in range(B)]
    for c in clips:
        for t in range(frames):
            c["T"][t, 1, 3] += 0.07 * t
            c["T"][t, 2, 3] += 0.3 * t
    return clips


@pytest.fixture(scope="module", params=SEED_PAIRS, ids=lambda p: f"seeds{p[0]}-{p[1]}")
def setup(request):
    model_seed, scene_seed = request.param
    seeded = TCStereo(MCFG, device="cpu", seed=model_seed)
    jparams = jax.tree_util.tree_map(jnp.asarray, convert_state_dict(
        {k: v.numpy() for k, v in seeded.state_dict().items()}))
    tbatch, jbatch = _batches(_clip(scene_seed))
    return seeded.state_dict(), jparams, tbatch, jbatch, scene_seed


def _batches(clip):
    tbatch = SequenceBatch.from_numpy(clip, "cpu")
    jbatch = jstep.SequenceBatch(**{k: jnp.asarray(getattr(tbatch, k).numpy())
                                    for k in ("image1", "image2", "flow", "valid", "T",
                                              "K", "baseline")})
    return tbatch, jbatch


def _port(state_dict):
    model = TCStereo(MCFG, device="cpu", seed=12)
    model.load_state_dict(state_dict, strict=True)
    return model


@pytest.fixture(scope="module")
def jax_programs():
    """The two compiled tcs_tpu programs, shared by every seed pair:
    ``value_and_grad`` of one frame's loss, and the train step."""
    jm = JaxTCStereo(cfg=JMCFG)

    @jax.jit
    def jax_frame(params, frame, state, jcam):
        def loss_fn(p):
            out = jm.apply(p, frame.image1, frame.image2, state, jcam, frame.T,
                           iters=ITERS, test_mode=False)
            loss, mets = jstep.frame_losses(out, frame, JCFG)
            return loss, (out, mets)

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    return jm, jax_frame, jstep.make_train_step(jm, JCFG, donate=False)


def _l1_sign_pin(to, jo, frame):
    """A term whose value is within rounding of zero and whose gradient turns
    the sign of every L1 residual of the port's sequence loss into the sign
    tcs_tpu's residual has there: the kinks of |r| pinned to tcs_tpu's sides.

    A pixel whose residual lies within the two sides' flow difference of zero
    takes one sign of |r|'s gradient in one implementation and the other in
    the other, which moves a named leaf by percents (module docstring)."""
    with torch.no_grad():
        mag = torch.sqrt(torch.sum(frame.flow ** 2, dim=-1, keepdim=True))
        v = ((frame.valid >= 0.5) & (mag < 700.0)).float()
        count = v.sum().clamp(min=1.0)
    w = L.loss_weights(ITERS, CFG.loss_gamma)
    terms = [(to.flow_init, jo.flow_init, 0.1), (to.flow_mono, jo.flow_mono, 0.1)]
    for i in range(ITERS):
        terms.append((to.flow_predictions[0][i], jo.flow_predictions[0][i], w[i]))
        terms.append((to.flow_predictions[1][i], jo.flow_predictions[1][i], 1.2 * w[i]))
    pin = 0.0
    for t_flow, j_flow, c in terms:
        r = t_flow - frame.flow
        flip = torch.sign(torch.from_numpy(np.array(j_flow)) - frame.flow) - torch.sign(r.detach())
        pin = pin + c * torch.sum(flip * r * v) / count
    return pin


def _frames(sd, jparams, tbatch, jbatch, jax_frame, pin_l1=False):
    """Loss, outputs and all gradients of each frame of the window, each
    side from its own carried state, through the one-frame programs; with
    ``pin_l1`` the port's L1 kinks on tcs_tpu's sides (:func:`_l1_sign_pin`)."""
    jcam = JaxCam(K=jbatch.K, baseline=jbatch.baseline)

    model = _port(sd)
    tcam = CameraParams(K=tbatch.K, baseline=tbatch.baseline)
    js, ts = JaxState.zeros(B, H, W, JMCFG), TemporalState.zeros(B, H, W, MCFG, device="cpu")
    results = []
    for t in range(tbatch.image1.shape[1]):
        (jl, (jo, jmets)), jg = jax_frame(jparams, jbatch.frame(t), js, jcam)
        frame = tbatch.frame(t)
        to = model(frame.image1, frame.image2, ts, tcam, frame.T, iters=ITERS,
                   test_mode=False)
        tl, tmets = frame_losses(to, frame, CFG)
        model.zero_grad(set_to_none=True)
        (tl + _l1_sign_pin(to, jo, frame) if pin_l1 else tl).backward()
        tg = {k: p.grad.clone() for k, p in model.named_parameters()}
        js, ts = jo.new_state, to.new_state
        results.append(dict(jl=float(jl), tl=tl.item(), jo=jo, to=to, jmets=jmets,
                            tmets=tmets, jg=state_dict_from_jax(jg), tg=tg))
    return results


@pytest.fixture(scope="module")
def two_frames(setup, jax_programs):
    """Frame 0 (bootstrap) and frame 1 (warp path)."""
    sd, jparams, tbatch, jbatch, _ = setup
    return _frames(sd, jparams, tbatch, jbatch, jax_programs[1])


@pytest.fixture(scope="module")
def four_frames(setup, jax_programs):
    """A 4-frame window (the fl4 recipes'), frame by frame through the same
    compiled one-frame program: frames 2 and 3 carry the state out of a
    warped frame, which a 2-frame window never does."""
    sd, jparams, _, _, scene_seed = setup
    results = _frames(sd, jparams, *_batches(_clip(scene_seed, frames=4)), jax_programs[1],
                      pin_l1=True)
    return [None, None] + results[2:]  # frames 0 and 1 are the two-frame tests' own


def test_synthetic_copy_makes_the_same_clips():
    a = SyntheticStereoSequence(frame_length=3, layered_frac=0.5)
    b = JaxSynthetic(frame_length=3, layered_frac=0.5)
    for i in range(4):
        sa = a.load_sample(i, np.random.default_rng(i))
        sb = b.load_sample(i, np.random.default_rng(i))
        assert sa.keys() == sb.keys()
        for k in sa:
            np.testing.assert_array_equal(sa[k], sb[k])


@pytest.mark.parametrize("frame", [0, 1])
def test_train_mode_outputs(two_frames, frame):
    _hold_outputs(two_frames[frame])


@pytest.mark.parametrize("frame", [2, 3])
def test_train_mode_outputs_of_a_four_frame_window(four_frames, frame):
    _hold_outputs(four_frames[frame])


def _hold_outputs(r):
    jo, to = r["jo"], r["to"]
    assert to.flow_predictions[0].shape == (ITERS, B, H, W, 1)
    assert to.flow_q_predictions[0].shape == (ITERS, B, H // 4, W // 4, 1)
    assert to.disp_grad_q_predictions.shape == (ITERS, B, H // 4, W // 4, 2)
    assert to.cost_volume.shape == (B, H // 4, W // 4, W // 4)
    pairs = [("flow", jo.flow, to.flow, FLOW_TOL),
             ("flow_init", jo.flow_init, to.flow_init, FLOW_TOL),
             ("flow_mono", jo.flow_mono, to.flow_mono, FLOW_TOL),
             ("grads", jo.disp_grad_q_predictions, to.disp_grad_q_predictions, FIELD_TOL),
             ("cost_volume", jo.cost_volume, to.cost_volume, FIELD_TOL),
             ("disp_q", jo.new_state.disp_q, to.new_state.disp_q, FLOW_TOL)]
    for i in range(2):
        pairs.append((f"up{i}", jo.flow_predictions[i], to.flow_predictions[i], FLOW_TOL))
        pairs.append((f"q{i}", jo.flow_q_predictions[i], to.flow_q_predictions[i], FLOW_TOL))
    assert not to.new_state.disp_q.requires_grad
    for name, a, b, tol in pairs:
        err = np.abs(np.asarray(a) - b.detach().numpy()).max()
        print(f"{name}: {err:.2e} (bound {tol})")
        assert err <= tol, (name, err)


@pytest.mark.parametrize("frame", [0, 1])
def test_frame_loss_and_metrics(two_frames, frame):
    _hold_loss(two_frames[frame])


@pytest.mark.parametrize("frame", [2, 3])
def test_frame_loss_and_metrics_of_a_four_frame_window(four_frames, frame):
    _hold_loss(four_frames[frame])


def _hold_loss(r):
    print(f"loss: {abs(r['tl'] - r['jl']) / abs(r['jl']):.2e} relative")
    assert r["tl"] == pytest.approx(r["jl"], rel=LOSS_RTOL)
    assert set(r["tmets"]) == set(r["jmets"])
    for k, v in r["jmets"].items():
        assert float(r["tmets"][k]) == pytest.approx(float(v), rel=1e-3, abs=1e-4), k


def _grad_err(r, name):
    jg = r["jg"][name].numpy()
    return np.abs(jg - r["tg"][name].numpy()).max() / np.abs(jg).max()


@pytest.mark.parametrize("leaf", NAMED_LEAVES)
@pytest.mark.parametrize("frame", [0, 1])
def test_frame_gradient_of_named_leaf(two_frames, frame, leaf):
    err = _grad_err(two_frames[frame], leaf)
    print(f"frame {frame} {leaf}: {err:.2e} of the largest entry")
    assert err <= NAMED_GRAD_RTOL


@pytest.mark.parametrize("leaf", NAMED_LEAVES)
@pytest.mark.parametrize("frame", [2, 3])
def test_frame_gradient_of_named_leaf_of_a_four_frame_window(four_frames, frame, leaf):
    err = _grad_err(four_frames[frame], leaf)
    print(f"fl4 frame {frame} {leaf}: {err:.2e} of the largest entry")
    assert err <= NAMED_GRAD_RTOL


@pytest.mark.parametrize("frame", [0, 1])
def test_frame_gradient_of_every_parameter(two_frames, frame):
    """Gradients cross over as weights do: the converted tcs_tpu gradient
    tree has the port's parameter names and shapes, and the whole gradient
    agrees.

    Leaf by leaf the two fp32 backward passes differ by more than the forward
    passes do, because a few ReLU units fall on different sides of their kinks
    (see the module docstring), and a leaf of the completor's coarse scales
    sums over so few pixels that one such unit is percents of an entry. So
    beside the whole gradient (1e-2 in relative L2) the test bounds the median
    leaf (1e-2 of its largest entry) and the worst leaf (0.3). Measured, frames
    0 and 1 of the first seed pair, then of the second: whole gradient 1.1e-4,
    1.4e-5, 1.2e-4, 1.3e-4; median leaf 6.8e-5, 2.1e-5, 2.0e-4, 2.5e-4; worst
    leaf 6.5e-2, 2.1e-3, 4.9e-2, 4.7e-2. On the host of the module docstring's
    second reading (torch 2.13.0+cpu), where twelve units cross, frame 1 of the
    first pair reads 8.2e-3, 6.3e-4 and 8.3e-2. A bias ahead of an instance norm
    has no gradient but rounding, on both sides.
    """
    r = two_frames[frame]
    assert set(r["jg"]) == set(r["tg"])
    gmax = max(float(g.abs().max()) for g in r["jg"].values())
    errs = []
    for name, tg in r["tg"].items():
        assert r["jg"][name].shape == tg.shape, name
        if float(r["jg"][name].abs().max()) > 1e-5 * gmax:
            errs.append(_grad_err(r, name))
        else:
            assert float(tg.abs().max()) <= 1e-4 * gmax, name
    a = torch.cat([r["jg"][k].flatten() for k in r["tg"]])
    b = torch.cat([g.flatten() for g in r["tg"].values()])
    whole = float((a - b).norm() / a.norm())
    print(f"frame {frame}: whole gradient {whole:.1e}, median leaf {np.median(errs):.1e}, "
          f"worst leaf {max(errs):.1e}")
    assert whole <= GRAD_RTOL
    assert float(np.median(errs)) <= GRAD_RTOL
    assert max(errs) <= 0.3


@pytest.mark.parametrize("recipe", ["sceneflow_recipe", "tartanair_recipe",
                                    "kitti_raw_recipe"])
def test_recipe_has_tcs_tpus_values(recipe):
    """Every field the port's configs carry, in each of the three presets."""
    import dataclasses

    import tcs_tpu.config as jconfig
    import tcs_tpu_torch.config as tconfig

    want, got = getattr(jconfig, recipe)(), getattr(tconfig, recipe)()
    for f in dataclasses.fields(got):
        if f.name != "model":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    for f in dataclasses.fields(got.model):
        assert getattr(got.model, f.name) == getattr(want.model, f.name), f.name


@pytest.mark.parametrize("total", [1000, 200_100])
def test_schedule(total):
    js = joptim.onecycle_linear_schedule(2e-4, total)
    ts = onecycle_linear_schedule(2e-4, total)
    warm = max(int(0.01 * total), 1)
    for step in (0, 1, warm - 1, warm, warm + 1, total // 2, total, total + 5):
        assert ts(step) == pytest.approx(float(js(step)), rel=1e-6), step
    assert ts(warm) == pytest.approx(2e-4) and ts(0) == pytest.approx(2e-4 / 25)


def test_scheduler_drives_the_optimizer_at_the_schedule():
    from tcs_tpu_torch.train import make_optimizer

    p = torch.nn.Parameter(torch.ones(3))
    opt, sched = make_optimizer([p], CFG)
    want = onecycle_linear_schedule(CFG.lr, CFG.num_steps + 100)
    group = opt.param_groups[0]
    assert (group["betas"], group["eps"], group["weight_decay"]) == ((0.9, 0.999), 1e-8, 1e-5)
    for k in range(5):
        assert group["lr"] == pytest.approx(want(k), rel=1e-9)
        p.grad = torch.ones(3)
        opt.step()
        sched.step()


@pytest.mark.parametrize("scale", [10.0, 0.01])
def test_clip_is_optaxs(scale):
    """g · clip / max(‖g‖, clip), above and below the threshold."""
    import optax

    from tcs_tpu_torch.train import optim

    rng = np.random.default_rng(8)
    raw = [(scale * rng.normal(size=s)).astype(np.float32) for s in ((4,), (2, 3))]
    want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in raw], None)
    grads = [torch.from_numpy(g.copy()) for g in raw]
    norm = optim.global_norm(grads)
    assert float(norm) == pytest.approx(float(optax.global_norm(
        [jnp.asarray(g) for g in raw])), rel=1e-6)
    optim.clip_by_global_norm_(grads, norm, 1.0)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_two_train_steps(setup, jax_programs):
    sd, jparams, tbatch, jbatch, _ = setup
    jm, _, jtrain = jax_programs
    jts = jstep.TrainState.create(apply_fn=jm.apply, params=jparams,
                                  tx=joptim.make_optimizer(JCFG))
    model = _port(sd)
    ttrain = make_train_step(model, CFG)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    losses = []
    for k in range(2):
        jts, jmets = jtrain(jts, jbatch)
        tmets = ttrain(tbatch)
        assert set(jmets) == set(tmets)
        for name in ("live_loss", "grad_norm"):
            assert float(tmets[name]) == pytest.approx(float(jmets[name]), rel=LOSS_RTOL), \
                (k, name)
        losses.append(float(tmets["live_loss"]))
    assert losses[1] < losses[0]  # the same batch twice
    moved = [k for k, v in model.state_dict().items() if not torch.equal(v, before[k])]
    assert len(moved) == len(before)
