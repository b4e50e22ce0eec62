"""The hand-written backward passes of the port against tcs_tpu's.

On the CPU the autograd functions of ``ops.corr.lookup`` and
``ops.splat.splat_sum`` run their plain backward versions, the ones the CUDA
kernels are held to on the card. Here those go against the JAX package's
``custom_vjp``s and against JAX autodiff through the plain forward.
Bounds: 1e-5 of the gradient's largest entry (measured: lookup 0 against the
custom_vjp and 1.7e-6 against autodiff of the gather, which takes its
fraction of c + k and so rounds it differently; splat ≤ 1.1e-7).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tcs_tpu.ops import corr as jcorr
from tcs_tpu.ops import splat as jsplat
from tcs_tpu_torch import ModelConfig, TrainConfig
from tcs_tpu_torch.models import CameraParams, TCStereo, TemporalState
from tcs_tpu_torch.ops import corr as tcorr
from tcs_tpu_torch.ops import splat as tsplat
from tcs_tpu_torch.train import FrameBatch, frame_losses

# The test processes share the host: two intra-op threads each, so that
# several workers do not oversubscribe its cores.
torch.set_num_threads(2)

GRAD_RTOL = 1e-5  # of the gradient's largest entry
RADIUS, LEVELS = 4, 4


def _close(t, j):
    j = np.asarray(j)
    assert t.shape == j.shape
    assert np.abs(t.numpy() - j).max() <= GRAD_RTOL * np.abs(j).max()


@pytest.fixture(scope="module")
def lookup_case():
    """An odd pyramid (45, 22, 11, 5 wide), coordinates past both ends of the
    row, on integers and between them, and a random output cotangent."""
    rng = np.random.default_rng(0)
    B, H, W = 2, 3, 45
    cv = rng.normal(size=(B, H, W, W)).astype(np.float32)
    pyr = [np.array(p) for p in jcorr.corr_pyramid(jnp.asarray(cv), LEVELS)]
    coords = rng.uniform(-12, W + 12, size=(B, H, W)).astype(np.float32)
    coords[0, 0, :6] = [0.0, 3.0, 44.0, 45.0, -1.0, 21.5]
    g = rng.normal(size=(B, H, W, LEVELS * (2 * RADIUS + 1))).astype(np.float32)
    return pyr, coords, g


def _port_lookup_grads(pyr, coords, g):
    tp = [torch.from_numpy(p).requires_grad_() for p in pyr]
    tc = torch.from_numpy(coords).requires_grad_()
    out = tcorr.lookup(tp, tc, RADIUS)
    grads = torch.autograd.grad(out, tp + [tc], torch.from_numpy(g), allow_unused=True)
    return out, grads[:-1], grads[-1]


def test_lookup_backward_matches_the_custom_vjp(lookup_case):
    pyr, coords, g = lookup_case
    pyr_T = tuple(jnp.asarray(p).swapaxes(-1, -2) for p in pyr)  # (B,H,W2,W1)
    jout, vjp = jax.vjp(lambda p: jcorr.lookup_onehot_w2major_vjp(
        p, jnp.asarray(coords), RADIUS), pyr_T)
    (jgrads,) = vjp(jnp.asarray(g))
    out, grads, _ = _port_lookup_grads(pyr, coords, g)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-6)
    for tg, jg in zip(grads, jgrads):
        _close(tg, jnp.swapaxes(jg, -1, -2))


def test_lookup_backward_matches_autodiff_of_the_gather(lookup_case):
    pyr, coords, g = lookup_case
    jgrads = jax.grad(lambda p: jnp.sum(jcorr.lookup_gather(
        p, jnp.asarray(coords), RADIUS) * g))(tuple(map(jnp.asarray, pyr)))
    _, grads, _ = _port_lookup_grads(pyr, coords, g)
    for tg, jg in zip(grads, jgrads):
        _close(tg, jg)


def test_lookup_coordinates_get_no_gradient(lookup_case):
    _, _, dcoords = _port_lookup_grads(*lookup_case)
    assert dcoords is None


def test_lookup_backward_plain_on_non_finite_coordinates(lookup_case):
    """A non-finite or far-out coordinate selects no cell: its rows are zero."""
    pyr, coords, g = lookup_case
    coords = coords.copy()
    coords[1, 2, :3] = [np.nan, np.inf, 1e20]
    douts = tcorr.lookup_bwd_plain(torch.from_numpy(g), torch.from_numpy(coords), RADIUS,
                                   [p.shape[-1] for p in pyr], torch.float32)
    for d in douts:
        assert torch.isfinite(d).all() and not d[1, 2, :3].any() and d[0].any()


def test_lookup_backward_in_bf16_rounds_once(lookup_case):
    pyr, coords, g = lookup_case
    widths = [p.shape[-1] for p in pyr]
    args = (torch.from_numpy(g), torch.from_numpy(coords), RADIUS, widths)
    for lo, hi in zip(tcorr.lookup_bwd_plain(*args, torch.bfloat16),
                      tcorr.lookup_bwd_plain(*args, torch.float32)):
        assert lo.dtype == torch.bfloat16 and torch.equal(lo, hi.to(torch.bfloat16))


@pytest.fixture(scope="module")
def splat_case():
    rng = np.random.default_rng(1)
    B, H, W, C = 2, 10, 14, 7
    values = rng.normal(size=(B, H, W, C)).astype(np.float32)
    flow = rng.normal(scale=2.5, size=(B, H, W, 2)).astype(np.float32)
    flow[0, :, :2, 0] = -30.0  # out of the image
    flow[0, 4, 4] = [2.0, -1.0]  # an integer target
    flow[1, 2, 5, 0] = np.nan
    flow[1, 3, 7, 1] = np.inf
    g = rng.normal(size=(B, H, W, C)).astype(np.float32)
    return values, flow, g


def test_splat_backward_matches_the_custom_vjp(splat_case):
    values, flow, g = splat_case
    jout, vjp = jax.vjp(jsplat.splat_sum_gatherbwd, jnp.asarray(values), jnp.asarray(flow))
    jdv, jdf = vjp(jnp.asarray(g))
    tv = torch.from_numpy(values).requires_grad_()
    tf = torch.from_numpy(flow).requires_grad_()
    out = tsplat.splat_sum(tv, tf)
    dv, df = torch.autograd.grad(out, (tv, tf), torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5)
    assert torch.isfinite(dv).all() and torch.isfinite(df).all()
    assert not df[1, 2, 5].any() and not df[1, 3, 7].any() and not dv[1, 2, 5].any()
    _close(dv, jdv)
    _close(df, jdf)


def test_splat_backward_matches_autodiff_of_the_scatter(splat_case):
    values, flow, g = splat_case
    flow = np.where(np.isfinite(flow), flow, -100.0).astype(np.float32)
    jdv, jdf = jax.grad(lambda v, f: jnp.sum(jsplat.splat_sum(v, f) * g), argnums=(0, 1))(
        jnp.asarray(values), jnp.asarray(flow))
    dv, df = tsplat.splat_sum_bwd_plain(*map(torch.from_numpy, (g, values, flow)))
    _close(dv, jdv)
    _close(df, jdf)


def test_softsplat_differentiates_through_the_function(splat_case):
    """``softsplat``'s exp, mask and division are autograd's; the scatter in
    the middle is the function with the hand-written backward."""
    values, flow, _ = splat_case
    metric = np.linspace(-1, 1, values[..., :1].size, dtype=np.float32
                         ).reshape(values[..., :1].shape)

    def jf(v, f, m):
        out, _ = jsplat.softsplat(v, f, m, "soft-clipeps", backend="xla_gatherbwd")
        return jnp.sum(out ** 2)

    jgrads = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (values, flow, metric)))
    targs = [torch.from_numpy(x).requires_grad_() for x in (values, flow, metric)]
    out, _ = tsplat.softsplat(*targs)
    for tg, jg in zip(torch.autograd.grad(torch.sum(out ** 2), targs), jgrads):
        assert np.abs(tg.numpy() - np.asarray(jg)).max() <= 1e-4 * np.abs(jg).max()


def test_incoming_state_carries_no_gradient():
    """The carry is detached where it is consumed: a frame's loss has no
    gradient with respect to a non-trivial incoming state (the port's form of
    tcs_tpu's ``test_incoming_state_carries_no_gradient``)."""
    H, W = 64, 96
    mcfg = ModelConfig(mixed_precision=False, corr_dtype="float32")
    cfg = TrainConfig(model=mcfg, train_iters=1)
    model = TCStereo(mcfg, device="cpu", seed=3)
    g = torch.Generator().manual_seed(0)
    state = TemporalState.zeros(1, H, W, mcfg, device="cpu")
    state = dataclasses.replace(
        state, valid=True,
        disp_q=(torch.rand(state.disp_q.shape, generator=g) * 4).requires_grad_(),
        fmap1=torch.randn(state.fmap1.shape, generator=g).requires_grad_(),
        net_list=tuple(torch.randn(n.shape, generator=g).requires_grad_()
                       for n in state.net_list))
    cam = CameraParams(K=torch.tensor([[[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]]]),
                       baseline=torch.full((1,), 0.5))
    T = torch.eye(4)[None].clone()
    T[0, 0, 3] = -0.05
    frame = FrameBatch(image1=torch.rand(1, H, W, 3, generator=g) * 255,
                       image2=torch.rand(1, H, W, 3, generator=g) * 255,
                       flow=-torch.rand(1, H, W, 1, generator=g) * 8,
                       valid=torch.ones(1, H, W, 1), T=T)
    out = model(frame.image1, frame.image2, state, cam, frame.T, iters=1, test_mode=False)
    loss, _ = frame_losses(out, frame, cfg)
    leaves = (state.disp_q, state.fmap1, *state.net_list)
    grads = torch.autograd.grad(loss, leaves + (model.cnet.conv1.weight,),
                                allow_unused=True)
    assert all(gr is None for gr in grads[:-1])
    assert grads[-1] is not None and grads[-1].abs().max() > 0
    for t in (out.new_state.disp_q, out.new_state.fmap1, *out.new_state.net_list):
        assert not t.requires_grad


def _kinked_net():
    torch.manual_seed(4)
    return torch.nn.Sequential(torch.nn.Conv2d(2, 8, 3, padding=1), torch.nn.ReLU(),
                               torch.nn.Conv2d(8, 8, 3, padding=1), torch.nn.LeakyReLU(0.01),
                               torch.nn.Conv2d(8, 1, 1))


def _kinked_grads(net, x, replay=None, record=True):
    import contextlib

    from tcs_tpu_torch.utils.kinks import Kinks

    net.zero_grad()
    with (Kinks(replay) if record else contextlib.nullcontext()) as kinks:
        net(x).abs().sum().backward()
    return [p.grad.clone() for p in net.parameters()], kinks


def test_kinks_recording_changes_no_value_and_no_gradient():
    net, x = _kinked_net(), torch.randn(2, 2, 6, 7, generator=torch.Generator().manual_seed(5))
    plain, _ = _kinked_grads(net, x, record=False)
    recorded, kinks = _kinked_grads(net, x)
    assert [tuple(s.shape) for s in kinks.sides] == [(2, 8, 6, 7)] * 2
    for a, b in zip(plain, recorded):
        assert torch.equal(a, b)
    assert torch.nn.functional.relu(-torch.ones(1)).item() == 0.0  # the patch is gone


def test_kinks_replay_puts_units_on_the_other_runs_side():
    """Moving the input flips some units; replaying the first run's sides on
    the moved input gives the gradient of the first run's linear region."""
    net = _kinked_net()
    x = torch.randn(2, 2, 6, 7, generator=torch.Generator().manual_seed(5))
    moved = x + 0.3 * torch.randn(x.shape, generator=torch.Generator().manual_seed(6))
    _, first = _kinked_grads(net, x)
    _, free = _kinked_grads(net, moved)
    assert free.crossed(first.sides) > 0
    on = [torch.where(s, 1.0, slope) for s, slope in zip(first.sides, (0.0, 0.01))]
    net.zero_grad()
    net[4](net[2](net[0](moved) * on[0]) * on[1]).abs().sum().backward()
    want = [p.grad.clone() for p in net.parameters()]
    got, _ = _kinked_grads(net, moved, replay=first.sides)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_pool2x_gradient_does_not_depend_on_the_memory_layout():
    """A hidden state reaches ``pool2x`` as an NCHW view of channel-last
    memory; values and gradients are those of the contiguous tensor."""
    from tcs_tpu_torch.ops import sampler

    g = torch.Generator().manual_seed(9)
    hidden = torch.randn(2, 7, 10, 16, generator=g)
    cot = torch.randn(2, 16, 4, 5, generator=g)
    outs = []
    for view in (hidden.permute(0, 3, 1, 2), hidden.permute(0, 3, 1, 2).contiguous()):
        x = view.detach().requires_grad_()
        y = sampler.pool2x_nchw(x)
        outs.append((y.detach(), torch.autograd.grad(y, x, cot)[0]))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    # Against the definition: zero padding counts in the mean of 9.
    padded = torch.nn.functional.pad(hidden.permute(0, 3, 1, 2), (1, 1, 1, 1))
    want = sum(padded[:, :, dy:dy + 8:2, dx:dx + 10:2] for dy in range(3) for dx in range(3)) / 9
    torch.testing.assert_close(outs[0][0], want)
