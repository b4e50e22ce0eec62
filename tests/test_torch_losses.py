"""The port's losses and their helpers against tcs_tpu, values and gradients.

Fabricated predictions from a numpy seed go through ``tcs_tpu.losses`` (with
``jax.value_and_grad``) and ``tcs_tpu_torch.losses`` (with autograd). Bounds:
losses within 1e-5 relative (measured ≤ 6e-7), each gradient within 1e-4 of
its largest entry (measured ≤ 2e-7): both sides run the same fp32 formulas
and differ by the order of their sums.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tcs_tpu import geometry as jgeo
from tcs_tpu import losses as JL
from tcs_tpu.ops import sampler as jsampler
from tcs_tpu_torch import geometry as tgeo
from tcs_tpu_torch import losses as TL
from tcs_tpu_torch.ops import sampler as tsampler

B, H, W, ITERS = 2, 32, 48, 3
h, w = H // 4, W // 4
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4  # of the gradient's largest entry


def _t(x, grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


def _check_grads(jgrads, tgrads):
    for i, (jg, tg) in enumerate(zip(jgrads, tgrads)):
        jg = np.asarray(jg)
        assert np.abs(jg).max() > 0, i
        assert np.abs(jg - tg.numpy()).max() <= GRAD_RTOL * np.abs(jg).max(), i


def _check_metrics(jm, tm):
    assert set(jm) == set(tm)
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-6), k


@pytest.fixture(scope="module")
def gt():
    """Ground truth with a slanted surface, a step edge and a sparse valid."""
    rng = np.random.default_rng(0)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    disp = 3.0 + 0.08 * xx + 0.03 * yy + 6.0 * (xx > W // 2)
    flow = -np.broadcast_to(disp, (B, H, W)).astype(np.float32)[..., None].copy()
    flow[1] *= 0.5
    flow[0, 3, 5] = -800.0  # beyond max_flow
    valid = {"dense": np.ones((B, H, W, 1), np.float32),
             "sparse": (rng.uniform(size=(B, H, W, 1)) < 0.4).astype(np.float32)}
    valid["dense"][0, :6, :9] = 0.0
    valid["sparse"][1, 8:16, 8:24] = 1.0  # some fully valid 4×4 windows
    return flow, valid


@pytest.mark.parametrize("n", [1, 3, 5])
def test_loss_weights(n):
    np.testing.assert_allclose(TL.loss_weights(n, 0.9).numpy(),
                               np.asarray(JL.loss_weights(n, 0.9)), rtol=1e-6)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_sequence_loss(gt, kind):
    flow, valid = gt[0], gt[1][kind] > 0.5
    rng = np.random.default_rng(1)
    preds = [(flow[None] + rng.normal(scale=2.0, size=(ITERS, B, H, W, 1))
              ).astype(np.float32) for _ in range(2)]
    init, mono = [(flow + rng.normal(scale=3.0, size=flow.shape)).astype(np.float32)
                  for _ in range(2)]
    wts = JL.loss_weights(ITERS, 0.9)

    def jf(m, i, a, b):
        return JL.sequence_loss(m, i, (a, b), jnp.asarray(flow), jnp.asarray(valid), wts)

    (jl, jm), jg = jax.value_and_grad(jf, argnums=(0, 1, 2, 3), has_aux=True)(
        *map(jnp.asarray, (mono, init, *preds)))
    targs = [_t(x, True) for x in (mono, init, *preds)]
    tl, tm = TL.sequence_loss(targs[0], targs[1], (targs[2], targs[3]), _t(flow),
                              _t(valid), TL.loss_weights(ITERS, 0.9))
    assert tl.item() == pytest.approx(float(jl), rel=LOSS_RTOL)
    _check_metrics(jm, tm)
    _check_grads(jg, torch.autograd.grad(tl, targs))


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("k", [1, 3])
def test_init_loss_with_tied_costs(gt, kind, k):
    """The cost volume is quantised to steps of 0.125, so rows hold exact
    ties (beside the zeros of the suppressed band): the top-k must pick the
    first occurrences, as ``lax.top_k`` does."""
    flow, valid = gt[0], gt[1][kind] > 0.5
    rng = np.random.default_rng(2)
    cv = np.round(rng.uniform(-1, 1, size=(B, h, w, w)) * 8) / 8
    cv = (cv * np.tril(np.ones((w, w)))).astype(np.float32)

    def jf(c):
        return JL.init_loss(c, jnp.asarray(flow), jnp.asarray(valid), k=k, scale=0.25,
                            threshold=0.5)

    (jl, jm), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(cv))
    tc = _t(cv, True)
    tl, tm = TL.init_loss(tc, _t(flow), _t(valid), k=k, scale=0.25, threshold=0.5)
    assert tl.item() == pytest.approx(float(jl), rel=LOSS_RTOL)
    _check_metrics(jm, tm)
    _check_grads([jg], torch.autograd.grad(tl, [tc]))


def test_topk_first_occurrence():
    x = np.array([[0.0, 2.0, 2.0, -1.0, 2.0, 0.0], [0.0] * 6], np.float32)
    tx = _t(x, True)
    vals = TL._topk_values(tx, 3)
    np.testing.assert_array_equal(vals.detach().numpy(), np.asarray(JL._topk_values(
        jnp.asarray(x), 3)))
    (g,) = torch.autograd.grad(vals.sum(), [tx])
    jg = jax.grad(lambda a: JL._topk_values(a, 3).sum())(jnp.asarray(x))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    assert g[0].tolist() == [0, 1, 1, 0, 1, 0] and g[1].tolist() == [1, 1, 1, 0, 0, 0]


def _gt_normals(flow):
    grad_gt, _ = jgeo.disp2disp_gradient_xy(-jnp.asarray(flow))
    n = jnp.concatenate([grad_gt, -jnp.ones_like(grad_gt[..., :1])], axis=-1)
    return np.asarray(grad_gt), np.asarray(n / jnp.linalg.norm(n, axis=-1, keepdims=True))


@pytest.mark.parametrize("kind,dense_gt", [("dense", True), ("sparse", False),
                                           ("sparse", True)])
def test_disp_normal_loss(gt, kind, dense_gt):
    flow, valid = gt[0], gt[1][kind] > 0.5
    _, norm_gt = _gt_normals(flow)
    rng = np.random.default_rng(3)
    fq = [(-np.abs(rng.normal(scale=4.0, size=(ITERS, B, h, w, 1)))).astype(np.float32)
          for _ in range(2)]
    wts = JL.loss_weights(ITERS, 0.9)

    def jf(a, b):
        return JL.disp_normal_loss((a, b), jnp.asarray(norm_gt), jnp.asarray(valid), wts,
                                   scale=0.25, dense_gt=dense_gt)

    (jl, jm), jg = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        *map(jnp.asarray, fq))
    ta = [_t(x, True) for x in fq]
    tl, tm = TL.disp_normal_loss(tuple(ta), _t(norm_gt), _t(valid),
                                 TL.loss_weights(ITERS, 0.9), scale=0.25,
                                 dense_gt=dense_gt)
    assert tl.item() == pytest.approx(float(jl), rel=LOSS_RTOL)
    _check_metrics(jm, tm)
    _check_grads(jg, torch.autograd.grad(tl, ta))


@pytest.mark.parametrize("kind,dense_gt", [("dense", True), ("sparse", False),
                                           ("sparse", True)])
def test_disp_grad_loss(gt, kind, dense_gt):
    flow, valid = gt[0], gt[1][kind] > 0.5
    grad_gt, _ = _gt_normals(flow)
    rng = np.random.default_rng(4)
    pred = rng.normal(scale=0.5, size=(ITERS, B, h, w, 2)).astype(np.float32)
    wts = JL.loss_weights(ITERS, 0.9)

    def jf(p):
        return JL.disp_grad_loss(p, jnp.asarray(grad_gt), jnp.asarray(valid), wts,
                                 scale=0.25, dense_gt=dense_gt)

    (jl, jm), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(pred))
    tp = _t(pred, True)
    tl, tm = TL.disp_grad_loss(tp, _t(grad_gt), _t(valid), TL.loss_weights(ITERS, 0.9),
                               scale=0.25, dense_gt=dense_gt)
    assert tl.item() == pytest.approx(float(jl), rel=LOSS_RTOL)
    _check_metrics(jm, tm)
    _check_grads([jg], torch.autograd.grad(tl, [tp]))


def test_masked_mean_of_an_empty_mask():
    x = torch.arange(6.0)
    assert float(TL.masked_mean(x, torch.zeros(6))) == 0.0
    assert float(TL.masked_mean(x, x > 3)) == 4.5


def test_max_pool():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 16, 24, 3)).astype(np.float32)
    for args in ((4, 4, 0), (3, 2, 1)):
        np.testing.assert_array_equal(tsampler.max_pool(_t(x), *args).numpy(),
                                      np.asarray(jsampler.max_pool(jnp.asarray(x), *args)))


@pytest.mark.parametrize("k", [2, 4])
def test_median_pool_is_the_lower_median(k):
    rng = np.random.default_rng(6)
    x = np.round(rng.normal(size=(2, 16, 24, 3)) * 2).astype(np.float32)  # with ties
    out = tsampler.median_pool(_t(x), k).numpy()
    np.testing.assert_array_equal(out, np.asarray(jsampler.median_pool(jnp.asarray(x), k)))
    win = np.sort(x[0, :k, :k, 0].ravel())
    assert out[0, 0, 0, 0] == win[(k * k - 1) // 2]


@pytest.mark.parametrize("lead", [(), (3,)])
def test_disp_gradient_and_normal_take_leading_dims(lead):
    rng = np.random.default_rng(7)
    d = np.abs(rng.normal(scale=6.0, size=(*lead, 2, 8, 12, 1))).astype(np.float32)
    for jf, tf in ((jgeo.disp2disp_gradient_xy, tgeo.disp2disp_gradient_xy),
                   (jgeo.disp2disp_normal_xy, tgeo.disp2disp_normal_xy)):
        (jv, jmask), (tv, tmask) = jf(jnp.asarray(d)), tf(_t(d))
        assert tv.shape == jv.shape and tmask.shape == jmask.shape
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
