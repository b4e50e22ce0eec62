"""The port's primitive ops against their tcs_tpu counterparts, in fp32.

Same inputs, made with numpy from a seed, go through the JAX function and the
port's function on the CPU (the plain PyTorch versions of the kernels). The
tolerance is atol 1e-5 unless a test states another.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tcs_tpu import geometry as jgeo
from tcs_tpu.ops import corr as jcorr
from tcs_tpu.ops import sampler as jsam
from tcs_tpu.ops import splat as jsplat
from tcs_tpu.ops.pallas.corr_kernel import lookup_pallas
from tcs_tpu_torch import geometry as tgeo
from tcs_tpu_torch.ops import _kernels
from tcs_tpu_torch.ops import corr as tcorr
from tcs_tpu_torch.ops import sampler as tsam
from tcs_tpu_torch.ops import splat as tsplat

# The test processes share the host: two intra-op threads each, so that
# several workers do not oversubscribe its cores.
torch.set_num_threads(2)

ATOL = 1e-5


def _close(t, j, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=rtol)


def _pair(x):
    return torch.from_numpy(x), jnp.asarray(x)


def test_coords_grid():
    _close(tsam.coords_grid(2, 5, 7), jsam.coords_grid(2, 5, 7))


@pytest.mark.parametrize("out_hw", [(4, 6), (8, 12), (3, 5), (16, 24)])
def test_resize(rng, out_hw):
    t, j = _pair(rng.normal(size=(2, 8, 12, 3)).astype(np.float32))
    _close(tsam.resize_bilinear(t, out_hw), jsam.resize_bilinear(j, out_hw))
    # A pixel-coordinate grid up to ~440 px, as the hidden-state warp resizes
    # it: fp32 rounding there is ~3e-5 per ulp, so the bound is relative.
    grid = np.asarray(jsam.coords_grid(2, 8, 12)) * 40.0 + t.numpy()[..., :2]
    t, j = _pair(grid.astype(np.float32))
    _close(tsam.resize_bilinear(t, out_hw), jsam.resize_bilinear(j, out_hw),
           atol=ATOL, rtol=1e-6)
    _close(tsam.resize_nearest(t, out_hw), jsam.resize_nearest(j, out_hw))


def test_bilinear_sampler(rng):
    t, j = _pair(rng.normal(size=(2, 6, 9, 5)).astype(np.float32))
    ct, cj = _pair(rng.uniform(-2, 11, size=(2, 4, 7, 2)).astype(np.float32))
    _close(tsam.bilinear_sampler(t, ct), jsam.bilinear_sampler(j, cj))


def test_pool2x(rng):
    t, j = _pair(rng.normal(size=(2, 7, 10, 4)).astype(np.float32))
    _close(tsam.pool2x(t), jsam.pool2x(j))


def test_convex_upsample(rng):
    f, fj = _pair(rng.normal(size=(2, 5, 6, 1)).astype(np.float32))
    m, mj = _pair(rng.normal(size=(2, 5, 6, 9 * 16)).astype(np.float32))
    _close(tsam.convex_upsample(f, m, 4), jsam.convex_upsample(fj, mj, 4))


def _cam(rng, B=2):
    K = np.tile(np.array([[[30.0, 0, 11.5], [0, 30.0, 7.5], [0, 0, 1]]],
                         np.float32), (B, 1, 1))
    T1 = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    T2 = T1.copy()
    T2[:, :3, 3] = rng.uniform(-0.1, 0.1, size=(B, 3))
    c, s = np.cos(0.02), np.sin(0.02)
    T2[:, :2, :2] = [[c, -s], [s, c]]
    return K, T1, T2


def test_pose_helpers(rng):
    K, T1, T2 = _cam(rng)
    _close(tgeo.cal_relative_transformation(torch.from_numpy(T1), torch.from_numpy(T2)),
           jgeo.cal_relative_transformation(jnp.asarray(T1), jnp.asarray(T2)))
    _close(tgeo.scale_intrinsics(torch.from_numpy(K), 0.25),
           jgeo.scale_intrinsics(jnp.asarray(K), 0.25))


def test_disp_gradients(rng):
    t, j = _pair(rng.uniform(0, 20, size=(2, 9, 11, 1)).astype(np.float32))
    (tg, tm), (jg, jm) = tgeo.disp2disp_gradient_xy(t), jgeo.disp2disp_gradient_xy(j)
    _close(tg, jg)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tgeo.disp2disp_grad_candidates(t).numpy(),
                               np.asarray(jgeo.disp2disp_grad_candidates(j)),
                               rtol=1e-4, atol=1e-4, equal_nan=True)


def test_backward_grid(rng):
    K, T1, T2 = _cam(rng)
    d = rng.uniform(-1, 12, size=(2, 16, 24, 1)).astype(np.float32)
    args_t = [torch.from_numpy(x) for x in (d, np.linalg.inv(T2) @ T1, K,
                                            np.linalg.inv(K))] + [torch.full((2,), 0.5)]
    args_j = [jnp.asarray(x.numpy()) for x in args_t]
    _close(tgeo.get_backward_grid(*args_t), jgeo.get_backward_grid(*args_j), atol=1e-4)


def test_warp(rng):
    """The full temporal forward splat: disparity, 8 feature channels, mask."""
    K, T1, T2 = _cam(rng)
    d = rng.uniform(2, 12, size=(2, 16, 24, 1)).astype(np.float32)
    d[0, :3] = 0.0  # invalid sources
    fm = rng.normal(size=(2, 16, 24, 8)).astype(np.float32)
    rel = np.linalg.inv(T1) @ T2
    base = [d, fm, rel, K, np.linalg.inv(K)]
    out_t = tgeo.warp(*[torch.from_numpy(x) for x in base], torch.full((2,), 0.5))
    out_j = jgeo.warp(*[jnp.asarray(x) for x in base], jnp.full((2,), 0.5))
    assert float(out_t[2].sum()) > 0
    for a, b in zip(out_t, out_j):
        _close(a, b, atol=1e-4, rtol=1e-5)


def test_cost_volume_and_odd_pyramid(rng):
    f1, j1 = _pair(rng.normal(size=(1, 3, 45, 16)).astype(np.float32))
    f2, j2 = _pair(rng.normal(size=(1, 3, 45, 16)).astype(np.float32))
    cv_t, cv_j = tcorr.build_cost_volume(f1, f2), jcorr.build_cost_volume(j1, j2)
    _close(cv_t, cv_j)
    pt, pj = tcorr.corr_pyramid(cv_t, 4), jcorr.corr_pyramid(cv_j, 4)
    assert [p.shape[-1] for p in pt] == [45, 22, 11, 5]
    for a, b in zip(pt, pj):
        _close(a, b)
    _close(tcorr.masked_cost_volume(cv_t), jcorr.masked_cost_volume(cv_j))


def test_argmax_disp_with_ties(rng):
    cost = rng.uniform(-1, 1, size=(2, 3, 20, 20)).astype(np.float32)
    cost[0, 0, 5, [2, 7]] = 1.5  # tie far apart: first occurrence wins
    cost[0, 1, 9, [3, 4]] = 1.5  # tie inside the suppression band
    cost[1, :, :, 6] = 2.0  # a clear peak column
    cost = np.round(cost * 4) / 4  # many more ties
    t, j = _pair(cost)
    for a, b in zip(tcorr.argmax_disp(tcorr.masked_cost_volume(t)),
                    jcorr.argmax_disp(jcorr.masked_cost_volume(j))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _pyramid(rng, W, C=8, H=4, B=2, levels=4):
    f1 = rng.normal(size=(B, H, W, C)).astype(np.float32)
    f2 = rng.normal(size=(B, H, W, C)).astype(np.float32)
    cv = jcorr.build_cost_volume(jnp.asarray(f1), jnp.asarray(f2))
    return jcorr.corr_pyramid(cv, levels)


@pytest.mark.parametrize("case", ["fractional", "integer", "bf16"])
def test_lookup_plain(rng, case):
    """Cases of tests/test_pallas.py: fractional coords past both ends of the
    row, integer coords, and a bf16 pyramid (held to the bf16-quantised
    fp32 oracle: both lerp in fp32)."""
    W, r = 32, 4
    pyr = _pyramid(rng, W)
    if case == "integer":
        r = 2
        coords = rng.integers(-2, W + 2, size=(2, 4, W)).astype(np.float32)
    else:
        coords = rng.uniform(-6, W + 6, size=(2, 4, W)).astype(np.float32)
    cj = jnp.asarray(coords)
    if case == "bf16":
        pyr_j = tuple(p.astype(jnp.bfloat16) for p in pyr)
        oracle = jcorr.lookup_gather(tuple(p.astype(jnp.float32) for p in pyr_j), cj, r)
        pyr_t = tuple(torch.from_numpy(np.array(p.astype(jnp.float32))).to(torch.bfloat16)
                      for p in pyr_j)
    else:
        pyr_j, oracle = pyr, jcorr.lookup_gather(pyr, cj, r)
        pyr_t = tuple(torch.from_numpy(np.array(p)) for p in pyr)
    out = tcorr.lookup_plain(pyr_t, torch.from_numpy(coords), r)
    # lookup_gather takes each tap's fraction from c + dx, the others from c.
    _close(out, oracle)
    _close(out, lookup_pallas(pyr_j, cj, radius=r, interpret=True), atol=1e-6)


@pytest.mark.parametrize("C", [1, 5])
def test_splat(rng, C):
    """softsplat('soft-clipeps') and the sum splat, with targets out of the
    image and non-finite flow."""
    v = rng.normal(size=(2, 8, 10, C)).astype(np.float32)
    flow = rng.normal(scale=2.0, size=(2, 8, 10, 2)).astype(np.float32)
    flow[0, :, :2, 0] = -20.0
    flow[1, 0, :, 1] = 50.0
    flow[0, 3, 4, 0] = np.nan
    flow[1, 5, 6, 1] = np.inf
    metric = rng.uniform(-3, 3, size=(2, 8, 10, 1)).astype(np.float32)
    valid = (rng.uniform(size=(2, 8, 10, 1)) > 0.2).astype(np.float32)
    _close(tsplat.splat_sum_plain(torch.from_numpy(v), torch.from_numpy(flow)),
           jsplat.splat_sum(jnp.asarray(v), jnp.asarray(flow)))
    out_t = tsplat.softsplat(*[torch.from_numpy(x) for x in (v, flow, metric)],
                             valid_mask=torch.from_numpy(valid))
    out_j = jsplat.softsplat(*[jnp.asarray(x) for x in (v, flow, metric)],
                             mode="soft-clipeps", valid_mask=jnp.asarray(valid))
    for a, b in zip(out_t, out_j):
        _close(a, b, atol=1e-5, rtol=1e-5)


def _splat_case(rng, case, C, B=2, H=12, W=16):
    """values with magnitudes from 1e-4 to 1e4, and a flow of one kind."""
    v = (rng.normal(size=(B, H, W, C)) * 10.0 ** rng.uniform(-4, 4, size=(B, H, W, 1)))
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    noise = rng.uniform(0, 1, size=(B, H, W, 2))
    if case == "collisions":  # eight columns collapse onto one: ~16 taps a cell
        flow = np.stack([-(xs % 8) + 0.25 * noise[..., 0],
                         rng.normal(scale=0.7, size=(B, H, W))], -1)
    elif case == "one_cell":  # every source of an image to one point: buckets of H·W
        flow = np.broadcast_to(np.stack([5.3 - xs, 7.6 - ys], -1), (B, H, W, 2))
    elif case == "integer":  # integer targets: the +1 taps weigh 0
        flow = np.round(rng.normal(scale=2.0, size=(B, H, W, 2)))
    else:  # non-finite flow in image 0, every target out of image 1
        flow = rng.normal(scale=2.0, size=(B, H, W, 2))
        flow[0, :, :3, 0] = -40.0
        flow[0, 3, 4, 0], flow[0, 5, 6, 1], flow[0, 7, 8, 0] = np.nan, np.inf, -np.inf
        flow[1] = [1e3, 0.5]
    return v.astype(np.float32), flow.astype(np.float32)


def _splat_serial(v, flow):
    """Each target cell's sum in (tap, source index) order, one fp32 product
    rounded before each fp32 add: the order the CUDA kernel reproduces."""
    B, H, W, C = v.shape
    out = np.zeros((B * H * W, C), np.float32)
    src, fl = v.reshape(-1, C), flow.reshape(-1, 2)
    one = np.float32(1.0)
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        for s in range(B * H * W):
            b, y, x = s // (H * W), s // W % H, s % W
            tx, ty = np.float32(x) + fl[s, 0], np.float32(y) + fl[s, 1]
            if not (np.isfinite(tx) and np.isfinite(ty)):
                continue
            xi, yi = np.floor(tx) + np.float32(dx), np.floor(ty) + np.float32(dy)
            if 0 <= xi <= W - 1 and 0 <= yi <= H - 1:
                w = (one - abs(tx - xi)) * (one - abs(ty - yi))
                t = b * H * W + int(yi) * W + int(xi)
                out[t] = out[t] + src[s] * w
    return out.reshape(B, H, W, C)


@pytest.mark.parametrize("C", [1, 5, 258])
@pytest.mark.parametrize("case", ["collisions", "one_cell", "integer", "nonfinite_out"])
def test_splat_sum_plain_bit_exact(rng, case, C):
    """``splat_sum_plain`` equals ``tcs_tpu``'s ``splat_sum`` and a serial
    (tap, source)-ordered fp32 sum bit for bit: the order the kernel keeps."""
    v, flow = _splat_case(rng, case, C)
    with np.errstate(invalid="ignore"):
        serial = _splat_serial(v, flow)
    out = tsplat.splat_sum_plain(torch.from_numpy(v), torch.from_numpy(flow))
    ref = np.array(jsplat.splat_sum(jnp.asarray(v), jnp.asarray(flow)))
    assert torch.equal(out, torch.from_numpy(ref))
    assert torch.equal(out, torch.from_numpy(serial))
    if case == "one_cell":
        assert int((out[0, ..., 0] != 0).sum()) == 4  # four buckets of 192 keys
    if case == "nonfinite_out":
        assert not out[1].any()


def test_cpu_wrappers_run_plain_and_count_nothing(rng):
    _kernels.reset_launches()
    pyr = tuple(torch.from_numpy(np.array(p)) for p in _pyramid(rng, 16))
    coords = torch.from_numpy(rng.uniform(0, 16, size=(2, 4, 16)).astype(np.float32))
    assert torch.equal(tcorr.lookup(pyr, coords, 4), tcorr.lookup_plain(pyr, coords, 4))
    v = torch.randn(1, 4, 5, 3, requires_grad=True)
    f = torch.randn(1, 4, 5, 2)
    out = tsplat.splat_sum(v, f)
    assert torch.equal(out, tsplat.splat_sum_plain(v, f))
    out.sum().backward()  # the backward runs its plain version too
    assert _kernels.launches == {"corr_lookup": 0, "corr_lookup_bwd": 0,
                                 "splat_sum": 0, "splat_sum_bwd": 0}
