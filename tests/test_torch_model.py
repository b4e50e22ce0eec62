"""The port's TCStereo and TemporalEvaluator against tcs_tpu, in fp32.

The port is built once from a torch seed; ``convert_state_dict`` turns its
weights into tcs_tpu params, and a second port instance, the one compared,
loads them back through ``state_dict_from_jax``. No test calls
``TCStereo.init``: the structure check uses ``jax.eval_shape``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tcs_tpu.config import ModelConfig as JaxConfig
from tcs_tpu.evaluate import TemporalEvaluator as JaxEvaluator
from tcs_tpu.models import CameraParams as JaxCam
from tcs_tpu.models import TCStereo as JaxTCStereo
from tcs_tpu.models import TemporalState as JaxState
from tcs_tpu_torch import ModelConfig
from tcs_tpu_torch.convert import state_dict_from_jax
from tcs_tpu_torch.evaluate import TemporalEvaluator
from tcs_tpu_torch.models import CameraParams, TCStereo, TemporalState
from tools.convert_torch_ckpt import convert_state_dict

# The test processes share the host: two intra-op threads each, so that
# several workers do not oversubscribe its cores.
torch.set_num_threads(2)

B, H, W, ITERS = 1, 64, 96, 2
FLOW_TOL = 5e-2  # px: the bound tests/test_parity.py holds tcs_tpu to against the reference
STATE_TOL = 1e-3  # hidden states (tanh range) and matching features
CFG = ModelConfig(mixed_precision=False, corr_dtype="float32")
JCFG = JaxConfig(mixed_precision=False, corr_dtype="float32")


def _sd_numpy(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _pose(k):
    T = np.eye(4, dtype=np.float32)
    T[0, 3], T[2, 3] = 0.02 * k, 0.05 * k
    return T


@pytest.fixture(scope="module")
def models():
    seeded = TCStereo(CFG, device="cpu", seed=5)
    jparams = jax.tree_util.tree_map(jnp.asarray, convert_state_dict(_sd_numpy(seeded)))
    port = TCStereo(CFG, device="cpu", seed=6)
    port.load_state_dict(state_dict_from_jax(jparams), strict=True)
    return seeded, port, jparams


@pytest.fixture(scope="module")
def two_frames(models):
    """Frame 0 (argmax bootstrap) and frame 1 (warp path, pose with a
    translation) through both models."""
    _, port, jparams = models
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 255, size=(2, 2, B, H, W, 3)).astype(np.float32)
    K = np.array([[[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]]], np.float32)
    jm = JaxTCStereo(cfg=JCFG)
    step = jax.jit(lambda p, a, b, s, c, T: jm.apply(p, a, b, s, c, T, iters=ITERS,
                                                      test_mode=True))
    js, ts = JaxState.zeros(B, H, W, JCFG), TemporalState.zeros(B, H, W, CFG, device="cpu")
    jc = JaxCam(K=jnp.asarray(K), baseline=jnp.full((B,), 0.5))
    tc = CameraParams(K=torch.from_numpy(K), baseline=torch.full((B,), 0.5))
    outs = []
    for k in range(2):
        T = _pose(k)[None]
        jo = step(jparams, jnp.asarray(imgs[k, 0]), jnp.asarray(imgs[k, 1]), js, jc,
                  jnp.asarray(T))
        to = port(torch.from_numpy(imgs[k, 0]), torch.from_numpy(imgs[k, 1]), ts, tc,
                  torch.from_numpy(T), iters=ITERS)
        js, ts = jo.new_state, to.new_state
        outs.append((jo, to))
    return outs


def test_param_count(models):
    assert sum(p.numel() for p in models[0].parameters()) == 16_735_005


def test_converted_tree_matches_init(models):
    _, _, jparams = models
    img = jnp.zeros((B, H, W, 3))
    cam = JaxCam(K=jnp.eye(3)[None], baseline=jnp.ones((B,)))
    shapes = jax.eval_shape(
        lambda key: JaxTCStereo(cfg=JCFG).init(key, img, img, JaxState.zeros(B, H, W, JCFG),
                                               cam, jnp.eye(4)[None], iters=1,
                                               test_mode=False),
        jax.random.PRNGKey(0))

    def paths(tree):
        return {jax.tree_util.keystr(k): tuple(v.shape)
                for k, v in jax.tree_util.tree_leaves_with_path(tree)}

    assert paths(shapes) == paths(jparams)


def test_weight_round_trip_is_bit_exact(models):
    seeded, port, jparams = models
    back = convert_state_dict({k: v.numpy() for k, v in state_dict_from_jax(jparams).items()})
    a = jax.tree_util.tree_leaves_with_path(back)
    b = jax.tree_util.tree_leaves_with_path(jparams)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (_, x), (_, y) in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for k, v in seeded.state_dict().items():
        assert torch.equal(v, port.state_dict()[k]), k


@pytest.mark.parametrize("frame", [0, 1])
def test_frame_parity(two_frames, frame):
    jo, to = two_frames[frame]
    assert to.new_state.valid
    assert to.flow.shape == (B, H, W, 1) and float(to.flow.max()) <= 0.0
    for name, a, b, tol in (
            ("flow", jo.flow, to.flow, FLOW_TOL),
            ("disp_q", jo.new_state.disp_q, to.new_state.disp_q, FLOW_TOL),
            ("fmap1", jo.new_state.fmap1, to.new_state.fmap1, STATE_TOL),
            *((f"net{i}", x, y, STATE_TOL) for i, (x, y) in
              enumerate(zip(jo.new_state.net_list, to.new_state.net_list)))):
        err = np.abs(np.asarray(a) - b.numpy()).max()
        assert err <= tol, (name, err)


def test_temporal_evaluator_parity(models):
    """Three frames at 60×90 (padded to 64×96) through both evaluators."""
    _, port, jparams = models
    h, w = 60, 90
    rng = np.random.default_rng(3)
    K = np.array([[100.0, 0, w / 2], [0, 100.0, h / 2], [0, 0, 1]], np.float32)
    jev = JaxEvaluator(JaxTCStereo(cfg=JCFG), jparams, JCFG, iters=ITERS)
    tev = TemporalEvaluator(port, CFG, iters=ITERS, device="cpu")
    for k in range(3):
        left, right = rng.uniform(0, 255, size=(2, h, w, 3)).astype(np.float32)
        dj = jev(left, right, K, 0.5, _pose(k))
        dt = tev(left, right, K, 0.5, _pose(k))
        assert dt.shape == (h, w) and dt.min() >= 0.0
        assert np.abs(dj - dt).max() <= FLOW_TOL, k
