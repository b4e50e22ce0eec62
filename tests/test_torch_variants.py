"""The architecture variants of the port against tcs_tpu, in fp32, test mode.

Three configurations touch every variant once: the group and instance
context norms with the non-shared backbone (``fnet``) and the slow-fast GRU
schedule, and the batch context norm on the shared backbone. The port is
built from a torch seed, its norm parameters drawn away from ones and zeros,
and :func:`convert_state_dict` below gives the tcs_tpu parameters (the
tools converter leaves out the norm parameters of the group and batch
context encoders). With batch
norm on the shared backbone, tcs_tpu computes the batch-stacked trunk only
with ``packed_dual_encoder=False`` (its packed trunk asserts on per-sample
norms, ROADMAP Queue 3); that is the function the port computes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcs_tpu.config import ModelConfig as JaxConfig
from tcs_tpu.models import CameraParams as JaxCam
from tcs_tpu.models import TCStereo as JaxTCStereo
from tcs_tpu.models import TemporalState as JaxState
from tcs_tpu.models.layers import BatchNorm as JaxBatchNorm
from tcs_tpu_torch import ModelConfig
from tcs_tpu_torch.convert import module_map, norm_map, state_dict_from_jax
from tcs_tpu_torch.models import CameraParams, TCStereo, TemporalState
from tcs_tpu_torch.models.extractor import MultiBasicEncoder
from tcs_tpu_torch.models.layers import BatchNorm

# The test processes share the host: two intra-op threads each, so that
# several workers do not oversubscribe its cores.
torch.set_num_threads(2)

B, H, W, ITERS = 1, 64, 96, 2
FLOW_TOL = 5e-2  # px: the bound tests/test_parity.py holds tcs_tpu to against the reference
VARIANTS = {
    "group-fnet-slowfast": dict(context_norm="group", shared_backbone=False,
                                slow_fast_gru=True),
    "batch-shared": dict(context_norm="batch"),
    "instance-fnet-slowfast": dict(context_norm="instance", shared_backbone=False,
                                   slow_fast_gru=True),
}


# The Flax modules under a ``Norm`` that hold its parameters, by ``norm_fn``
# (``tcs_tpu/models/layers.py:52-118``).
_NORM_SCOPES = {"group": ("GroupNorm_0", "GroupNorm_0"), "batch": ("BatchNorm_0",)}


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def convert_state_dict(sd, context_norm="none"):
    """The port's (reference-named) state dict → ``{"params": tree}`` of
    float32 numpy arrays in ``tcs_tpu``'s layout, the inverse of
    ``state_dict_from_jax`` over the same module and norm maps.
    ``context_norm`` names the Flax scopes of the context encoder's norm
    parameters. Raises if an entry of ``sd`` has no place in the tree."""
    sd = {k: v.detach().numpy().astype(np.float32) for k, v in sd.items()}
    deconvs = {f"{m}.{blk}.conv1.conv" for m in ("disp_completor", "disp_grad_refine")
               for blk in ("conv_16_8", "conv_8_4")}
    tree, used = {}, set()
    for tprefix, jpath in module_map():
        if tprefix + ".weight" not in sd:
            continue
        layer = "ConvTranspose_0" if tprefix in deconvs else "Conv_0"
        _set(tree, jpath + (layer, "kernel"), sd[tprefix + ".weight"].transpose(2, 3, 1, 0))
        used.add(tprefix + ".weight")
        if tprefix + ".bias" in sd:
            _set(tree, jpath + (layer, "bias"), sd[tprefix + ".bias"])
            used.add(tprefix + ".bias")
    for tprefixes, jpath in norm_map():
        if tprefixes[0] + ".weight" not in sd:
            continue
        scope = jpath + _NORM_SCOPES[context_norm]
        _set(tree, scope + ("scale",), sd[tprefixes[0] + ".weight"])
        _set(tree, scope + ("bias",), sd[tprefixes[0] + ".bias"])
        used.update(t + s for t in tprefixes for s in (".weight", ".bias"))
    unused = sorted(set(sd) - used)
    if unused:
        raise KeyError(f"state dict entries with no place in tcs_tpu's tree: {unused[:5]}")
    return {"params": tree}


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
    tree = convert_state_dict(port.state_dict(), cfg.context_norm)
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
        jnp.asarray, convert_state_dict(port.state_dict(), cfg.context_norm))
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
