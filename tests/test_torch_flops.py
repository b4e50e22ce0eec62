"""The port's model FLOPs (``tcs_tpu_torch/utils/flops.py``) against
``tcs_tpu``'s, at 64×96, the fp32 config.

``tcs_tpu`` is counted here from its jaxpr (``jax.make_jaxpr``: nothing is
compiled) under the port's convention: ``conv_general_dilated`` and
``dot_general`` at 2 × their multiply-adds, a convolution with a dilated
input over its real elements (XLA's form of a transposed convolution), the
depthwise convolutions with a constant kernel that are ``tcs_tpu``'s
``avg_pool`` left out, ``cond`` taken on one branch, ``scan`` times its
length. It is configured to count the function once: the batch-stacked
trunk (``packed_dual_encoder=False``) and the gather lookup, which builds
one cost volume. Its lookup and splat are a gather and a scatter, which
the walker does not see; the convention's taps are added for them.
"""

import functools
import json
import os
import re
import subprocess
import sys
from collections import defaultdict

import flax.linen as nn
import jax
import jax.interpreters.partial_eval as pe
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcs_tpu.config import ModelConfig as JaxConfig
from tcs_tpu.config import TrainConfig as JaxTrainConfig
from tcs_tpu.models import CameraParams as JaxCam
from tcs_tpu.models import TCStereo as JaxTCStereo
from tcs_tpu.models import TemporalState as JaxState
from tcs_tpu.models.tc_stereo import _extract_features
from tcs_tpu.train.train_step import SequenceBatch as JaxBatch
from tcs_tpu.train.train_step import _frame_inline_loss_and_grads
from tcs_tpu_torch import ModelConfig
from tcs_tpu_torch.models import TCStereo
from tcs_tpu_torch.ops import corr, sampler, splat
from tcs_tpu_torch.utils import flops
from tools.convert_torch_ckpt import convert_state_dict

# The test processes share the host: two intra-op threads each, so that
# several workers do not oversubscribe its cores.
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, W, ITERS, FRAMES = 1, 64, 96, 2, 2
h, w = H // 4, W // 4
LEVELS, RADIUS, PAYLOAD = 4, 4, 258  # the warp splats disparity, 256 features and a weight
KW = dict(mixed_precision=False, corr_dtype="float32")
JAX_KW = dict(KW, packed_dual_encoder=False, lookup_backend="gather")
STEP_RTOL = 1e-2
# The convention's taps of one frame's hand entries (2 FLOPs a tap).
LOOKUP_FLOPS = 2 * 2 * B * h * w * LEVELS * (2 * RADIUS + 1)  # one iteration's lookup
SPLAT_FLOPS = 2 * 4 * B * h * w * PAYLOAD
TRUNK = {"conv1", "layer1", "layer2", "layer3"}
SCALING = {"torch_bench_scaling": ("--frames", "2", "--per-rank-batch", "1"),
           "torch_bench_eval_scaling": ()}


# --- the jaxpr walker --------------------------------------------------------

def _conv_flops(eqn) -> int:
    dn = eqn.params["dimension_numbers"]
    rhs, out = eqn.invars[1].aval.shape, eqn.outvars[0].aval.shape
    macs = int(np.prod(out)) * int(np.prod([rhs[i] for i in dn.rhs_spec[2:]])) \
        * rhs[dn.rhs_spec[1]]
    return 2 * macs // int(np.prod(eqn.params["lhs_dilation"]))


def _dot_flops(eqn) -> int:
    (contracting, _), _ = eqn.params["dimension_numbers"]
    lhs, out = eqn.invars[0].aval.shape, eqn.outvars[0].aval.shape
    return 2 * int(np.prod(out)) * int(np.prod([lhs[i] for i in contracting]))


def _sub(jaxpr):
    return getattr(jaxpr, "jaxpr", jaxpr)


def live(closed) -> "jax.core.Jaxpr":
    """The program of ``jax.make_jaxpr``'s result without the equations
    whose results nothing reads, which XLA removes: ``tcs_tpu``'s packed
    convolutions read their weights through a call on a 1-pixel input."""
    return pe.dce_jaxpr(closed.jaxpr, [True] * len(closed.jaxpr.outvars))[0]


def walk(jaxpr, branch: int, prefix: str = "", mult: int = 1, counts=None) -> dict:
    """{(name path, kind): FLOPs}, kind "conv", "transposed" (a dilated
    input), "dot" or "pool". ``cond`` runs ``branches[branch]`` (0: the
    first frame's argmax, 1: the warp). The inverses in
    ``custom_linear_solve`` (``jnp.linalg.inv``; the port's
    ``torch.linalg.inv`` is not counted either) and a scatter's combiner
    are not entered; any other primitive that holds a program fails."""
    counts = defaultdict(int) if counts is None else counts
    for eqn in jaxpr.eqns:
        name, p = eqn.primitive.name, eqn.params
        path = "/".join(x for x in (prefix, str(eqn.source_info.name_stack)) if x)
        if name == "conv_general_dilated":
            kind = ("pool" if p["feature_group_count"] > 1 or p["batch_group_count"] > 1
                    else "transposed" if max(p["lhs_dilation"]) > 1 else "conv")
            counts[path, kind] += mult * _conv_flops(eqn)
        elif name == "dot_general":
            counts[path, "dot"] += mult * _dot_flops(eqn)
        elif name == "cond":
            walk(_sub(p["branches"][branch]), branch, path, mult, counts)
        elif name == "scan":
            walk(_sub(p["jaxpr"]), branch, path, mult * p["length"], counts)
        elif name in ("pjit", "jit", "checkpoint", "remat", "remat2", "custom_jvp_call",
                      "custom_vjp_call", "custom_vjp_call_jaxpr", "closed_call"):
            walk(_sub(p.get("jaxpr", p.get("call_jaxpr", p.get("fun_jaxpr")))), branch, path,
                 mult, counts)
        elif name not in ("custom_linear_solve", "scatter-add") and any(
                hasattr(_sub(v), "eqns") for v in p.values()):
            # A while loop's trip count, say, is not in the jaxpr.
            raise AssertionError(f"{name} at {path} holds a program the walker cannot count")
    return counts


def _bare(path: str) -> str:
    """The module path with autodiff's ``jvp(…)`` / ``transpose(…)`` taken off."""
    return re.sub(r"(jvp|transpose)\(|\)", "", path)


def jax_group(path: str) -> str:
    parts = _bare(path).split("/")
    top = parts[1] if len(parts) > 1 else ""
    if top == "cnet":
        return "trunk" if parts[2] in TRUNK else "heads"
    if top == "conv2" or top.startswith("context_zqr_convs"):
        return "heads"
    if top == "disp_completor" or top.startswith("hidden_fuse"):
        return "init"
    if top == "iter_cell":
        return "gru iteration"
    if top in ("upsample_mask_head", "bhwkyx,bhwkd->bhwyxd"):
        return "upsample"
    if top in ("", "bhwc,bhvc->bhwv", "bhvc,bhwc->bhvw"):  # the latter: onehot_w2major's
        return "cost volume and poses"
    raise KeyError(path)


def port_group(path: str, op: str) -> str:
    if op == "convex_upsample":
        return "upsample"
    if op == "corr_lookup":
        return "gru iteration"
    if op == "splat_sum":
        return "warp"
    parts = path.split(".")
    top = parts[1] if len(parts) > 1 else ""
    if top == "cnet":
        return "trunk" if parts[2] in TRUNK else "heads"
    if top == "conv2" or top.startswith("context_zqr_convs"):
        return "heads"
    if top in ("disp_completor", "previous_current_hideen_fuse"):
        return "init"
    if top == "disp_refine" and parts[2] == "mask":
        return "upsample"
    if top in ("update_block", "disp_grad_refine", "disp_refine", "hiddenstate_update"):
        return "gru iteration"
    if top == "":
        return "cost volume and poses"
    raise KeyError(path)


def _by_group(counts, group) -> dict:
    out = defaultdict(int)
    for (path, kind), n in counts.items():
        if kind != "pool":
            out[group(path)] += n
    return dict(out)


# --- shared inputs -----------------------------------------------------------

def _started(script, *args, env=None, cwd=ROOT):
    return subprocess.Popen([sys.executable, os.path.join(ROOT, "scripts", script), *args],
                            cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finished(proc, timeout=300) -> str:
    out, _ = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, out
    return out


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    """The processes that run beside the tests' JAX traces, started first:
    the port's counts of the fp32 model at 64×96 through
    ``scripts/torch_flops.py`` on the CPU (one carried frame; one step of a
    2-frame window, batch 1), one process each, and (f)'s runs of the two
    scaling scripts at 2 Gloo ranks on the CPU."""
    out = tmp_path_factory.mktemp("scaling")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = {mode: _started("torch_flops.py", "--mode", mode, "--fp32", "--device", "cpu",
                            "--threads", "1", "--size", str(H), str(W), "--iters", str(ITERS),
                            "--frames", str(FRAMES), "--batch", str(B))
             for mode in ("train", "inference")}
    procs.update({name: _started(name + ".py", "--cpu", "--world", "2", "--size", "32", "64",
                                 "--iters", "1", "--steps", "1", "--warmup", "1",
                                 "--store", str(out), *extra, env=env, cwd=out)
                  for name, extra in SCALING.items()})
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def port(runs):
    """``port(mode)`` waits for the port's count of ``mode`` ("inference" or
    "train") and returns it: a test calls it after its JAX trace."""

    def read(mode: str) -> dict:
        return json.loads(_finished(runs[mode]).splitlines()[-1])[mode]

    return functools.lru_cache(read)


@pytest.fixture(scope="module")
def jax_params():
    """Parameter shapes of ``tcs_tpu``'s model, from the port's state dict."""
    sd = {k: v.numpy() for k, v in TCStereo(ModelConfig(**KW), device="cpu").state_dict().items()}
    return jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                                  convert_state_dict(sd))


def _image(*lead):
    return jax.ShapeDtypeStruct((*lead, H, W, 3), jnp.float32)


def _port_groups(record) -> dict:
    got = defaultdict(int)
    for path, ops in record["by_module_forward"].items():
        for op, n in ops.items():
            got[port_group(path, op)] += n
    return dict(got)


# --- (c) the training step (first: its JAX trace is the longest) ----------------

def jax_step_counts(params) -> dict:
    """``tcs_tpu``'s count of one step of a 2-frame window at 2 iterations:
    its step's losses and gradients (its optimiser and clip count nothing)
    with every recompute off. Its frame scan takes the argmax on frame 0 and
    the warp on frame 1, so the count is the mean of the walker's two branch
    choices. Returns the forward, the total (both with the convention's taps
    of the lookups and the splat) and the backward of the hidden-state
    updates of one iteration a frame."""
    cfg = JaxConfig(**JAX_KW)
    tcfg = JaxTrainConfig(model=cfg, train_iters=ITERS, batch_size=B, image_size=(H, W),
                          frame_length=FRAMES, remat_frames=False, encode_remat=False,
                          losses_outside_scan=False, inline_tail_remat=False)
    model = JaxTCStereo(cfg=cfg)

    def seq(*tail):
        return jax.ShapeDtypeStruct((B, FRAMES, *tail), jnp.float32)

    batch = JaxBatch(image1=seq(H, W, 3), image2=seq(H, W, 3), flow=seq(H, W, 1),
                     valid=seq(H, W, 1), T=seq(4, 4),
                     K=jax.ShapeDtypeStruct((B, 3, 3), jnp.float32),
                     baseline=jax.ShapeDtypeStruct((B,), jnp.float32))
    jaxpr = live(jax.make_jaxpr(lambda p, b: _frame_inline_loss_and_grads(model, tcfg, p, b))(
        params, batch))
    walks = [walk(jaxpr, branch) for branch in (0, 1)]

    def count(keep):
        return sum(n for c in walks for (path, kind), n in c.items()
                   if kind != "pool" and keep(path)) // 2

    lookups = FRAMES * ITERS * LOOKUP_FLOPS
    return dict(forward=count(lambda p: "transpose(" not in p) + lookups
                + (FRAMES - 1) * SPLAT_FLOPS,
                total=count(lambda p: True) + 2 * lookups + (FRAMES - 1) * SPLAT_FLOPS,
                hidden_update_backward=count(lambda p: "transpose(" in p and
                                             "iter_cell/hiddenstate_update" in _bare(p))
                // ITERS)


def test_train_step_count_is_tcs_tpus(jax_params, port):
    """The forward is held exactly; the whole step within 1 %, its one
    residual named: ``tcs_tpu``'s iteration scan transposes its body alike
    on every iteration, so the last iteration's hidden-state update, whose
    output only the carried state (stop-gradient) reads, gets a backward
    there and none in the port."""
    want = jax_step_counts(jax_params)
    got = port("train")
    residual = want["hidden_update_backward"]
    assert got["forward"] == want["forward"]
    assert got["total"] == want["total"] - residual
    assert 0 < residual <= STEP_RTOL * want["total"]
    assert got["by_op"]["backward"]["corr_lookup"] == FRAMES * ITERS * LOOKUP_FLOPS


# --- (a) inference ------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_inference(jax_params):
    """The walker's count of one carried frame of ``tcs_tpu`` (the warp)."""
    cfg = JaxConfig(**JAX_KW)
    model = JaxTCStereo(cfg=cfg)
    cam = JaxCam(K=jnp.eye(3)[None], baseline=jnp.ones((1,)))
    return walk(live(jax.make_jaxpr(lambda p, a, b, s: model.apply(
        p, a, b, s, cam, jnp.eye(4)[None], iters=ITERS, test_mode=True).flow)(
        jax_params, _image(B), _image(B), JaxState.zeros(B, H, W, cfg))), branch=1)


def test_inference_count_is_tcs_tpus_group_by_group(jax_inference, port):
    want = _by_group(jax_inference, jax_group)
    want["gru iteration"] += ITERS * LOOKUP_FLOPS
    want["warp"] = SPLAT_FLOPS
    got = port("inference")
    assert _port_groups(got) == want
    assert got["total"] == sum(want.values())
    assert got["backward"] == 0


# --- (b) the packed trunk -------------------------------------------------------

class _Features(nn.Module):
    cfg: JaxConfig
    packed: bool

    @nn.compact
    def __call__(self, img1, img2):
        return _extract_features(self.cfg, jnp.float32, img1, img2, packed=self.packed,
                                 remat_encoder=False)


def test_packed_trunk_counts_the_stacked_trunk_and_its_zero_blocks(jax_params, jax_inference,
                                                                    port):
    """The packed encoder's trunk (``packed_dual_encoder``, ``tcs_tpu``'s
    test-mode default) against the batch-stacked one of the inference count."""
    params = {"params": {k: jax_params["params"][k] for k in ("cnet", "conv2")}}
    enc = _Features(JaxConfig(**KW), packed=True)
    packed = walk(live(jax.make_jaxpr(enc.apply)(params, _image(B), _image(B))), 1)
    # A packed convolution calls the kernel itself, not its module.
    trunk = {path.removeprefix("_Features/"): n for (path, kind), n in packed.items()
             if kind == "conv" and jax_group(path) == "trunk"}
    stacked = {path.removeprefix("TCStereo/").removesuffix("/Conv_0"): n
               for (path, kind), n in jax_inference.items()
               if kind == "conv" and jax_group(path) == "trunk"}
    heads = {path.removeprefix("_Features/"): n for (path, kind), n in packed.items()
             if kind == "conv" and jax_group(path) != "trunk"}
    assert heads == {path.removeprefix("TCStereo/"): n for (path, kind), n in jax_inference.items()
                     if path.split("/")[1:2] in (["cnet"], ["conv2"])
                     and jax_group(path) != "trunk"}
    # Each packed convolution holds both images' blocks on its diagonal and
    # zeros off it: as many multiply-adds again as the two blocks.
    assert sorted(trunk) == sorted(stacked)
    for path, n in stacked.items():
        assert trunk[path] == 2 * n, path
    assert _port_groups(port("inference"))["trunk"] == sum(stacked.values())


# --- (d) the hand entries -----------------------------------------------------------

def test_hand_entries_count_the_conventions_taps():
    g = torch.Generator().manual_seed(0)
    f1, f2 = torch.randn(2, 1, 6, 40, 16, generator=g)
    pyramid = [p.requires_grad_() for p in corr.corr_pyramid(
        corr.build_cost_volume(f1, f2), LEVELS)]
    coords = torch.rand(1, 6, 40, generator=g) * 40
    values = torch.randn(1, 6, 40, 5, generator=g, requires_grad=True)
    flow = torch.randn(1, 6, 40, 2, generator=g, requires_grad=True)
    field = torch.randn(1, 1, 6, 40, generator=g, requires_grad=True)
    logits = torch.randn(1, 9 * 16, 6, 40, generator=g)
    with flops.FlopCounter() as counter:
        out = (corr.lookup(pyramid, coords, RADIUS).sum() + splat.splat_sum(values, flow).sum()
               + sampler.convex_upsample_nchw(field, logits, 4).sum())
        forward = counter.by_op()
        out.backward()
    taps = {"corr_lookup": 2 * 240 * LEVELS * (2 * RADIUS + 1), "splat_sum": 4 * 240 * 5,
            "convex_upsample": 9 * 16 * 240}
    assert forward == {op: 2 * n for op, n in taps.items()}
    # Backward: the pyramid; the values and the flow; the field (not the logits).
    assert counter.by_op("backward") == {"corr_lookup": 2 * taps["corr_lookup"],
                                         "splat_sum": 4 * taps["splat_sum"],
                                         "convex_upsample": 2 * taps["convex_upsample"]}
    with flops.FlopCounter() as counter:  # no gradient taken: the forward's taps alone
        with torch.no_grad():
            corr.lookup(pyramid, coords, RADIUS)
    assert counter.total == 2 * taps["corr_lookup"]


def test_nothing_inside_a_hand_entry_is_counted():
    a = torch.randn(8, 8)

    @flops.counted("entry", lambda x: 5, lambda x: (x,))
    def entry(x):
        return x @ x

    with flops.FlopCounter() as counter:
        entry(a)
        a @ a
    assert counter.by_op() == {"entry": 10, "aten.mm": 2 * 8 ** 3}


# --- (e) the peak table ----------------------------------------------------------------

def test_peak_table_refuses_an_unknown_card_by_name():
    with pytest.raises(flops.UnknownCard, match="Tesla V100"):
        flops.peak("Tesla V100-SXM2-16GB, 300.00 W")
    card = flops.peak("NVIDIA H100 80GB HBM3, 700.00 W")
    assert (card.bf16, card.hbm_bytes_per_s) == (989e12, 3.35e12)
    assert flops.hbm_bytes_per_s("NVIDIA H100 PCIe") == 2.0e12


# --- (f) the scaling scripts ---------------------------------------------------------

@pytest.mark.parametrize("name", SCALING)
def test_scaling_script_over_gloo_ranks(runs, name):
    out = _finished(runs[name])
    rows = [line.split("|")[1:-1] for line in out.splitlines() if line.startswith("| ")]
    assert rows[0][0].strip() == "world" and [r[0].strip() for r in rows[1:]] == ["2"], out
    assert float(rows[1][2]) > 0 and rows[1][3].strip() == "100.0%", out

