#!/usr/bin/env python
"""Where the bf16 config's frame 0 parts from ``tcs_tpu``'s, stage by stage.

On ``tcs_tpu``'s trained weights (``tests/fixtures/convergence_params.npz``)
and one clip of ``tests/test_torch_trained.py``'s protocol (64×96, frame 0,
the argmax bootstrap), both packages run the bf16 default config and the
fp32 config (``mixed_precision=False, corr_dtype='float32'``) in test mode,
and this prints:

1. each stage's output, each package on its own chain, as |Δ| max and mean
   beside the fp32 config's at the same point: the encoders (the context
   encoder's net and inp at three scales, the shared trunk, the matching
   features), the cost volume and its pyramid, the argmax initialisation,
   the context projections, the disparity completion and the hidden-state
   fusion; for a bf16 tensor also the share of its entries that differ and
   their mean distance in bf16 ulps (of the larger of the two values);
2. each stage alone: the port's module on ``tcs_tpu``'s input (its
   batch-stacked trunk's values), against ``tcs_tpu``'s output, as the
   share of entries that differ and their mean bf16 ulps; a convolution's
   one-ulp differences here are the rounding of an fp32 sum taken in
   another order;
3. the port's flow after 1 and 5 iterations with ``tcs_tpu``'s outputs put
   in place of its own, stage after stage, downstream from the encoders
   (forward hooks that return ``tcs_tpu``'s values): how much of the frame's
   |Δflow| each stage's own rounding brings;
4. ``tcs_tpu`` against itself: its packed two-image trunk (the test mode
   default, ``packed_dual_encoder=True``) against its batch-stacked trunk
   (the training path's), one function summed in two orders;
5. the port's mean |Δflow| of frame 0 at 1, 2, 4 and 8 intra-op threads;
6. what XLA compiles of ``tcs_tpu``'s instance norm after a bf16
   convolution (the matching head's and the completion's blocks): its
   result against the norm of the convolution rounded to bf16, as the
   source says, and of the convolution's fp32 result.

Usage: ``python scripts/parity_bf16_frame0.py [--clip N]`` (the CPU;
it imports JAX and ``tcs_tpu``; about 2 minutes).
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from tcs_tpu.config import ModelConfig as JaxConfig  # noqa: E402
from tcs_tpu.data.synthetic import SyntheticStereoSequence  # noqa: E402
from tcs_tpu.models import CameraParams as JaxCam  # noqa: E402
from tcs_tpu.models import TCStereo as JaxTCStereo  # noqa: E402
from tcs_tpu.models import TemporalState as JaxState  # noqa: E402
from tcs_tpu.models.layers import instance_norm  # noqa: E402
from tcs_tpu.ops import corr as jcorr  # noqa: E402
from tcs_tpu.utils.checkpoint import load_params_npz as jax_load_params_npz  # noqa: E402
from tcs_tpu_torch import ModelConfig  # noqa: E402
from tcs_tpu_torch.models import CameraParams, TCStereo, TemporalState  # noqa: E402
from tcs_tpu_torch.ops import corr as tcorr  # noqa: E402
from tcs_tpu_torch.utils.checkpoint import load_params_npz  # noqa: E402

FIXTURE = os.path.join(ROOT, "tests", "fixtures", "convergence_params.npz")
H, W, CLIPS = 64, 96, 4
CONFIGS = {"bf16": {}, "fp32": dict(mixed_precision=False, corr_dtype="float32")}
THREADS = 2  # as the tests run the port
# Module outputs captured in tcs_tpu (Flax scope paths) and their port twins.
CAPTURED = ["cnet", "conv2", "disp_completor", "cnet/conv1"] + [
    f"cnet/layer{i}" for i in range(1, 6)] + [
    f"{name}_{i}" for name in ("context_zqr_convs", "context_zqr_convs_grad", "hidden_fuse")
    for i in range(3)]
# Section 3's cascade: the stages whose outputs are put in, cumulatively.
CASCADE = [("own chain", []),
           ("+ encoders (cnet, conv2)", ["cnet", "conv2"]),
           ("+ context projections", [f"context_zqr_convs{g}_{i}" for g in ("", "_grad")
                                      for i in range(3)]),
           ("+ disparity completion", ["disp_completor"]),
           ("+ hidden-state fusion", [f"hidden_fuse_{i}" for i in range(3)])]


def clip(ci: int) -> dict:
    ds = SyntheticStereoSequence(n_samples=CLIPS, frame_length=2, height=H, width=W,
                                 layered_frac=1.0)
    return ds.load_sample(ci, np.random.default_rng(10_000 + ci))


def jax_params():
    jcfg = JaxConfig(**CONFIGS["fp32"])
    img = jnp.zeros((1, H, W, 3))
    cam = JaxCam(K=jnp.eye(3)[None], baseline=jnp.ones((1,)))
    target = jax.eval_shape(
        lambda key: JaxTCStereo(cfg=jcfg).init(key, img, img, JaxState.zeros(1, H, W, jcfg),
                                               cam, jnp.eye(4)[None], iters=1,
                                               test_mode=False),
        jax.random.PRNGKey(0))
    return jax_load_params_npz(FIXTURE, target)


def jax_frame0(params, s, name, iters, packed=True):
    """tcs_tpu's flow (H, W) and its captured module outputs."""
    jcfg = JaxConfig(**CONFIGS[name], packed_dual_encoder=packed)
    model = JaxTCStereo(cfg=jcfg)
    wanted = {tuple(p.split("/")) for p in CAPTURED}
    run = jax.jit(lambda p, a, b, st, cam, T: model.apply(
        p, a, b, st, cam, T, iters=iters, test_mode=True, mutable=["intermediates"],
        capture_intermediates=lambda mdl, _: tuple(mdl.scope.path) in wanted))
    cam = JaxCam(K=jnp.asarray(s["K"])[None], baseline=jnp.asarray([float(s["baseline"])]))
    out, inter = run(params, jnp.asarray(s["image1"][0])[None], jnp.asarray(s["image2"][0])[None],
                     JaxState.zeros(1, H, W, jcfg), cam, jnp.asarray(s["T"][0])[None])
    cap = {}
    for path in CAPTURED:
        node = inter["intermediates"]
        for part in path.split("/"):
            node = node.get(part, {})
        if "__call__" in node:
            cap[path] = node["__call__"][0]
    return np.asarray(out.flow)[0, ..., 0], cap


def port_modules(model) -> dict:
    mods = {"cnet": model.cnet, "conv2": model.conv2, "cnet/conv1": model.cnet.conv1,
            "disp_completor": model.disp_completor}
    for i in range(3):
        mods[f"context_zqr_convs_{i}"] = model.context_zqr_convs[i]
        mods[f"context_zqr_convs_grad_{i}"] = model.context_zqr_convs_grad[i]
        mods[f"hidden_fuse_{i}"] = model.previous_current_hideen_fuse[i]
    return mods


def to_port(path, value):
    """A captured tcs_tpu output in the port's layout and dtype."""
    def t(x):
        a = torch.from_numpy(np.asarray(x.astype(jnp.float32)))
        a = a.to(torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32)
        return a.permute(0, 3, 1, 2) if a.shape[-1] > 1 else a
    if path == "cnet":
        heads, trunk = value
        return tuple(tuple(t(a) for a in pair) for pair in heads), t(trunk)
    if path == "disp_completor":
        *maps, nets = value
        return (*(torch.from_numpy(np.asarray(m)) for m in maps), tuple(t(n) for n in nets))
    return t(value)


def port_frame0(model, s, name, iters, put=(), cap=None):
    """The port's flow (H, W) and its module outputs; the outputs of the
    modules in ``put`` are replaced by tcs_tpu's (``cap``)."""
    mods, seen, hooks = port_modules(model), {}, []

    def hook(path):
        def fn(_, __, out):
            seen[path] = out
            return to_port(path, cap[path]) if path in put else None
        return fn

    for path, mod in mods.items():
        hooks.append(mod.register_forward_hook(hook(path)))
    cfg = ModelConfig(**CONFIGS[name])

    def tensor(a):
        return torch.from_numpy(np.asarray(a, np.float32))[None]

    try:
        out = model(tensor(s["image1"][0]), tensor(s["image2"][0]),
                    TemporalState.zeros(1, H, W, cfg, device="cpu"),
                    CameraParams(K=tensor(s["K"]), baseline=torch.tensor([float(s["baseline"])])),
                    tensor(s["T"][0]), iters=iters)
    finally:
        for h in hooks:
            h.remove()
    return out.flow.numpy()[0, ..., 0], seen


def stages_jax(cap, cfg) -> dict:
    heads, trunk = cap["cnet"]
    st = {f"cnet {kind}{i}": heads[i][k] for i in range(3) for k, kind in enumerate(("net", "inp"))}
    st["trunk"] = trunk
    fmap = cap["conv2"].astype(jnp.float32)
    st["fmap1"], st["fmap2"] = fmap[:1], fmap[1:]
    cv = jcorr.build_cost_volume(fmap[:1], fmap[1:])
    st["cost volume"] = cv
    for i, lvl in enumerate(jcorr.corr_pyramid(cv, cfg.corr_levels)):
        st[f"pyramid level {i}"] = lvl.astype(jnp.dtype(cfg.corr_dtype))
    st["argmax disp"], st["argmax cost"], st["argmax mask"] = jcorr.argmax_disp(
        jcorr.masked_cost_volume(cv), margin=cfg.argmax_margin,
        suppress_radius=cfg.argmax_suppress_radius)
    for i in range(3):
        st[f"context_zqr_convs_{i}"] = cap[f"context_zqr_convs_{i}"]
        st[f"context_zqr_convs_grad_{i}"] = cap[f"context_zqr_convs_grad_{i}"]
    st["disp_init"], st["disp_mono"], st["w_fuse"], nets = cap["disp_completor"]
    for i in range(3):
        st[f"completion net{i}"] = nets[i]
        st[f"hidden_fuse_{i}"] = cap[f"hidden_fuse_{i}"]
    return {k: (np.asarray(v.astype(jnp.float32)), v.dtype == jnp.bfloat16)
            for k, v in st.items()}


def stages_port(seen, cfg) -> dict:
    def h(x):
        return x.permute(0, 2, 3, 1) if x.ndim == 4 and x.shape[-1] != 1 else x

    heads, trunk = seen["cnet"]
    st = {f"cnet {kind}{i}": h(heads[i][k]) for i in range(3)
          for k, kind in enumerate(("net", "inp"))}
    st["trunk"] = h(trunk)
    fmap = h(seen["conv2"]).float()
    st["fmap1"], st["fmap2"] = fmap[:1], fmap[1:]
    cv = tcorr.build_cost_volume(fmap[:1].contiguous(), fmap[1:].contiguous())
    st["cost volume"] = cv
    for i, lvl in enumerate(tcorr.corr_pyramid(cv, cfg.corr_levels)):
        st[f"pyramid level {i}"] = lvl.to(getattr(torch, cfg.corr_dtype))
    st["argmax disp"], st["argmax cost"], st["argmax mask"] = tcorr.argmax_disp(
        tcorr.masked_cost_volume(cv), margin=cfg.argmax_margin,
        suppress_radius=cfg.argmax_suppress_radius)
    for i in range(3):
        st[f"context_zqr_convs_{i}"] = h(seen[f"context_zqr_convs_{i}"])
        st[f"context_zqr_convs_grad_{i}"] = h(seen[f"context_zqr_convs_grad_{i}"])
    st["disp_init"], st["disp_mono"], st["w_fuse"], nets = seen["disp_completor"]
    for i in range(3):
        st[f"completion net{i}"] = h(nets[i])
        st[f"hidden_fuse_{i}"] = h(seen[f"hidden_fuse_{i}"])
    return {k: v.detach().float().numpy() for k, v in st.items()}


@torch.no_grad()
def stages_alone(model, params, s):
    """(stage, the port's output on tcs_tpu's input, tcs_tpu's output), bf16
    config, tcs_tpu's batch-stacked trunk, as float32 NHWC arrays."""
    _, cap = jax_frame0(params, s, "bf16", 1, packed=False)
    jcfg = JaxConfig(**CONFIGS["bf16"])

    def t(x):  # tcs_tpu's value, NCHW
        return to_port("", x)

    def a(x):  # NHWC float32 array
        x = x.permute(0, 2, 3, 1) if x.ndim == 4 and x.shape[-1] != 1 else x
        return x.float().numpy()

    def j(x):
        return np.asarray(x.astype(jnp.float32))

    img = np.concatenate([s["image1"][:1], s["image2"][:1]], 0).astype(np.float32)
    x = torch.from_numpy(2.0 * (img / 255.0) - 1.0).permute(0, 3, 1, 2).to(torch.bfloat16)
    enc, heads, trunk = model.cnet, cap["cnet"][0], cap["cnet"][1]
    out = [("cnet.conv1", a(enc.conv1(x)), j(cap["cnet/conv1"]))]
    prev = torch.relu(t(cap["cnet/conv1"]))
    for i in range(1, 6):
        if i == 4:
            prev = prev[:1]
        mine = getattr(enc, f"layer{i}")(prev)
        out.append((f"cnet.layer{i}", a(mine), j(cap[f"cnet/layer{i}"])))
        prev = t(cap[f"cnet/layer{i}"])
    ins = (t(trunk)[:1], t(cap["cnet/layer4"]), t(cap["cnet/layer5"]))
    for s_, (name, hs) in enumerate((("outputs08", enc.outputs08),
                                     ("outputs16", enc.outputs16),
                                     ("outputs32", enc.outputs32))):
        for k in range(2):
            out.append((f"cnet.{name}[{k}]", a(hs[k](ins[s_])), j(heads[s_][k])))
    out.append(("conv2 (matching head)", a(model.conv2(t(trunk))), j(cap["conv2"])))
    for i in range(3):
        inp = torch.relu(t(heads[i][1]))
        out.append((f"context_zqr_convs[{i}]", a(model.context_zqr_convs[i](inp)),
                    j(cap[f"context_zqr_convs_{i}"])))
        out.append((f"context_zqr_convs_grad[{i}]", a(model.context_zqr_convs_grad[i](inp)),
                    j(cap[f"context_zqr_convs_grad_{i}"])))
    fmap = cap["conv2"].astype(jnp.float32)
    sd, c, mk = jcorr.argmax_disp(jcorr.masked_cost_volume(
        jcorr.build_cost_volume(fmap[:1], fmap[1:])), margin=jcfg.argmax_margin,
        suppress_radius=jcfg.argmax_suppress_radius)
    args = [torch.from_numpy(j(v)) for v in (sd, c, mk)]
    di, dm, w, nets = model.disp_completor(*args, [t(heads[i][0]) for i in range(3)])
    jd = cap["disp_completor"]
    for label, mine, want in (("disp_completor: disp_init", di, jd[0]),
                              ("disp_completor: disp_mono", dm, jd[1]),
                              ("disp_completor: w_fuse", w, jd[2])):
        out.append((label, a(mine), j(want)))
    for i in range(3):
        out.append((f"disp_completor: net{i}", a(nets[i]), j(jd[3][i])))
        net = torch.tanh(t(jd[3][i]))
        out.append((f"hidden fuse {i}", a(model.previous_current_hideen_fuse[i](
            net, torch.zeros_like(net, dtype=torch.float32))), j(cap[f"hidden_fuse_{i}"])))
    return out


def bf16_ulps(a, b):
    """Share of entries that differ, and their mean distance in bf16 ulps of
    the larger magnitude."""
    d = np.abs(a - b)
    m = np.maximum(np.abs(a), np.abs(b))
    nz = (d > 0) & (m > 0)
    if not nz.any():
        return 0.0, 0.0
    ulp = np.exp2(np.floor(np.log2(m[nz])) - 7)
    return float(nz.mean()), float((d[nz] / ulp).mean())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clip", type=int, default=2)
    args = ap.parse_args()
    torch.set_num_threads(THREADS)
    s, params = clip(args.clip), jax_params()
    ports = {"fp32": load_params_npz(TCStereo(ModelConfig(**CONFIGS["fp32"]), device="cpu"),
                                     FIXTURE)}
    ports["bf16"] = TCStereo(ModelConfig(**CONFIGS["bf16"]), device="cpu")
    ports["bf16"].load_state_dict(ports["fp32"].state_dict())
    print(f"clip {args.clip}, frame 0, 64x96, tcs_tpu's trained weights; torch "
          f"{torch.__version__}, {THREADS} threads, jax {jax.__version__}, CPU")

    rows, runs = {}, {}
    for name in CONFIGS:
        jflow, cap = jax_frame0(params, s, name, 5)
        tflow, seen = port_frame0(ports[name], s, name, 5)
        runs[name] = (jflow, cap, tflow)
        cfg = ModelConfig(**CONFIGS[name])
        a, b = stages_jax(cap, cfg), stages_port(seen, cfg)
        for k, (ja, is_bf16) in a.items():
            pa = b[k].reshape(ja.shape)
            d = np.abs(ja - pa)
            rows.setdefault(k, {})[name] = (float(d.max()), float(d.mean()),
                                            bf16_ulps(ja, pa) if is_bf16 else None)
        d = np.abs(jflow - tflow)
        rows.setdefault("flow, 5 iterations", {})[name] = (float(d.max()), float(d.mean()), None)

    print("\n1. each package on its own chain: |d| max / mean (bf16: share of entries that "
          "differ, mean bf16 ulps of those) | fp32 config |d| max / mean")
    for k, r in rows.items():
        (bm, ba, bu), (fm, fa, _) = r["bf16"], r["fp32"]
        ulps = f" ({bu[0]:.3f} differ, {bu[1]:.2f} ulps)" if bu else ""
        print(f"  {k:26s} bf16 {bm:.3e} / {ba:.3e}{ulps} | fp32 {fm:.3e} / {fa:.3e}")

    print("\n2. each stage alone, bf16: the port's module on tcs_tpu's input (its "
          "batch-stacked trunk), against tcs_tpu's output: share of entries that differ, "
          "mean bf16 ulps of those, max |d| of max |ref|")
    for label, got, want in stages_alone(ports["bf16"], params, s):
        share, ulps = bf16_ulps(want, got)
        print(f"  {label:34s} {share:.5f} differ, {ulps:.2f} ulps; max |d| "
              f"{np.abs(got - want).max():.3e} of {np.abs(want).max():.3e}")

    print("\n3. the port with tcs_tpu's outputs put in, stage after stage: mean / max |dflow| px")
    for name in CONFIGS:
        for iters in (1, 5):
            jflow, cap = (runs[name][0], runs[name][1]) if iters == 5 else \
                jax_frame0(params, s, name, iters)
            put = []
            for label, more in CASCADE:
                put += more
                d = np.abs(port_frame0(ports[name], s, name, iters, put, cap)[0] - jflow)
                print(f"  {name} iters {iters} {label:27s} {d.mean():.3e} / {d.max():.3e}")

    print("\n4. tcs_tpu against itself, bf16, 5 iterations: mean / max |dflow| px")
    jpacked, tflow = runs["bf16"][0], runs["bf16"][2]
    jstacked = jax_frame0(params, s, "bf16", 5, packed=False)[0]
    for label, a, b in (("packed trunk against stacked trunk", jpacked, jstacked),
                        ("port against tcs_tpu's packed trunk", tflow, jpacked),
                        ("port against tcs_tpu's stacked trunk", tflow, jstacked)):
        d = np.abs(a - b)
        print(f"  {label:38s} {d.mean():.3e} / {d.max():.3e}")

    print("\n5. the port's threads, bf16, 5 iterations, against tcs_tpu: mean / max |dflow| px")
    for n in (1, 2, 4, 8):
        torch.set_num_threads(n)
        d = np.abs(port_frame0(ports["bf16"], s, "bf16", 5)[0] - jpacked)
        print(f"  {n} threads {d.mean():.3e} / {d.max():.3e}")
    torch.set_num_threads(THREADS)

    print("\n6. tcs_tpu's instance_norm(conv(x, w)), bf16 x and w, jitted: share of "
          "entries that differ from")
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(1, 16, 24, 64)), jnp.bfloat16)
    w = jnp.asarray(rng.normal(size=(3, 3, 64, 64)) * 0.05, jnp.bfloat16)
    got = np.asarray(jax.jit(lambda x, w: instance_norm(jax.lax.conv_general_dilated(
        x, w, (1, 1), ((1, 1), (1, 1)), dimension_numbers=("NHWC", "HWIO", "NHWC"))))(
        x, w).astype(jnp.float32))
    y = torch.nn.functional.conv2d(
        torch.from_numpy(np.array(x.astype(jnp.float32))).permute(0, 3, 1, 2),
        torch.from_numpy(np.array(w.astype(jnp.float32))).permute(3, 2, 0, 1), padding=1)
    for label, v in (("the norm of the convolution rounded to bf16", y.bfloat16().float()),
                     ("the norm of the convolution's fp32 result", y)):
        mean, var = v.mean(dim=(2, 3), keepdim=True), v.var(dim=(2, 3), keepdim=True,
                                                           unbiased=False)
        ref = ((v - mean) * torch.rsqrt(var + 1e-5)).bfloat16().float().permute(0, 2, 3, 1)
        print(f"  {label:46s} {np.mean(ref.numpy() != got):.4f}")


if __name__ == "__main__":
    main()
