#!/usr/bin/env python
"""The port's model FLOPs against ``tcs_tpu``'s at full size, difference by
difference (CPU; imports JAX, ``tcs_tpu`` and the port).

At 384×1280, iters 5, one carried frame (the warp), the default config:

1. the port's count (``tcs_tpu_torch/utils/flops.py``, the plain versions
   on the CPU), by group;
2. ``tcs_tpu`` counted from its jaxpr under the same convention
   (``tests/test_torch_flops.py``'s walker) with the batch-stacked trunk and
   the gather lookup (``packed_dual_encoder=False``,
   ``lookup_backend="gather"``), by group, and the convention's taps of its
   gather lookup and scatter splat, which the walker does not see;
3. ``tcs_tpu`` as configured (the packed trunk, the ``onehot_w2major``
   lookup), counted as XLA counts convolutions (a transposed convolution
   over its zero-dilated input, ``avg_pool`` as the depthwise convolution it
   is), and each difference from the port: the packed trunk's zero blocks,
   the second cost volume, the dilated transposed convolutions, the pools,
   the convex upsample's einsum.

Then a SceneFlow step (B1 320×720, 2 frames, 5 iterations; FLOPs are linear
in the batch): the port's count; ``tcs_tpu``'s losses and gradients with
every recompute off and, as configured, with its frame and encoder remat
and the loss tail's (the recompute alone). ``python
scripts/flops_reconciliation.py`` (about a minute and a half on 8 cores).
"""

from __future__ import annotations

import dataclasses
import os
import sys
from collections import defaultdict

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import test_torch_flops as walker  # noqa: E402
from tcs_tpu.config import ModelConfig as JaxConfig  # noqa: E402
from tcs_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from tcs_tpu.models import CameraParams as JaxCam  # noqa: E402
from tcs_tpu.models import TCStereo as JaxTCStereo  # noqa: E402
from tcs_tpu.models import TemporalState as JaxState  # noqa: E402
from tcs_tpu.train.train_step import SequenceBatch as JaxBatch  # noqa: E402
from tcs_tpu.train.train_step import _frame_inline_loss_and_grads  # noqa: E402
from tcs_tpu_torch import ModelConfig  # noqa: E402
from tcs_tpu_torch.config import sceneflow_recipe  # noqa: E402
from tcs_tpu_torch.models import TCStereo  # noqa: E402
from tcs_tpu_torch.utils import flops  # noqa: E402
from tools.convert_torch_ckpt import convert_state_dict  # noqa: E402

H, W, ITERS = 384, 1280, 5
LEVELS, RADIUS, PAYLOAD = 4, 4, 258
G = 1e9


def jax_params():
    sd = {k: v.numpy() for k, v in TCStereo(ModelConfig(), device="cpu").state_dict().items()}
    return jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                                  convert_state_dict(sd))


def frame_counts(params, **knobs) -> dict:
    cfg = JaxConfig(**knobs)
    model = JaxTCStereo(cfg=cfg)
    cam = JaxCam(K=jnp.eye(3)[None], baseline=jnp.ones((1,)))
    image = jax.ShapeDtypeStruct((1, H, W, 3), jnp.float32)
    return walker.walk(walker.live(jax.make_jaxpr(lambda p, a, b, s: model.apply(
        p, a, b, s, cam, jnp.eye(4)[None], iters=ITERS, test_mode=True).flow)(
        params, image, image, JaxState.zeros(1, H, W, cfg))), branch=1)


def by(counts, key) -> dict:
    out = defaultdict(int)
    for (path, kind), n in counts.items():
        out[key(path, kind)] += n
    return dict(out)


def step_counts(params, B, Hs, Ws, frames, iters, **knobs) -> dict:
    tcfg = JaxTrainConfig(model=JaxConfig(packed_dual_encoder=False, lookup_backend="gather"),
                          train_iters=iters, batch_size=B, image_size=(Hs, Ws),
                          frame_length=frames, **knobs)
    model = JaxTCStereo(cfg=tcfg.model)

    def seq(*tail):
        return jax.ShapeDtypeStruct((B, frames, *tail), jnp.float32)

    batch = JaxBatch(image1=seq(Hs, Ws, 3), image2=seq(Hs, Ws, 3), flow=seq(Hs, Ws, 1),
                     valid=seq(Hs, Ws, 1), T=seq(4, 4),
                     K=jax.ShapeDtypeStruct((B, 3, 3), jnp.float32),
                     baseline=jax.ShapeDtypeStruct((B,), jnp.float32))
    jaxpr = walker.live(jax.make_jaxpr(
        lambda p, b: _frame_inline_loss_and_grads(model, tcfg, p, b))(params, batch))
    walks = [walker.walk(jaxpr, branch) for branch in (0, 1)]
    out = defaultdict(int)
    for c in walks:
        for (path, kind), n in c.items():
            if kind != "pool":
                phase = "backward" if "transpose(" in path else "forward"
                out[phase] += n
                if "iter_cell/hiddenstate_update" in walker._bare(path) and phase == "backward":
                    out["hidden update backward"] += n
    return {k: v // 2 for k, v in out.items()}  # the mean of the argmax and the warp frame


def main() -> None:
    params = jax_params()
    h, w = H // 4, W // 4
    lookup = 2 * 2 * h * w * LEVELS * (2 * RADIUS + 1)
    splat = 2 * 4 * h * w * PAYLOAD

    port = flops.inference_flops(ModelConfig(), H, W, ITERS, device="cpu")
    port_groups = defaultdict(int)
    for path, ops in port.own.items():
        for (op, _), n in ops.items():
            port_groups[walker.port_group(path, op)] += n
    function = frame_counts(params, packed_dual_encoder=False, lookup_backend="gather")
    jax_groups = by({k: v for k, v in function.items() if k[1] != "pool"},
                    lambda p, k: walker.jax_group(p))
    jax_groups["gru iteration"] += ITERS * lookup
    jax_groups["warp"] = splat
    print(f"one carried frame, B1 {H}x{W}, iters {ITERS}, default config; GFLOP")
    print(f"{'group':<24} {'port':>12} {'tcs_tpu, by function':>22}")
    for g in sorted(set(port_groups) | set(jax_groups)):
        print(f"{g:<24} {port_groups[g] / G:12.4f} {jax_groups.get(g, 0) / G:22.4f}")
    print(f"{'total':<24} {port.total / G:12.4f} {sum(jax_groups.values()) / G:22.4f}  "
          f"equal to the FLOP: {port.total == sum(jax_groups.values())}")
    print(f"  of the port's: convolutions {port.by_op()['aten.convolution'] / G:.4f}, the cost "
          f"volume and the poses' products {port.by_op()['aten.bmm'] / G:.4f}, the lookups "
          f"{port.by_op()['corr_lookup'] / G:.4f}, the splat {port.by_op()['splat_sum'] / G:.4f}, "
          f"the convex upsample {port.by_op()['convex_upsample'] / G:.4f}")

    configured = frame_counts(params)
    kinds = by(configured, lambda p, k: k)
    fkinds = by(function, lambda p, k: k)
    trunk = {c: sum(n for (p, k), n in counts.items() if k == "conv"
                    and walker.jax_group(p) == "trunk") for c, counts in
             (("configured", configured), ("function", function))}
    upsample = sum(n for (p, k), n in configured.items() if "bhwkyx" in p)
    xla = {"convolutions": kinds["conv"] + 4 * kinds.get("transposed", 0) + kinds["pool"],
           "dot_general": kinds["dot"]}
    print(f"\ntcs_tpu as configured (packed trunk, onehot_w2major lookup), as XLA counts: "
          f"convolutions {xla['convolutions'] / G:.4f} (of which pools {kinds['pool'] / G:.4f}, "
          f"transposed over their dilated input {4 * kinds['transposed'] / G:.4f}), dot_general "
          f"{xla['dot_general'] / G:.4f}; total {sum(xla.values()) / G:.4f}")
    print(f"with the batch-stacked trunk and the gather lookup, as XLA counts: convolutions "
          f"{(fkinds['conv'] + 4 * fkinds['transposed'] + fkinds['pool']) / G:.4f}, dot_general "
          f"{fkinds['dot'] / G:.4f}")
    xla_by_group = defaultdict(int)
    for (path, kind), n in configured.items():
        xla_by_group[walker.jax_group(path)] += 4 * n if kind == "transposed" else n
    print(f"{'group':<24} {'tcs_tpu as configured, as XLA counts':>38}")
    for g in sorted(xla_by_group):
        print(f"{g:<24} {xla_by_group[g] / G:38.4f}")
    rows = [("the packed trunk's zero blocks", trunk["configured"] - trunk["function"]),
            ("the second cost volume (onehot_w2major)", kinds["dot"] - fkinds["dot"]),
            ("the transposed convolutions' dilated input", 3 * kinds["transposed"]),
            ("the pools (avg_pool as depthwise convolutions)", kinds["pool"]),
            ("the lookups' and the splat's taps (not seen by XLA)", -(ITERS * lookup + splat))]
    print("differences, tcs_tpu as XLA counts it less the port:")
    for what, n in rows:
        print(f"  {what:<52} {n / G:+12.4f}")
    print(f"  {'sum':<52} {sum(n for _, n in rows) / G:+12.4f} against "
          f"{(sum(xla.values()) - port.total) / G:+.4f}; the convex upsample's einsum "
          f"{upsample / G:.4f}, counted by both")

    B, (Hs, Ws), frames, iters = 1, sceneflow_recipe().image_size, 2, 5
    cfg = dataclasses.replace(sceneflow_recipe(), batch_size=B)
    step, _ = flops.train_step_flops(cfg, device="cpu")
    off = step_counts(params, B, Hs, Ws, frames, iters, remat_frames=False, encode_remat=False,
                      losses_outside_scan=False, inline_tail_remat=False)
    on = step_counts(params, B, Hs, Ws, frames, iters)
    hs, ws = Hs // 4, Ws // 4  # the lookups forward and backward, the warp's splat
    taps = (frames * iters * 2 * 2 * 2 * B * hs * ws * LEVELS * (2 * RADIUS + 1)
            + (frames - 1) * 2 * 4 * B * hs * ws * PAYLOAD)
    print(f"\nSceneFlow step, B{B} {Hs}x{Ws}, {frames} frames, {iters} iterations; GFLOP")
    print(f"  port: {step.total / G:.4f} (forward {step.phase('forward') / G:.4f}, backward "
          f"{step.phase('backward') / G:.4f})")
    print(f"  tcs_tpu, recompute off, with the convention's taps: "
          f"{(off['forward'] + off['backward'] + taps) / G:.4f} (forward "
          f"{off['forward'] / G:.4f} without taps); its last iterations' hidden-state update "
          f"backward {off['hidden update backward'] / iters / G:.4f}")
    print(f"  tcs_tpu as configured (frame, encoder and loss-tail remat): "
          f"{(on['forward'] + on['backward'] + taps) / G:.4f}; the recompute "
          f"{(on['forward'] + on['backward'] - off['forward'] - off['backward']) / G:.4f}")


if __name__ == "__main__":
    main()
