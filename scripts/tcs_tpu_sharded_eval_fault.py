#!/usr/bin/env python
"""Shows a fault of ``tcs_tpu`` that the PyTorch port does not copy: under
``context_norm="batch"`` its sharded evaluation differs from its serial one.

``tcs_tpu/evaluate.py:196-224`` stacks the streams of a chunk into one batch
over the mesh (and pads a short chunk with its last sequence), and its
``BatchNorm`` takes its statistics over that batch, so the streams' and the
padding's features mix, against the promise at ``:235-237`` that the metrics
are the serial path's. The port streams one sequence per rank
(``tcs_tpu_torch/evaluate.py``; ``tests/test_torch_ddp.py`` holds its sharded
result to its serial one bit for bit).

Runs ``tcs_tpu``'s ``validate_tartanair`` on the CPU, serially and over a
2-device mesh, on a tree of 2 held-out sequences x 2 frames at 64x96 that it
writes from a seed (random images, depth and a forward motion), iters 1,
fp32, weights drawn from a seed; prints both and exits 1 if they agree (the
fault is not shown), 0 if they differ. It imports only ``tcs_tpu``.

    python scripts/tcs_tpu_sharded_eval_fault.py
"""

import os
import sys
import tempfile

import numpy as np
from PIL import Image

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2").strip()
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from tcs_tpu.config import ModelConfig  # noqa: E402
from tcs_tpu.evaluate import validate_tartanair  # noqa: E402
from tcs_tpu.models import CameraParams, TCStereo, TemporalState  # noqa: E402
from tcs_tpu.parallel import mesh as mesh_lib  # noqa: E402

SEQUENCES = (("gascola", "Easy", "P001"), ("hospital", "Hard", "P042"))  # held out


def write_tree(root: str, frames: int, height: int, width: int, seed: int) -> None:
    """TartanAir's layout for ``SEQUENCES``: left and right PNGs, left depth
    (.npy) and NED poses moving forward."""
    rng = np.random.default_rng(seed)
    for scene, difficulty, part in SEQUENCES:
        base = os.path.join(root, "TartanAir", scene, scene, difficulty, part)
        for d in ("image_left", "image_right", "depth_left"):
            os.makedirs(os.path.join(base, d))
        for i in range(frames):
            for side in ("left", "right"):
                img = rng.integers(0, 255, size=(height, width, 3)).astype(np.uint8)
                Image.fromarray(img).save(os.path.join(base, f"image_{side}",
                                                       f"{i:06d}_{side}.png"))
            np.save(os.path.join(base, "depth_left", f"{i:06d}_left_depth.npy"),
                    rng.uniform(2, 30, size=(height, width)).astype(np.float32))
        with open(os.path.join(base, "pose_left.txt"), "w") as f:
            f.writelines(f"{0.1 * i} 0 0 0 0 0 1\n" for i in range(frames))


def main() -> int:
    H, W = 64, 96
    cfg = ModelConfig(mixed_precision=False, corr_dtype="float32", context_norm="batch",
                      packed_dual_encoder=False)
    model = TCStereo(cfg=cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), jnp.zeros((1, H, W, 3)),
                        TemporalState.zeros(1, H, W, cfg),
                        CameraParams(K=jnp.eye(3)[None], baseline=jnp.ones((1,))),
                        jnp.eye(4)[None], iters=1, test_mode=True)
    with tempfile.TemporaryDirectory() as root:
        write_tree(root, frames=2, height=H, width=W, seed=5)
        kw = dict(iters=1, root=root, max_sequences=2)
        serial = validate_tartanair(model, params, cfg, **kw)
        sharded = validate_tartanair(model, params, cfg,
                                     mesh=mesh_lib.create_mesh(jax.devices()[:2]), **kw)
    for k in serial:
        print(f"{k}: serial {serial[k]:.6f}, 2-device mesh {sharded[k]:.6f}, "
              f"|d| {abs(serial[k] - sharded[k]):.3e}")
    shown = any(abs(serial[k] - sharded[k]) > 1e-4 for k in serial)
    print("the mesh path differs from the serial path" if shown
          else "the two paths agree: the fault is not shown")
    return 0 if shown else 1


if __name__ == "__main__":
    sys.exit(main())
