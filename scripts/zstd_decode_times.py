#!/usr/bin/env python
"""Times the port's zstd decoder beside the ``zstandard`` module, and the
port's reading of a full-width ``tcs_tpu`` training state.

Frames of 16 MiB of float32 noise (what a checkpoint's weights and moments
compress like) and of text at zstd levels 1 and 19 are decoded by
``tcs_tpu_torch.utils.zstd.decompress_into`` and by ``zstandard``; the best
of three runs each, in MB/s of decoded bytes. Then ``tcs_tpu``'s
``CheckpointManager`` writes a ``TrainState`` of the default model (its
16.7M parameters, moments from a seed; OCDBT, zstd level 1, as Orbax writes
it) and ``orbax_format.read_tree`` reads it back: the best of three, in
seconds and MB/s of arrays.

Usage: ``python scripts/zstd_decode_times.py`` (the CPU; it imports JAX,
Orbax and ``zstandard``; two torch threads).
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def best_of(fn, reps: int = 3) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch
    import zstandard

    from tcs_tpu.config import TrainConfig
    from tcs_tpu.train.optim import make_optimizer
    from tcs_tpu.train.train_step import TrainState
    from tcs_tpu.utils.checkpoint import CheckpointManager
    from tcs_tpu_torch import ModelConfig, convert
    from tcs_tpu_torch.models import TCStereo
    from tcs_tpu_torch.utils import orbax_format, zstd

    torch.set_num_threads(2)
    rng = np.random.default_rng(0)
    payloads = {"float32 noise": rng.standard_normal(1 << 22).astype(np.float32).tobytes(),
                "text": bytes(rng.integers(97, 107, 1 << 24, dtype=np.uint8))}
    for name, data in payloads.items():
        out = np.empty(len(data), np.uint8)
        for level in (1, 19):
            frame = zstandard.ZstdCompressor(level=level).compress(data)
            port = best_of(lambda: zstd.decompress_into(frame, out))
            lib = best_of(lambda: zstandard.ZstdDecompressor().decompress(frame))
            if out.tobytes() != data:
                sys.exit(f"{name} at level {level} does not decode to its payload")
            print(f"{name}, level {level}: the port {len(data) / port / 1e6:.1f} MB/s, "
                  f"zstandard {len(data) / lib / 1e6:.1f} MB/s")

    params = jax.tree_util.tree_map(jnp.asarray, convert.params_from_state_dict(
        TCStereo(ModelConfig(), device="cpu", seed=0).state_dict()))
    tx = make_optimizer(TrainConfig())
    abstract = jax.eval_shape(tx.init, params)
    adam = abstract[1][0]
    draw = lambda x: jnp.asarray(rng.standard_normal(x.shape, np.float32) * 1e-3)  # noqa: E731
    count = jnp.asarray(37, jnp.int32)
    opt = (abstract[0], (adam._replace(count=count, mu=jax.tree_util.tree_map(draw, adam.mu),
                                       nu=jax.tree_util.tree_map(draw, adam.nu)),
                         abstract[1][1], abstract[1][2]._replace(count=count)))
    state = TrainState(step=37, apply_fn=None, params=params, tx=tx, opt_state=opt)
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(os.path.join(tmp, "run"))
        mgr.save(37, state, wait=True)
        mgr.close()
        step = os.path.join(tmp, "run", "37")
        tree = orbax_format.read_tree(step)
        nbytes = sum(t.numel() * t.element_size() for _, t in orbax_format.flatten(tree)
                     if t is not None)
        disk = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(step) for f in fs)
        secs = best_of(lambda: orbax_format.read_tree(step))
        print(f"read_tree of a full-width TrainState ({nbytes / 1e6:.1f} MB of arrays, "
              f"{disk / 1e6:.1f} MB on disk): {secs:.3f} s, {nbytes / secs / 1e6:.1f} MB/s")


if __name__ == "__main__":
    main()
