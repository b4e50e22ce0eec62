#!/usr/bin/env python
"""Writes the Orbax fixtures of ``tests/fixtures/orbax/`` and their digests.

With ``tcs_tpu``'s own Orbax functions (``tcs_tpu/utils/checkpoint.py``) on
eight virtual CPU devices:

- ``manager/``: a ``CheckpointManager`` directory holding step 37 of a
  ``TrainState`` whose optimiser state is ``make_optimizer``'s chain (clip,
  AdamW, schedule), both counts 37, moments drawn from a seed, over a small
  tree with a bfloat16 leaf, an int32 leaf and a 2-D float32 array sharded
  over four devices (written as four chunks); beside it an uncommitted step
  (``38.orbax-checkpoint-tmp-0``) that a reader must skip;
- ``export/``: ``save_params`` of the same params;
- ``zstd/``: frames of ``zstandard`` at levels 1, 19 and 22, with and
  without checksum, of a payload of float32 noise and repeated text;
- ``digests.json``: for each array of ``manager`` and ``export``, under its
  path's parts joined with ``/``, its dtype, shape and the SHA-256 of its
  bytes as ``tcs_tpu`` restores it; for
  each frame, the size and SHA-256 of its payload.

``tests/test_torch_orbax.py`` holds the port's reader to the digests on the
CPU, ``chip_smoke.py`` phase 13 (a) on the card's host.

Usage: ``python scripts/make_orbax_fixtures.py`` (the CPU; it imports JAX,
Orbax and ``zstandard``).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "fixtures", "orbax")
COUNT = 37


def _name(path) -> str:
    """A leaf's path as its parts joined with '/' ('opt_state/1/0/count'),
    the keys the port's reader gives."""
    parts = []
    for k in path:
        parts.append(str(getattr(k, "name", getattr(k, "key", getattr(k, "idx", k)))))
    return "/".join(parts)


def _digest(a) -> dict:
    import numpy as np

    a = np.asarray(a)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def main() -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import zstandard
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from tcs_tpu.config import TrainConfig
    from tcs_tpu.train.optim import make_optimizer
    from tcs_tpu.train.train_step import TrainState
    from tcs_tpu.utils.checkpoint import CheckpointManager, load_params, save_params

    rng = np.random.default_rng(0)
    mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
    sharded = jax.device_put(jnp.asarray(rng.standard_normal((64, 24), np.float32)),
                             NamedSharding(mesh, PartitionSpec("x", None)))
    params = {"params": {
        "enc": {"Conv_0": {"kernel": jnp.asarray(rng.standard_normal((3, 3, 8, 16), np.float32)),
                           "bias": jnp.asarray(rng.standard_normal(16, np.float32))}},
        "head": {"kernel": sharded},
        "emb": jnp.asarray(rng.standard_normal((10, 12), np.float32), jnp.bfloat16),
        "table": jnp.asarray(rng.integers(-1000, 1000, 7), jnp.int32)}}
    tx = make_optimizer(TrainConfig())
    ts = TrainState.create(apply_fn=None, params=params, tx=tx)
    adam = ts.opt_state[1][0]

    def seeded(scale, positive):
        def draw(x):
            v = rng.random(x.shape) if positive else rng.standard_normal(x.shape)
            return jnp.asarray((v * scale).astype(np.float32), x.dtype)
        return draw

    count = jnp.asarray(COUNT, jnp.int32)
    opt_state = (ts.opt_state[0], (
        adam._replace(count=count, mu=jax.tree_util.tree_map(seeded(1e-2, False), adam.mu),
                      nu=jax.tree_util.tree_map(seeded(1e-4, True), adam.nu)),
        ts.opt_state[1][1], ts.opt_state[1][2]._replace(count=count)))
    ts = ts.replace(step=COUNT, opt_state=opt_state)

    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    mgr = CheckpointManager(os.path.join(OUT, "manager"))
    mgr.save(COUNT, ts, wait=True)
    mgr.close()
    shutil.copytree(os.path.join(OUT, "manager", str(COUNT)),
                    os.path.join(OUT, "manager", f"{COUNT + 1}.orbax-checkpoint-tmp-0"))
    save_params(os.path.join(OUT, "export"), params)

    restored = CheckpointManager(os.path.join(OUT, "manager")).restore(ts)
    exported = load_params(os.path.join(OUT, "export"), params)
    digests = {"manager": {}, "export": {}, "zstd": {}}
    for path, leaf in jax.tree_util.tree_leaves_with_path(restored):
        digests["manager"][_name(path)] = _digest(leaf)
    for path, leaf in jax.tree_util.tree_leaves_with_path(exported):
        digests["export"][_name(path)] = _digest(leaf)

    payload = (rng.standard_normal(30_000).astype(np.float32).tobytes()
               + b"params.params.cnet.conv1.Conv_0.kernel/0.0.0.0 " * 600)
    os.makedirs(os.path.join(OUT, "zstd"))
    for level in (1, 19, 22):
        for checksum in (False, True):
            name = f"level{level}{'_checksum' if checksum else ''}.zst"
            frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(payload)
            with open(os.path.join(OUT, "zstd", name), "wb") as f:
                f.write(frame)
            digests["zstd"][name] = {"size": len(payload),
                                     "sha256": hashlib.sha256(payload).hexdigest()}
    with open(os.path.join(OUT, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
    total = sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(OUT) for n in ns)
    print(f"wrote {OUT}: {total} bytes")


if __name__ == "__main__":
    main()
