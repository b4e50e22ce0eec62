"""``tcs_tpu``'s Orbax checkpoints in the port, against ``tcs_tpu``'s Orbax,
tensorstore and ``zstandard`` on the CPU.

- The zstd decoder (``csrc/zstd.c``) equals ``zstandard`` at levels 1, 3,
  9, 19 and 22, on payloads of 0, 1, 127, 131,073 and 1 MiB bytes of float32
  and bfloat16 noise, zeros and repeated text, with and without checksum and
  content size; on concatenated and skippable frames; and on the chunks
  tensorstore writes. Truncated, bit-flipped and bad-checksum frames raise
  ``CorruptZstd`` wherever ``zstandard`` rejects them.
- The OCDBT reader lists every key of a full-width ``tcs_tpu`` step and
  reads every value as tensorstore does, and so on a store that tensorstore
  wrote with small nodes, whose b-tree has interior nodes.
- The full-width ``TrainState`` (the port's model's params, moments from a
  seed, ``make_optimizer``'s chain) read into model, AdamW and schedule
  equals ``tcs_tpu``'s restore bit for bit; so do a ``save_params`` export,
  a bfloat16 leaf and an array sharded over the eight virtual CPU devices
  (several chunks), and the committed fixtures' digests.
- ``tcs_tpu``'s ``load_params``, ``CheckpointManager.restore`` and
  ``restore_params_only`` read the port's ``save_params`` and
  ``save_tcs_tpu`` bit for bit.
- One AdamW update from a restored state, inside the warm-up and after it,
  agrees with ``tx.update`` + ``optax.apply_updates`` to 1e-6 of the
  update's largest entry.
- The trainer resumes a directory that holds only a ``tcs_tpu`` run at its
  step, moments and learning rate; ``restore_ckpt`` and ``cli/evaluate.py
  --restore_ckpt`` take ``tcs_tpu``'s directories.

No JAX model is compiled: the trees come from the port's model through
``convert.params_from_state_dict``.
"""

import copy
import hashlib
import json
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import tensorstore as ts
import torch
import zstandard
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from tcs_tpu.config import TrainConfig as JaxTrainConfig
from tcs_tpu.train.optim import make_optimizer as jax_make_optimizer
from tcs_tpu.train.optim import onecycle_linear_schedule
from tcs_tpu.train.train_step import TrainState
from tcs_tpu.utils import checkpoint as jax_ckpt
from tcs_tpu_torch import convert
from tcs_tpu_torch.cli import evaluate as cli
from tcs_tpu_torch.config import ModelConfig, TrainConfig
from tcs_tpu_torch.data import fabricate, kitti_raw_pose
from tcs_tpu_torch.models import TCStereo
from tcs_tpu_torch.train import optim
from tcs_tpu_torch.train.trainer import Trainer
from tcs_tpu_torch.utils import checkpoint as ck
from tcs_tpu_torch.utils import ocdbt, orbax_format, zstd

# The test processes share the host: two intra-op threads each, so that
# several workers do not oversubscribe its cores.
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures" / "orbax"
MCFG = ModelConfig(mixed_precision=False, corr_dtype="float32")
WARM, AFTER = 37, 2500  # AdamW counts inside and after the warm-up (2,001 steps)
UPDATE_TOL = 1e-6  # of the update's largest entry


# ------------------------------------------------------------------- zstd

def _payloads(n: int):
    rng = np.random.default_rng(n)
    return {"f32": rng.standard_normal(n // 4 + 1).astype(np.float32).tobytes()[:n],
            "bf16": rng.standard_normal(n // 2 + 1).astype(ml_dtypes.bfloat16).tobytes()[:n],
            "zeros": bytes(n),
            "text": (b"params.params.cnet.layer1.res1.conv1.Conv_0.kernel/0.0.0.0 "
                     * (n // 60 + 1))[:n]}


@pytest.mark.parametrize("level", [1, 3, 9, 19, 22])
def test_zstd_equals_zstandard(level):
    """Every size, kind and flag; at 1 MiB (whose compression at levels 19
    and 22 takes most of the time) two of the four flag pairs."""
    for n in (0, 1, 127, 131_073, 1 << 20):
        for kind, data in _payloads(n).items():
            for checksum in (False, True):
                for content_size in ((checksum,) if n > 131_073 else (False, True)):
                    frame = zstandard.ZstdCompressor(
                        level=level, write_checksum=checksum,
                        write_content_size=content_size).compress(data)
                    assert zstd.decompress(frame, len(data)) == data, (n, kind, checksum,
                                                                      content_size)
                    assert zstd.content_size(frame) == (len(data) if content_size else None)


def test_zstd_concatenated_and_skippable_frames():
    a, b = _payloads(5000)["text"], _payloads(70_000)["f32"]
    fa = zstandard.ZstdCompressor(level=19, write_checksum=True).compress(a)
    fb = zstandard.ZstdCompressor(level=3).compress(b)
    skip = b"\x5a\x2a\x4d\x18" + (5).to_bytes(4, "little") + b"hello"
    assert zstd.decompress(fa + skip + fb + skip, len(a) + len(b)) == a + b
    with pytest.raises(zstd.CorruptZstd, match="capacity"):
        zstd.decompress(fa + fb, len(a) + len(b) - 1)
    with pytest.raises(zstd.CorruptZstd, match="no zstd frame"):
        zstd.decompress(skip, 10)


def _reference(data: bytes, cap: int):
    """``zstandard``'s reading of every frame of ``data``, or None where it
    rejects it."""
    got = b""
    try:
        while True:
            frame = zstandard.ZstdDecompressor().decompressobj()
            got += frame.decompress(data)
            if not frame.eof:
                return None
            data = frame.unused_data
            if not data:
                return got if len(got) <= cap else None
    except zstandard.ZstdError:
        return None


def test_zstd_corrupt_frames_raise():
    rng = np.random.default_rng(0)
    data = _payloads(40_000)["bf16"] + _payloads(20_000)["text"]
    frames = [zstandard.ZstdCompressor(level=lvl, write_checksum=True).compress(data)
              for lvl in (1, 19)]
    for frame in frames:
        for cut in range(0, len(frame), max(1, len(frame) // 300)):
            with pytest.raises(zstd.CorruptZstd):
                zstd.decompress(frame[:cut], len(data))
        bad = bytearray(frame)
        bad[-1] ^= 0x10
        with pytest.raises(zstd.CorruptZstd, match="checksum"):
            zstd.decompress(bytes(bad), len(data))
        for _ in range(300):
            flipped = bytearray(frame)
            i = int(rng.integers(0, len(frame)))
            flipped[i] ^= 1 << int(rng.integers(0, 8))
            ref = _reference(bytes(flipped), len(data))
            try:
                got = zstd.decompress(bytes(flipped), len(data))
            except zstd.CorruptZstd:
                continue
            assert ref is not None and got == ref == data, i


def test_zstd_refuses_a_dictionary_by_name():
    """A frame header that names dictionary 7 (a one-byte ID after the
    window descriptor)."""
    frame = zstandard.ZstdCompressor(write_content_size=False).compress(b"params " * 20)
    assert frame[4] == 0  # no flags: the window descriptor follows
    named = frame[:4] + b"\x01" + frame[5:6] + b"\x07" + frame[6:]
    with pytest.raises(zstd.CorruptZstd, match="dictionary 7"):
        zstd.decompress(named, 1000)


def test_crc32c():
    assert zstd.crc32c(b"123456789") == 0xE3069283
    data = np.random.default_rng(1).bytes(1001)
    assert zstd.crc32c(data[500:], zstd.crc32c(data[:500])) == zstd.crc32c(data)


def test_committed_fixtures_decode_to_their_digests():
    digests = json.loads((FIXTURES / "digests.json").read_text())
    for name, want in digests["zstd"].items():
        got = zstd.decompress((FIXTURES / "zstd" / name).read_bytes(), want["size"])
        assert hashlib.sha256(got).hexdigest() == want["sha256"], name
    assert orbax_format.tree_digests(orbax_format.read_tree(FIXTURES / "manager" / "37")) \
        == digests["manager"]
    assert orbax_format.tree_digests(orbax_format.read_tree(FIXTURES / "export")) \
        == digests["export"]
    assert orbax_format.step_dirs(FIXTURES / "manager") == {37: str(FIXTURES / "manager" / "37")}


# ------------------------------------------------- the full-width TrainState

_TX = jax_make_optimizer(JaxTrainConfig())


def _seeded_state(params, count: int, seed: int) -> TrainState:
    """A ``TrainState`` of ``make_optimizer``'s chain with both counts at
    ``count`` and moments drawn from ``seed``. Built from the chain's
    abstract state (``jax.eval_shape``): ``tx.init`` would compile one
    zeros op for each of the 250 leaf shapes."""
    rng = np.random.default_rng(seed)
    abstract = jax.eval_shape(_TX.init, params)
    adam = abstract[1][0]
    mu = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape, np.float32) * 1e-3), adam.mu)
    nu = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.random(x.shape, np.float32) * 1e-6), adam.nu)
    c = jnp.asarray(count, jnp.int32)
    opt = (abstract[0], (adam._replace(count=c, mu=mu, nu=nu), abstract[1][1],
                         abstract[1][2]._replace(count=c)))
    return TrainState(step=count, apply_fn=None, params=params, tx=_TX, opt_state=opt)


@pytest.fixture(scope="module")
def full(tmp_path_factory):
    """Steps 37 and 2500 of a full-width ``TrainState`` written by
    ``tcs_tpu``'s ``CheckpointManager``, and the trees it restores."""
    d = tmp_path_factory.mktemp("full")
    model = TCStereo(MCFG, device="cpu", seed=3)
    params = jax.tree_util.tree_map(jnp.asarray,
                                    convert.params_from_state_dict(model.state_dict()))
    states = {WARM: _seeded_state(params, WARM, 1), AFTER: _seeded_state(params, AFTER, 2)}
    mgr = jax_ckpt.CheckpointManager(str(d / "run"))
    for step, state in states.items():
        mgr.save(step, state, wait=True)
    mgr.close()
    target = states[WARM]  # restore reads its shapes and dtypes
    restored = {s: jax_ckpt.CheckpointManager(str(d / "run")).restore(target, step=s)
                for s in states}
    return dict(dir=d, run=str(d / "run"), target=target, restored=restored, port={})


def _port(full, step):
    """A port model, AdamW and schedule with ``step`` of the run read into
    them, fresh ones for each caller: the restore runs once per step, and
    callers get deep copies (the optimiser's state keyed by the copied
    parameters)."""
    if step not in full["port"]:
        model = TCStereo(MCFG, device="cpu", seed=0)
        opt, sched = optim.make_optimizer(model.parameters(), TrainConfig())
        got = ck.restore_tcs_tpu(full["run"], model, opt, sched, step=step)
        full["port"][step] = (model, opt, sched, got)
    return copy.deepcopy(full["port"][step])


def _sd(tree):
    return convert.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def test_ocdbt_keys_and_values_are_tensorstores(full):
    item = os.path.join(full["run"], str(WARM), "default")
    store = ocdbt.OcdbtStore(item)
    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + item}).result()
    want = sorted(k.decode() for k in kv.list().result())
    assert store.keys() == want and len(want) > 1000
    reads = [kv.read(k.encode()) for k in want]  # issued together
    for k, r in zip(want, reads):
        assert store.read(k) == r.result().value, k


def test_ocdbt_interior_nodes(tmp_path):
    """A b-tree of height > 0 (nodes of at most 400 bytes), values inline
    and by reference; a flipped byte in the manifest or in the nodes fails
    its checksum."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}",
                          "config": {"max_decoded_node_bytes": 400,
                                     "max_inline_value_bytes": 24}}).result()
    rng = np.random.default_rng(0)
    values = {f"opt_state.1.0.mu.params.layer{i // 7}.Conv_{i % 7}/0.0".encode():
              rng.bytes(int(rng.integers(0, 80))) for i in range(300)}
    with ts.Transaction() as txn:
        for k, v in values.items():
            kv.with_transaction(txn).write(k, v).result()
    store = ocdbt.OcdbtStore(tmp_path)
    assert store.height > 0
    assert store.keys() == sorted(k.decode() for k in values)
    assert all(store.read(k.decode()) == v for k, v in values.items())
    manifest = tmp_path / "manifest.ocdbt"
    good = manifest.read_bytes()
    manifest.write_bytes(good[:20] + bytes([good[20] ^ 1]) + good[21:])
    with pytest.raises(ocdbt.CorruptOcdbt, match="CRC-32C"):
        ocdbt.OcdbtStore(tmp_path)
    manifest.write_bytes(good)
    magic = ocdbt.BTREE_MAGIC.to_bytes(4, "big")
    for path in (tmp_path / "d").iterdir():  # every node: the newest root among them
        blob = bytearray(path.read_bytes())
        at = blob.find(magic)
        while at >= 0:
            blob[at + 16] ^= 1
            at = blob.find(magic, at + 1)
        path.write_bytes(bytes(blob))
    with pytest.raises(ocdbt.CorruptOcdbt, match="CRC-32C"):
        ocdbt.OcdbtStore(tmp_path)


@pytest.mark.parametrize("step", [WARM, AFTER])
def test_restore_equals_tcs_tpus_restore(full, step):
    model, opt, sched, got = _port(full, step)
    ref = full["restored"][step]
    assert got == step == int(ref.step)
    want = _sd(ref.params)
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())
    adam = ref.opt_state[1][0]
    mu, nu = _sd(adam.mu), _sd(adam.nu)
    for name, p in model.named_parameters():
        st = opt.state[p]
        assert torch.equal(st["exp_avg"], mu[name]) and torch.equal(st["exp_avg_sq"], nu[name])
        assert float(st["step"]) == int(adam.count) == step
    assert sched.last_epoch == step
    want_lr = float(onecycle_linear_schedule(2e-4, JaxTrainConfig().num_steps + 100)(step))
    assert opt.param_groups[0]["lr"] == pytest.approx(want_lr, rel=1e-6)


@jax.jit
def _optax_update(grads, opt_state, params):
    updates, _ = _TX.update(grads, opt_state, params)
    return updates, optax.apply_updates(params, updates)


def _ravel(tree):
    """The leaves of ``tree`` as one float64 numpy vector, and what
    :func:`_unravel` needs to undo it."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    arrays = [np.asarray(x, np.float64) for x in leaves]
    return np.concatenate([a.ravel() for a in arrays]), (treedef, [a.shape for a in arrays])


def _unravel(vec, spec):
    treedef, shapes = spec
    ends = np.cumsum([int(np.prod(s)) for s in shapes])
    return jax.tree_util.tree_unflatten(
        treedef, [p.reshape(s) for p, s in zip(np.split(vec, ends[:-1]), shapes)])


@pytest.mark.parametrize("step", [WARM, AFTER])
def test_one_adamw_update_equals_optax(full, step):
    """One update from the restored state with a seeded gradient tree (its
    norm ~40: the clip acts): the port's clip, AdamW and ``LambdaLR`` against
    ``tx.update`` + ``optax.apply_updates``. Both run in float64 from the
    restored fp32 state (exact widening), so that what is compared is the
    update's arithmetic and not the rounding of fp32 parameters: in fp32 the
    two differ by up to an ulp of the parameter (1.7e-8 at |p| ~ 0.2, with
    updates of 2.4e-3), which the bound below would not see past. ``tcs_tpu``'s
    schedule computes the learning rate in float32 (``astype(jnp.float32)``),
    6e-8 relative from the port's float64 ``LambdaLR``."""
    model, opt, sched, _ = _port(full, step)
    for p in model.parameters():
        st = opt.state[p]
        p.data = p.data.double()
        st["exp_avg"], st["exp_avg_sq"] = st["exp_avg"].double(), st["exp_avg_sq"].double()
    state = full["restored"][step]
    rng = np.random.default_rng(step)
    grads = jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32) * 1e-2, state.params)
    # tx.update + optax.apply_updates on each tree raveled into one vector
    # (one program to compile, not one op for each of 250 leaf shapes): the
    # chain is elementwise but for the clip's global norm, which one leaf
    # gives alike
    flat_p, spec = _ravel(state.params)
    adam = state.opt_state[1][0]
    opt_state = (state.opt_state[0], (adam._replace(mu=_ravel(adam.mu)[0],
                                                    nu=_ravel(adam.nu)[0]),
                                      state.opt_state[1][1], state.opt_state[1][2]))
    with jax.enable_x64(True):
        updates, new = _optax_update(_ravel(grads)[0], opt_state, flat_p)
        scale = float(jnp.max(jnp.abs(updates)))
        new = _unravel(np.asarray(new, np.float64), spec)
    # convert's relayout works in fp32: carry float64 as two fp32 parts
    hi = jax.tree_util.tree_map(lambda x: x.astype(np.float32), new)
    lo = jax.tree_util.tree_map(lambda x, h: (x - h).astype(np.float32), new, hi)
    hi, lo = convert.state_dict_from_jax(hi), convert.state_dict_from_jax(lo)
    new = {k: hi[k].double() + lo[k].double() for k in hi}
    g = convert.state_dict_from_jax(grads)
    for name, p in model.named_parameters():
        p.grad = g[name].double()
    grads_port = [p.grad for p in model.parameters()]
    norm = optim.global_norm(grads_port)
    assert float(norm) > TrainConfig().grad_clip
    optim.clip_by_global_norm_(grads_port, norm, TrainConfig().grad_clip)
    opt.step()
    sched.step()
    err = max(float((v - new[k]).abs().max()) for k, v in model.state_dict().items())
    print(f"count {step}: max |Δparam| {err:.3g}, largest update entry {scale:.3g}")
    assert err <= UPDATE_TOL * scale, (err, scale)


def test_tcs_tpu_reads_the_ports_state_and_params(full, tmp_path):
    model, opt, sched, _ = _port(full, WARM)
    ck.save_tcs_tpu(tmp_path / "run", WARM, model, opt, sched)
    mgr = jax_ckpt.CheckpointManager(str(tmp_path / "run"))
    assert mgr.latest_step() == WARM
    back, ref = mgr.restore(full["target"]), full["restored"][WARM]
    assert int(back.step) == WARM
    same = jax.tree_util.tree_map(lambda a, b: bool(np.array_equal(np.asarray(a),
                                                                   np.asarray(b))),
                                  (back.params, back.opt_state), (ref.params, ref.opt_state))
    assert all(jax.tree_util.tree_leaves(same))
    only = mgr.restore_params_only(full["target"].params)
    assert all(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a, b: bool(np.array_equal(np.asarray(a), np.asarray(b))), only, ref.params)))
    ck.save_params(model, tmp_path / "export")
    exported = jax_ckpt.load_params(str(tmp_path / "export"), full["target"].params)
    assert all(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a, b: bool(np.array_equal(np.asarray(a), np.asarray(b))), exported, ref.params)))


def test_save_params_export_and_restore_params_only(full, tmp_path):
    """``tcs_tpu``'s ``save_params`` export through ``load_any``; a
    ``CheckpointManager`` directory gives its newest step's params, through
    ``load_any`` and ``CheckpointManager.restore_params_only``."""
    jax_ckpt.save_params(str(tmp_path / "export"), full["restored"][WARM].params)
    newest = _sd(full["restored"][AFTER].params)
    for path, want in ((tmp_path / "export", _sd(full["restored"][WARM].params)),
                       (full["run"], newest)):
        model = ck.load_any(TCStereo(MCFG, device="cpu", seed=5), str(path))
        assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())
    model = ck.CheckpointManager(full["run"]).restore_params_only(
        TCStereo(MCFG, device="cpu", seed=5))
    assert all(torch.equal(v, newest[k]) for k, v in model.state_dict().items())


def test_bf16_leaf_and_array_sharded_into_chunks(tmp_path):
    mesh = Mesh(np.array(jax.devices()[:8]), ("x",))
    rng = np.random.default_rng(4)
    tree = {"params": {
        "sharded": jax.device_put(jnp.asarray(rng.standard_normal((40, 6), np.float32)),
                                  NamedSharding(mesh, PartitionSpec("x", None))),
        "bf16": jnp.asarray(rng.standard_normal((5, 7)), jnp.bfloat16),
        "i32": jnp.asarray(rng.integers(-5, 5, (3,)), jnp.int32)}}
    jax_ckpt.save_params(str(tmp_path / "e"), tree)
    zarray = json.loads(orbax_format._Ocdbt(str(tmp_path / "e")).get(
        "params.sharded/.zarray"))
    assert zarray["chunks"] == [5, 6]  # eight chunks
    got = orbax_format.read_tree(tmp_path / "e")["params"]
    restored = jax_ckpt.load_params(str(tmp_path / "e"), tree)["params"]
    for k, t in got.items():
        ref = np.asarray(restored[k])
        assert str(t.dtype).replace("torch.", "") == str(ref.dtype)
        assert t.contiguous().view(torch.uint8).numpy().tobytes() == ref.tobytes(), k


def test_uncommitted_step_skipped_and_refusals(tmp_path):
    run = tmp_path / "run"
    shutil.copytree(FIXTURES / "manager", run)
    (run / "40.orbax-checkpoint-tmp-7").mkdir()
    assert sorted(orbax_format.step_dirs(run)) == [37]
    item = run / "37" / "default"
    meta = json.loads((item / "_METADATA").read_text())
    (item / "_METADATA").write_text(json.dumps({**meta, "use_zarr3": True}))
    with pytest.raises(orbax_format.UnsupportedCheckpoint, match="zarr3"):
        orbax_format.read_tree(run / "37")
    leaf = dict(meta["tree_metadata"])
    key = next(iter(leaf))
    leaf[key] = {**leaf[key], "value_metadata": {"value_type": "string"}}
    (item / "_METADATA").write_text(json.dumps({**meta, "tree_metadata": leaf}))
    with pytest.raises(orbax_format.UnsupportedCheckpoint, match="'string'"):
        orbax_format.read_tree(run / "37")
    export = tmp_path / "export"
    orbax_format.save_tree(export, {"a": torch.ones(3)})
    zarray = json.loads((export / "a" / ".zarray").read_text())
    (export / "a" / ".zarray").write_text(json.dumps({**zarray, "compressor": {"id": "blosc"}}))
    with pytest.raises(orbax_format.UnsupportedCheckpoint, match="blosc"):
        orbax_format.read_tree(export)


def test_schedule_count_must_match(tmp_path):
    """A state whose schedule count is not AdamW's is refused before
    anything is loaded."""
    run = tmp_path / "run"
    tree = orbax_format.read_tree(FIXTURES / "manager" / "37")
    adam, _ = tree["opt_state"]["1"]["0"], tree["opt_state"]["1"]["2"]
    orbax_format.save_step(run, 37, {"step": 37, "params": tree["params"], "opt_state": (
        None, (adam, None, {"count": torch.tensor(36, dtype=torch.int32)}))})
    with pytest.raises(ValueError, match="schedule's count 36 is not AdamW's 37"):
        ck.restore_tcs_tpu(run, None, None, None)


# ----------------------------------------------------------- trainer and CLI

@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("orbax_kitti"))
    fabricate.kitti_raw_tree(root, frames=3, height=80, width=112)  # 4 batches an epoch
    kitti_raw_pose.main(["--root", os.path.join(root, "kitti_raw")])
    return root


def _cfg(tree, ckdir, **kw):
    base = dict(train_dataset="kitti_raw", data_root=tree, image_size=(64, 96), frame_length=2,
                batch_size=1, train_iters=2, num_steps=6, num_workers=0,
                spatial_scale=(-0.2, 0.2), saturation_range=(0.7, 1.3),
                checkpoint_dir=str(ckdir), validation_frequency=1000, model=MCFG)
    return TrainConfig(**{**base, **kw})


def test_trainer_resumes_a_tcs_tpu_run(kitti_tree, full, tmp_path):
    """The run's directory holds ``tcs_tpu``'s steps 37 and 2500 (linked
    from the module's run) and none of the port's: the trainer resumes step
    2500 at the loader position divmod(2500, 4 batches an epoch) and takes
    one step from its weights, moments and learning rate: AdamW's first
    moment after the step is the restored one moved toward the step's
    clipped gradient (``lerp``, as AdamW computes it), and the learning rate
    is the schedule's at 2501."""
    cfg = _cfg(kitti_tree, tmp_path, num_steps=AFTER + 1)
    run = Path(cfg.checkpoint_dir) / cfg.name
    run.mkdir()
    for step in (WARM, AFTER):
        (run / str(step)).symlink_to(Path(full["run"]) / str(step))
    trainer = Trainer(cfg, device="cpu")
    assert trainer.train() == {"step": AFTER + 1, "epoch": 626, "batch": 1,
                               "preempted": False}
    with open(os.path.join(cfg.checkpoint_dir, f"{cfg.name}_steps.jsonl")) as f:
        (record,) = [json.loads(line) for line in f]
    assert (record["step"], record["epoch"], record["batch"]) == (AFTER + 1, 626, 0)
    mu = _sd(full["restored"][AFTER].opt_state[1][0].mu)
    opt = trainer.step_fn.optimizer
    for name, p in trainer.model.named_parameters():
        assert torch.equal(opt.state[p]["exp_avg"], mu[name].lerp(p.grad, 1 - 0.9)), name
        assert float(opt.state[p]["step"]) == AFTER + 1
    schedule = optim.onecycle_linear_schedule(cfg.lr, cfg.num_steps + 100)
    assert opt.param_groups[0]["lr"] == pytest.approx(schedule(AFTER + 1), rel=1e-12)


def test_divergence_goes_back_to_the_tcs_tpu_step(kitti_tree, full, tmp_path):
    """Diverging before the port's first checkpoint of a resumed ``tcs_tpu``
    run goes back to ``tcs_tpu``'s step, and the data goes on (the step's
    metrics replaced: NaN at its first three calls)."""
    cfg = _cfg(kitti_tree, tmp_path, num_steps=WARM + 4)
    run = Path(cfg.checkpoint_dir) / cfg.name
    run.mkdir()
    (run / str(WARM)).symlink_to(Path(full["run"]) / str(WARM))
    trainer = Trainer(cfg, device="cpu")
    real, calls = trainer.step_fn, [0]

    def step(batch, extra=None):
        calls[0] += 1
        v = float("nan") if calls[0] <= 3 else 1.0
        return {"live_loss": torch.tensor(v), "grad_norm": torch.tensor(v),
                **{k: torch.tensor(float(x)) for k, x in (extra or {}).items()}}

    step.optimizer, step.scheduler = real.optimizer, real.scheduler
    trainer.step_fn = step
    assert trainer.train()["step"] == WARM + 4
    with open(os.path.join(cfg.checkpoint_dir, f"{cfg.name}_steps.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [38, 39, 40, 38, 39, 40, 41]
    assert [r["batch"] for r in records] == [1, 2, 3, 0, 1, 2, 3]  # 37 = 9 epochs of 4 + 1


def test_restore_ckpt_takes_a_tcs_tpu_directory(kitti_tree, tmp_path):
    src = TCStereo(MCFG, device="cpu", seed=11)
    ck.save_params(src, tmp_path / "export")
    cfg = _cfg(kitti_tree, tmp_path / "ck", restore_ckpt=str(tmp_path / "export"))
    trainer = Trainer(cfg, device="cpu")
    assert trainer.init_state(4) == (0, 1, 0)
    assert all(torch.equal(v, src.state_dict()[k])
               for k, v in trainer.model.state_dict().items())


def test_cli_evaluate_restore_ckpt_takes_tcs_tpu_directories(tmp_path, capsys):
    trees = str(tmp_path / "trees")
    fabricate.tartanair_tree(trees, frames=3, height=64, width=96, seed=1)
    src = TCStereo(MCFG, device="cpu", seed=13)
    ck.save_weights(src, str(tmp_path / "w.pth"))
    ck.save_params(src, tmp_path / "export")
    opt, sched = optim.make_optimizer(src.parameters(), TrainConfig())
    ck.save_tcs_tpu(tmp_path / "run", 0, src, opt, sched)
    flags = ["--dataset", "TartanAir", "--data_root", trees, "--device", "cpu",
             "--no_mixed_precision", "--valid_iters", "1"]
    results = [cli.main([*flags, "--restore_ckpt", str(p)])
               for p in (tmp_path / "w.pth", tmp_path / "export", tmp_path / "run")]
    assert results[0] == results[1] == results[2]
    assert "Loaded checkpoint" in capsys.readouterr().out
