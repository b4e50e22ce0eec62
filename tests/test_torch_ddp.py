"""Data parallelism of the port (``tcs_tpu_torch/parallel/mesh.py``) at world
size 2 on the CPU: two processes over Gloo, one torch thread each, 64x96,
batch 1 per rank, 2-frame windows, the fp32 config.

- The losses and metrics with global counts equal ``tcs_tpu``'s, jitted on a
  2-device mesh of the conftest's virtual CPU devices with the batch sharded,
  to 1e-6 relative, on ranks with unequal valid counts, where the
  reference's DDP (each rank's own means, averaged) is more than 10 % off.
- The DDP step equals one process's step on the stacked batch: the losses to
  1e-5 relative, the whole gradient within ``test_torch_train.py``'s 1e-2 of
  its largest entry with the ReLU kinks free; the two ranks' gradients are
  equal bit for bit, and DDP's broadcast of rank 0's weights changes none.
  With ``context_norm="batch"`` too: batch norm takes the global batch's
  statistics.
- The trainer: 3 steps, a resume and 3 more equal 6 steps bit for bit, each
  rank on its shard of each epoch, and its checkpoint loads into one
  process and converts into tcs_tpu's parameters; a SIGTERM to one rank
  stops both after the same step with one checkpoint, and both exit 0. One
  iteration, so the hidden updater gets no gradient (DDP's unused
  parameters).
- Sharded evaluation over 3 sequences (2 + 1) equals the serial run bit for
  bit, and so does it under batch norm, where ``tcs_tpu``'s mesh evaluation
  differs from its own serial path (ROADMAP Queue 3; its two JAX compiles
  take too long for this file, so ``scripts/tcs_tpu_sharded_eval_fault.py``
  shows that side).
- The training CLI's three flags and ``torch.distributed.run``'s environment
  land in ``initialize_distributed``.

The ranks rendezvous through a file under ``tmp_path``, never a TCP port:
the test processes share the host. One process's references are computed
while the ranks run, and the trainer's three runs run at once, each a group
of two.
"""

import contextlib
import dataclasses
import json
import multiprocessing
import os
import signal
import time

import numpy as np
import pytest
import torch

from tcs_tpu_torch import evaluate as ev
from tcs_tpu_torch.cli import train as cli
from tcs_tpu_torch.config import ModelConfig, TrainConfig
from tcs_tpu_torch.data import fabricate, kitti_raw_pose
from tcs_tpu_torch.data.loader import SequenceLoader
from tcs_tpu_torch.data.synthetic import make_clips
from tcs_tpu_torch.models import TCStereo
from tcs_tpu_torch.models.tc_stereo import TCStereoOutput
from tcs_tpu_torch.parallel import mesh
from tcs_tpu_torch.train import train_step as ts
from tcs_tpu_torch.train.trainer import Trainer

# The test processes share the host: two intra-op threads each, so that
# several workers do not oversubscribe its cores (one in each rank).
torch.set_num_threads(2)

WORLD, B, H, W, FRAMES = 2, 1, 64, 96, 2
SEED = 5
MCFG = ModelConfig(mixed_precision=False, corr_dtype="float32")
MODELS = {"default": MCFG, "batch_norm": dataclasses.replace(MCFG, context_norm="batch")}
LOSS_RTOL = 1e-6  # world 2 against tcs_tpu on a 2-device mesh
STEP_LOSS_RTOL = 1e-5  # DDP step against one process on the stacked batch
GRAD_RTOL = 1e-2  # of the whole gradient's largest entry, kinks free (test_torch_train.py)
TAR_SEQS = (("gascola", "Easy", "P001"), ("gascola", "Hard", "P001"),
            ("hospital", "Hard", "P042"))


# ---------------------------------------------------------------------------
# Two ranks
# ---------------------------------------------------------------------------

def _rank(fn, rank, store, out, args):
    torch.set_num_threads(1)
    mesh.initialize_distributed(f"file://{store}", WORLD, rank, device="cpu")
    try:
        torch.save(fn(rank, *args), os.path.join(out, f"rank{rank}.pt"))
    finally:
        mesh.destroy()


class _Ranks:
    """``fn(rank, *args)`` in WORLD processes of one Gloo group, started at
    once; ``results()`` waits for them (the caller works meanwhile)."""

    def __init__(self, fn, out_dir, *args, timeout=240):
        os.makedirs(out_dir, exist_ok=True)
        ctx = multiprocessing.get_context("spawn")
        self.out_dir, self.deadline = out_dir, time.time() + timeout
        self.procs = [ctx.Process(target=_rank, args=(fn, r, os.path.join(out_dir, "store"),
                                                      out_dir, args)) for r in range(WORLD)]
        for p in self.procs:
            p.start()

    def results(self):
        for p in self.procs:
            p.join(max(0.0, self.deadline - time.time()))
        hung = [p.pid for p in self.procs if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
        assert not hung, f"ranks {hung} did not end in time"
        assert [p.exitcode for p in self.procs] == [0] * WORLD
        return [torch.load(os.path.join(self.out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(WORLD)]


# ---------------------------------------------------------------------------
# Inputs, made from seeds on both sides
# ---------------------------------------------------------------------------

def _loss_case():
    """Predictions and ground truth of one frame at batch 2 (numpy), with
    unequal valid counts and errors: sample 0 mostly valid and close,
    sample 1 a fifth valid and far off."""
    rng = np.random.default_rng(11)
    h, w, iters = H // 4, W // 4, 2
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    disp = 4.0 + 0.1 * xx + 0.04 * yy + 3.0 * (xx > W // 2)
    flow = -np.stack([disp, 0.7 * disp])[..., None].astype(np.float32)
    valid = np.stack([rng.uniform(size=(H, W)) < 0.9,
                      rng.uniform(size=(H, W)) < 0.2])[..., None].astype(np.float32)
    noise = np.array([0.3, 4.0], np.float32).reshape(1, 2, 1, 1, 1)

    def up(n):
        return (flow[None] + noise * rng.normal(size=(n, 2, H, W, 1))).astype(np.float32)

    def q(c):
        return (rng.normal(size=(iters, 2, h, w, c)) * noise).astype(np.float32)

    case = dict(flow=flow, valid=valid,
                flows_up=up(iters), flows_refine_up=up(iters),
                flow_q=q(1) - disp[None, None, ::4, ::4, None] / 4,
                flow_q_refine=q(1) - disp[None, None, ::4, ::4, None] / 4,
                disp_grad=q(2), flow_init=up(1)[0], flow_mono=up(1)[0],
                cost_volume=rng.uniform(-1, 1, size=(2, h, w, w)))
    return {k: v.astype(np.float32) for k, v in case.items()}


def _port_loss_inputs(case, sl):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in case.items()}
    on_batch = lambda x: x[:, sl] if x.ndim == 5 else x[sl]  # noqa: E731
    t = {k: on_batch(v) for k, v in t.items()}
    frame = ts.FrameBatch(image1=None, image2=None, flow=t["flow"], valid=t["valid"], T=None)
    out = TCStereoOutput(flow=None, new_state=None,
                         flow_predictions=(t["flows_up"], t["flows_refine_up"]),
                         flow_q_predictions=(t["flow_q"], t["flow_q_refine"]),
                         disp_grad_q_predictions=t["disp_grad"], flow_init=t["flow_init"],
                         flow_mono=t["flow_mono"], cost_volume=t["cost_volume"])
    return frame, out


LOSS_CFG = TrainConfig(train_dataset="kitti_raw", model=MCFG)  # sparse ground truth


def _clips():
    clips = make_clips(WORLD * B, H, W, FRAMES, SEED, generic_pose=True)
    clips[1]["valid"][:, :, : W // 3] = 0.0  # unequal valid counts
    return clips


def _step_cfg(mcfg, iters=2):
    return TrainConfig(model=mcfg, train_iters=iters, batch_size=B,
                       image_size=(H, W), frame_length=FRAMES)


def _model(mcfg):
    """Weights from a seed, the norms' parameters drawn away from ones and
    zeros (as tests/test_torch_variants.py draws them)."""
    model = TCStereo(mcfg, device="cpu", seed=SEED)
    g = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if ".norm" in n:
                p.uniform_(*((0.5, 1.5) if n.endswith("weight") else (-0.2, 0.2)), generator=g)
    return model


def _rank_step(rank, tree):
    """The losses with global counts, one DDP step of each model, and the
    sharded evaluations, on this rank's share."""
    res = {"draw": torch.rand(3, generator=mesh.process_generator(7))}
    frame, out = _port_loss_inputs(_loss_case(), slice(rank, rank + 1))
    targets = ts.frame_targets(frame, LOSS_CFG)
    mesh.all_reduce_sum(targets.counts)
    targets.init_offset = float(mesh.is_primary())
    loss, metrics = ts.frame_losses(out, frame, LOSS_CFG, targets)
    res["losses"] = {k: float(v) for k, v in
                     mesh.sum_over_ranks({"total": loss.detach(), **metrics}).items()}
    batch = ts.SequenceBatch.from_numpy(_clips()[rank:rank + 1], "cpu")
    for name, mcfg in MODELS.items():
        model = _model(mcfg)
        before = [v.clone() for v in model.state_dict().values()]
        step = ts.make_train_step(mesh.wrap(model), _step_cfg(mcfg))
        kept = all(torch.equal(a, b) for a, b in zip(before, model.state_dict().values()))
        metrics = step(batch)
        res[name] = dict(kept=kept, metrics={k: float(v) for k, v in metrics.items()},
                         grads={n: p.grad.clone() for n, p in model.named_parameters()})
    for name, n_seq in (("default", 3), ("batch_norm", 2)):
        res[f"eval {name}"] = ev.validate_tartanair(
            _model(MODELS[name]), MODELS[name], iters=1, root=tree, max_sequences=n_seq,
            device="cpu", sharded=True)
    return res


@pytest.fixture(scope="module")
def tar_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ddp_tartanair"))
    fabricate.tartanair_tree(root, sequences=TAR_SEQS, frames=2, height=H, width=W, seed=5)
    return root


@contextlib.contextmanager
def _one_thread():
    """As each rank runs: the same thread count gives the same sums."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _one_process(tree):
    """What the ranks are held to, from one process: each model's step on
    the stacked batch, and the serial evaluations."""
    ref = {}
    for name, mcfg in MODELS.items():
        model = _model(mcfg)
        metrics = ts.make_train_step(model, _step_cfg(mcfg))(
            ts.SequenceBatch.from_numpy(_clips(), "cpu"))
        ref[name] = dict(metrics={k: float(v) for k, v in metrics.items()},
                         grads={n: p.grad.clone() for n, p in model.named_parameters()})
    with _one_thread():
        for name, n_seq in (("default", 3), ("batch_norm", 2)):
            ref[f"eval {name}"] = ev.validate_tartanair(
                _model(MODELS[name]), MODELS[name], iters=1, root=tree, max_sequences=n_seq,
                device="cpu")
    return ref


@pytest.fixture(scope="module")
def step_ranks(tar_tree, tmp_path_factory):
    """The ranks' results and one process's, computed while they run."""
    ranks = _Ranks(_rank_step, str(tmp_path_factory.mktemp("ddp_step")), tar_tree)
    ref = _one_process(tar_tree)
    return ranks.results(), ref


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def test_losses_with_global_counts_are_tcs_tpus_on_a_mesh(step_ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tcs_tpu.config import ModelConfig as JaxModelConfig
    from tcs_tpu.config import TrainConfig as JaxTrainConfig
    from tcs_tpu.parallel import mesh as jmesh
    from tcs_tpu.train.train_step import FrameBatch, frame_losses_parts

    case = _loss_case()
    jm = jmesh.create_mesh(jax.devices()[:WORLD])

    def put(x):  # the batch axis sharded: axis 1 of (iters, B, ...), else axis 0
        spec = P(None, "data") if x.ndim == 5 else P("data")
        return jax.device_put(jnp.asarray(x), NamedSharding(jm, spec))

    jcfg = JaxTrainConfig(train_dataset="kitti_raw",
                          model=JaxModelConfig(mixed_precision=False, corr_dtype="float32"))
    zeros = np.zeros((WORLD, H, W, 3), np.float32)
    frame = FrameBatch(image1=put(zeros), image2=put(zeros), flow=put(case["flow"]),
                       valid=put(case["valid"]), T=put(np.zeros((WORLD, 4, 4), np.float32)))
    fn = jax.jit(lambda fr, *a: frame_losses_parts(*a, fr, jcfg))
    jloss, jmetrics = fn(frame, (put(case["flows_up"]), put(case["flows_refine_up"])),
                         (put(case["flow_q"]), put(case["flow_q_refine"])),
                         put(case["disp_grad"]), put(case["flow_init"]),
                         put(case["flow_mono"]), put(case["cost_volume"]))
    want = {"total": float(jloss), **{k: float(v) for k, v in jmetrics.items()}}
    ranks, _ = step_ranks
    got = ranks[0]["losses"]
    assert got == ranks[1]["losses"]  # one all-reduce: the same on every rank
    assert got.keys() == want.keys()
    worst = max(want, key=lambda k: _rel(got[k], want[k]))
    print(f"world 2 against tcs_tpu on a 2-device mesh: worst {worst} "
          f"{_rel(got[worst], want[worst]):.2e} relative")
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=LOSS_RTOL, abs=1e-7), k

    # The reference's DDP: each rank's own means, the ranks' losses averaged.
    local = [ts.frame_losses(out, frame, LOSS_CFG)[0].item() for frame, out in
             (_port_loss_inputs(case, slice(r, r + 1)) for r in range(WORLD))]
    off = _rel(float(np.mean(local)), want["total"])
    print(f"per-rank means averaged: {np.mean(local):.6f} against {want['total']:.6f} "
          f"({off:.1%} off)")
    assert off > 0.10


@pytest.mark.parametrize("name", list(MODELS))
def test_ddp_step_is_one_process_on_the_stacked_batch(step_ranks, name):
    want, one = step_ranks[1][name]["metrics"], step_ranks[1][name]["grads"]
    ranks = [r[name] for r in step_ranks[0]]
    assert all(r["kept"] for r in ranks)  # DDP's broadcast of rank 0's weights
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    for k in ranks[1]["grads"]:
        assert torch.equal(ranks[0]["grads"][k], ranks[1]["grads"][k]), k
    got = ranks[0]["metrics"]
    assert got.keys() == want.keys()
    for k in ("live_loss", "init_loss", "norm_loss", "grad_loss", "epe", "grad_norm"):
        print(f"{name}: {k} world 2 {got[k]:.7g}, one process {want[k]:.7g}, "
              f"{_rel(got[k], want[k]):.2e} relative")
        assert got[k] == pytest.approx(want[k], rel=STEP_LOSS_RTOL), k
    gmax = max(g.abs().max().item() for g in one.values())
    gap = max((ranks[0]["grads"][n] - g).abs().max().item() for n, g in one.items())
    print(f"{name}: whole gradient, world 2 against one process: {gap / gmax:.2e} of its "
          f"largest entry (bound {GRAD_RTOL:.0e})")
    assert gap <= GRAD_RTOL * gmax


def test_process_generators_differ_by_rank(step_ranks):
    a, b = (r["draw"] for r in step_ranks[0])
    assert not torch.equal(a, b)
    assert torch.equal(torch.rand(3, generator=mesh.process_generator(7)), a)  # rank 0's


def test_sharded_evaluation_is_the_serial_run(step_ranks):
    ranks, ref = step_ranks
    assert ranks[0]["eval default"] == ranks[1]["eval default"] == ref["eval default"]


def test_sharded_batch_norm_evaluation_is_the_serial_run(step_ranks):
    """Evaluation does not sync batch norm: each rank streams its own
    sequences. (tcs_tpu's mesh evaluation stacks its streams into one batch,
    and its batch norm normalises across them: ROADMAP Queue 3,
    scripts/tcs_tpu_sharded_eval_fault.py.)"""
    ranks, ref = step_ranks
    assert ranks[0]["eval batch_norm"] == ranks[1]["eval batch_norm"] == ref["eval batch_norm"]


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ddp_kitti"))
    # 2 drives x 2 windows of 2 frames: an epoch of 2 batches of 1 on each rank
    fabricate.kitti_raw_tree(root, frames=3, height=80, width=112)
    kitti_raw_pose.main(["--root", os.path.join(root, "kitti_raw")])
    return root


def _trainer_cfg(tree, ckdir, **kw):
    base = dict(train_dataset="kitti_raw", data_root=tree, image_size=(H, W),
                frame_length=FRAMES, batch_size=B, train_iters=1, num_steps=6,
                num_workers=0, spatial_scale=(-0.2, 0.2), saturation_range=(0.7, 1.3),
                checkpoint_dir=str(ckdir), validation_frequency=1000, model=MCFG)
    return TrainConfig(**{**base, **kw})


def _rank_trainer(rank, tree, ckdir, run):
    """One run of the trainer: "whole", 6 steps; "parts", 3 steps, then a new
    trainer that resumes and takes 3 more; "sig", stopped by a SIGTERM to
    rank 1 alone before its first step. Its stops, and the indices of the
    samples this rank loaded after the resume (all of them for the others)."""
    seen, from_loader = [], ts.SequenceBatch.from_loader

    def spy(batch, device):
        seen.append(batch["index"].tolist())
        if run == "sig" and rank == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return from_loader(batch, device)

    ts.SequenceBatch.from_loader = staticmethod(spy)
    cfg = _trainer_cfg(tree, os.path.join(ckdir, run), num_steps=50 if run == "sig" else 6)
    res = {}
    if run == "parts":
        res["first"] = Trainer(cfg, device="cpu").train(max_steps=3)
        del seen[:]
    res["stop"], res["seen"] = Trainer(cfg, device="cpu").train(), seen
    return res


@pytest.fixture(scope="module")
def trainer_ranks(kitti_tree, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ddp_trainer"))
    groups = {run: _Ranks(_rank_trainer, os.path.join(d, "out", run), kitti_tree, d, run)
              for run in ("whole", "parts", "sig")}  # three groups of two at once
    return d, {run: g.results() for run, g in groups.items()}


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for k in sorted(obj, key=str) for t in _tensors(obj[k])]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    return []


def _records(d, run):
    with open(os.path.join(d, run, "TC-Stereo_steps.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_trainer_at_world_two_resumes_exactly(trainer_ranks, kitti_tree):
    d, runs = trainer_ranks
    for w, r in zip(runs["whole"], runs["parts"]):
        assert w["stop"] == r["stop"] == {"step": 6, "epoch": 3, "batch": 2,
                                          "preempted": False}
        assert r["first"] == {"step": 3, "epoch": 2, "batch": 1, "preempted": False}
    # weights, optimiser and schedule after 6 steps, bit for bit
    a, b = (torch.load(os.path.join(d, run, "TC-Stereo", "ckpt_000000006.pth"),
                       weights_only=True) for run in ("whole", "parts"))
    assert a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]
    assert a["scheduler"] == b["scheduler"]
    ta, tb = _tensors([a["model"], a["optimizer"]]), _tensors([b["model"], b["optimizer"]])
    assert len(ta) == len(tb) and all(torch.equal(x, y) for x, y in zip(ta, tb))
    whole, parts = _records(d, "whole"), _records(d, "parts")
    pos = lambda r: (r["step"], r["epoch"], r["batch"], r["index"])  # noqa: E731
    assert [pos(r) for r in parts] == [pos(r) for r in whole]
    assert [r["live_loss"] for r in parts] == [r["live_loss"] for r in whole]
    # Each rank loaded its shard of each epoch; the records hold the global batch.
    from tcs_tpu_torch.data.datasets import fetch_dataset

    cfg = _trainer_cfg(kitti_tree, d)
    ds = fetch_dataset(cfg)
    for rank in range(WORLD):
        shard = SequenceLoader(ds, B, seed=cfg.seed, shard_id=rank, num_shards=WORLD)
        want = [shard.batch_indices(rec["epoch"])[rec["batch"]].tolist() for rec in whole]
        assert runs["whole"][rank]["seen"] == want
        assert [rec["index"][rank * B:(rank + 1) * B] for rec in whole] == want
        assert runs["parts"][rank]["seen"] == want[3:]
    for rec in whole:  # an epoch's two batches take its four samples once
        assert len(rec["index"]) == WORLD * B
    assert mesh.world_size() == 1  # this process never joined the group


def test_sigterm_to_one_rank_stops_both_after_the_same_step(trainer_ranks):
    from tcs_tpu_torch.utils.checkpoint import CheckpointManager

    d, runs = trainer_ranks
    stops = [r["stop"] for r in runs["sig"]]
    assert stops[0] == stops[1] and stops[0]["preempted"] and stops[0]["step"] == 1
    assert CheckpointManager(os.path.join(d, "sig", "TC-Stereo")).steps() == [1]
    assert [r["step"] for r in _records(d, "sig")] == [1]


def test_world_two_checkpoint_loads_into_one_process_and_tcs_tpu(trainer_ranks):
    """The parameters are the same at every world size: no ``module.``
    prefix, and tools/convert_torch_ckpt.py gives the tree it gives for a
    single-process model (whose forward test_torch_trainer.py holds to
    tcs_tpu's)."""
    from tcs_tpu_torch.utils.checkpoint import load_weights
    from tools.convert_torch_ckpt import convert_state_dict

    d, _ = trainer_ranks
    path = os.path.join(d, "whole", "TC-Stereo", "ckpt_000000006.pth")
    saved = torch.load(path, map_location="cpu", weights_only=True)["model"]
    assert not [k for k in saved if k.startswith("module.")]
    model = load_weights(TCStereo(MCFG, device="cpu", seed=1), path)
    assert all(torch.equal(v, saved[k]) for k, v in model.state_dict().items())

    def shapes(tree, prefix=()):
        for k, v in tree.items():
            yield from (shapes(v, prefix + (k,)) if isinstance(v, dict)
                        else [(prefix + (k,), np.shape(v))])

    numpy_sd = lambda sd: {k: v.numpy() for k, v in sd.items()}  # noqa: E731
    assert sorted(shapes(convert_state_dict(numpy_sd(saved)))) == sorted(
        shapes(convert_state_dict(numpy_sd(TCStereo(MCFG, device="cpu").state_dict()))))


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

class _Joined(Exception):
    pass


@pytest.mark.parametrize("argv,environ,want", [
    (["--coordinator", "10.0.0.2:29500", "--num_processes", "4", "--process_id", "3"], {},
     ("10.0.0.2:29500", 4, 3)),
    ([], {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29511", "WORLD_SIZE": "2",
          "RANK": "1", "LOCAL_RANK": "1"}, ("env://", 2, 1)),
    ([], {}, (None, None, None)),
], ids=["flags", "launcher", "one_process"])
def test_cli_process_group_args_land_in_initialize_distributed(monkeypatch, argv, environ,
                                                               want):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in environ.items():
        monkeypatch.setenv(k, v)
    got = []

    def joined(*args, **kw):
        got.append((args, kw))
        raise _Joined

    monkeypatch.setattr(mesh, "initialize_distributed", joined)
    with pytest.raises(_Joined):
        cli.main(["--recipe", "sceneflow", "--device", "cpu", *argv])
    assert got == [(want, {"device": "cpu"})]
