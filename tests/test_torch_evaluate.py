"""The port's evaluators, weight files and evaluation CLI against tcs_tpu.

The three evaluators run end to end on both sides over trees fabricated at
64×96 (``tcs_tpu_torch.data.fabricate``) with the same weights, in the fp32
config. Each ``tcs_tpu`` evaluator builds a fresh ``jax.jit`` per call
(``tcs_tpu/evaluate.py:54-61``); here ``make_eval_fn`` hands out one jitted
step, so one JAX compile serves all three.

Bounds: EPE within the flow bound; D1, D3 and the temporal-consistency
metrics within :func:`tcs_tpu_torch.evaluate.metric_bounds` of the port's
run at that bound (the share of valid pixels whose error lies that close to
the metric's threshold); the KITTI submission PNG within the flow bound
×256 plus one LSB.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcs_tpu.evaluate as jax_evaluate
from tcs_tpu.config import ModelConfig as JaxConfig
from tcs_tpu.models import TCStereo as JaxTCStereo
from tcs_tpu_torch import ModelConfig
from tcs_tpu_torch import evaluate
from tcs_tpu_torch.cli import evaluate as cli
from tcs_tpu_torch.convert import state_dict_from_jax
from tcs_tpu_torch.data import fabricate, frame_utils
from tcs_tpu_torch.models import TCStereo
from tcs_tpu_torch.utils import checkpoint
from tools.convert_torch_ckpt import convert_state_dict

# The test processes share the host: two intra-op threads each, so that
# several workers do not oversubscribe its cores.
torch.set_num_threads(2)

H, W, ITERS = 64, 96, 2
FLOW_TOL = 5e-2  # px: the bound tests/test_parity.py holds tcs_tpu to against the reference
CFG = ModelConfig(mixed_precision=False, corr_dtype="float32")
JCFG = JaxConfig(mixed_precision=False, corr_dtype="float32")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed", range(4))
def test_metric_functions_match_tcs_tpu(seed):
    rng = np.random.default_rng(seed)
    shape = (40, 50)
    gt, prev_gt = (rng.uniform(0, 250, shape) for _ in range(2))  # ≥ 192 is invalid
    gt[rng.random(shape) < 0.1] = 1e4
    disp, prev_disp = gt + rng.normal(0, 3, shape), prev_gt + rng.normal(0, 3, shape)
    a = evaluate._epe_metrics(disp, gt)
    b = jax_evaluate._epe_metrics(disp, gt)
    assert a.keys() == b.keys() and all(abs(a[k] - b[k]) <= 1e-12 for k in a)
    a = evaluate.temporal_consistency_metrics(prev_disp, disp, prev_gt, gt)
    b = jax_evaluate.temporal_consistency_metrics(prev_disp, disp, prev_gt, gt)
    assert a.keys() == b.keys() and all(abs(a[k] - b[k]) <= 1e-12 for k in a)
    assert evaluate._epe_metrics(disp, np.full(shape, 500.0)) is None
    rows = [jax_evaluate._epe_metrics(gt + rng.normal(0, s, shape), gt) for s in (0.5, 2, 5)]
    a, b = evaluate._aggregate(rows, "x"), jax_evaluate._aggregate(rows, "x")
    assert a.keys() == b.keys() and all(abs(a[k] - b[k]) <= 1e-12 for k in a)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval_trees"))
    fabricate.tartanair_tree(root, frames=3, height=H, width=W, seed=1)
    fabricate.things_tree(root, frames=3, height=H, width=W, seed=2)
    fabricate.kitti_tree(root, frames=11, height=H, width=W, seed=3)
    return root


@pytest.fixture(scope="module")
def weights():
    """tcs_tpu parameters and the port holding the same weights."""
    sd = TCStereo(CFG, device="cpu", seed=11).state_dict()
    jparams = jax.tree_util.tree_map(
        jnp.asarray, convert_state_dict({k: v.numpy() for k, v in sd.items()}))
    port = TCStereo(CFG, device="cpu", seed=12)
    port.load_state_dict(state_dict_from_jax(jparams), strict=True)
    return jparams, port


def _recording(call, store):
    """``call``, a ``TemporalEvaluator.__call__``, also keeping each disparity."""

    def wrapped(self, *args):
        out = call(self, *args)
        store.append(out)
        return out

    return wrapped


def _frames(disps, seqs):
    """The recorded disparities with their ground truth, per sequence."""
    out, k = [], 0
    for s in seqs:
        out.append([(disps[k + j], s["read_gt"](p)) for j, p in enumerate(s["disps"])])
        k += len(s["disps"])
    assert k == len(disps)
    return out


@pytest.fixture(scope="module")
def runs(trees, weights, tmp_path_factory):
    jparams, port = weights
    jm = JaxTCStereo(cfg=JCFG)
    step = jax.jit(lambda p, a, b, s, c, T: (lambda o: (o.flow, o.new_state))(
        jm.apply(p, a, b, s, c, T, iters=ITERS, test_mode=True)))
    out_dir = str(tmp_path_factory.mktemp("kitti_out"))
    res, call = {}, evaluate.TemporalEvaluator.__call__
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_evaluate, "make_eval_fn", lambda model, iters: step)
        for name, ours, theirs, kw in (
                ("tartanair", evaluate.validate_tartanair, jax_evaluate.validate_tartanair,
                 dict(root=trees)),
                ("things", evaluate.validate_temporal_things,
                 jax_evaluate.validate_temporal_things, dict(root=trees)),
                ("kitti", evaluate.submit_kitti, jax_evaluate.submit_kitti,
                 dict(root=os.path.join(trees, "KITTI")))):
            disps = []
            mp.setattr(evaluate.TemporalEvaluator, "__call__", _recording(call, disps))
            extra = {}
            if name == "kitti":
                extra = dict(out_dir=os.path.join(out_dir, "port"))
            got = ours(port, CFG, iters=ITERS, device="cpu", **kw, **extra)
            if name == "kitti":
                extra = dict(out_dir=os.path.join(out_dir, "jax"))
            want = theirs(jm, jparams, JCFG, iters=ITERS, **kw, **extra)
            res[name] = got, want, disps
    return res, out_dir


def _seqs(name, trees):
    """The evaluator's sequences, read as it reads them."""
    if name == "tartanair":
        ds = evaluate.TartanAir(None, root=trees, test_keywords=evaluate.tartanair_test_keywords(),
                                is_test=True, mode="temporal")
        read_gt = lambda p: frame_utils.readDispTartanAir(p)[0]  # noqa: E731
    else:
        ds = evaluate.SceneFlowDatasets(None, root=trees, things_test=True, mode="temporal")
        read_gt = lambda p: frame_utils.read_gen(p)  # noqa: E731
    return [dict(disps=ds.test_sequence(i)[2], read_gt=read_gt) for i in range(len(ds))]


@pytest.mark.parametrize("name,prefix", [("tartanair", "TartanAir"), ("things", "things")])
def test_validators_match_tcs_tpu(runs, trees, name, prefix):
    (got, want, disps), _ = runs[0][name], runs[1]
    bounds = evaluate.metric_bounds(_frames(disps, _seqs(name, trees)), FLOW_TOL, prefix,
                                    temporal=name == "tartanair")
    assert got.keys() == want.keys() == bounds.keys()
    assert len(got) == (5 if name == "tartanair" else 3)
    for k in got:
        assert np.isfinite(got[k]) and abs(got[k] - want[k]) <= bounds[k], (k, got[k], want[k],
                                                                             bounds[k])


def test_submit_kitti_matches_tcs_tpu(runs):
    (got, want, disps), out_dir = runs[0]["kitti"], runs[1]
    assert got == want == {"kitti-fps": 0.0}  # tcs_tpu times scenes after the 51st only
    assert len(disps) == 11
    ours = frame_utils.read_uint16_png(os.path.join(out_dir, "port", "disp_0", "000000_10.png"))
    theirs = frame_utils.read_uint16_png(os.path.join(out_dir, "jax", "disp_0", "000000_10.png"))
    assert ours.shape == (H, W)
    assert np.array_equal(ours, (disps[10] * 256.0).astype(np.uint16))
    assert np.abs(ours.astype(np.int64) - theirs).max() <= int(FLOW_TOL * 256) + 1


def test_submit_kitti_writes_pseudo_colour_frames(trees, weights, tmp_path):
    _, port = weights
    out = evaluate.submit_kitti(port, CFG, iters=1, root=os.path.join(trees, "KITTI"),
                                out_dir=str(tmp_path), submission=False, device="cpu")
    assert out == {"kitti-fps": 0.0}
    frames = sorted(os.listdir(tmp_path / "video" / "000000"))
    assert frames == [f"{i:06d}.png" for i in range(11)]
    img = frame_utils.read_image(str(tmp_path / "video" / "000000" / frames[-1]))
    assert img.shape == (H, W, 3)


@pytest.fixture(scope="module")
def pth(weights, tmp_path_factory):
    """The tcs_tpu parameters saved in the reference's format, DDP-prefixed."""
    jparams, _ = weights
    path = str(tmp_path_factory.mktemp("ckpt") / "w.pth")
    torch.save({"model": {"module." + k: v for k, v in state_dict_from_jax(jparams).items()}},
               path)
    return path


def test_checkpoint_round_trip(weights, pth, tmp_path, caplog):
    jparams, port = weights
    fresh = checkpoint.load_weights(TCStereo(CFG, device="cpu", seed=99), pth)
    for k, v in port.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    sd = torch.load(pth, weights_only=True)["model"]
    back = convert_state_dict({k[len("module."):]: v.numpy() for k, v in sd.items()})
    a = jax.tree_util.tree_leaves_with_path(back)
    b = jax.tree_util.tree_leaves_with_path(jparams)
    assert [k for k, _ in a] == [k for k, _ in b]
    assert all(np.array_equal(np.asarray(x), np.asarray(y)) for (_, x), (_, y) in zip(a, b))

    checkpoint.save_weights(port, str(tmp_path / "saved.pth"))
    again = checkpoint.read_state_dict(str(tmp_path / "saved.pth"))
    assert again.keys() == port.state_dict().keys()
    assert all(torch.equal(again[k], v) for k, v in port.state_dict().items())

    bad = dict(sd, **{"module.extra.weight": torch.zeros(1)})
    torch.save(bad, tmp_path / "bad.pth")  # a bare state dict
    with pytest.raises(KeyError, match="extra.weight"):
        checkpoint.load_weights(TCStereo(CFG, device="cpu"), str(tmp_path / "bad.pth"))
    short = {k: v for k, v in sd.items() if "cnet.conv1" not in k}
    torch.save({"model": short}, tmp_path / "short.pth")
    with pytest.raises(KeyError, match="cnet.conv1.weight"):
        checkpoint.load_weights(TCStereo(CFG, device="cpu"), str(tmp_path / "short.pth"))
    with pytest.raises(FileNotFoundError, match="nothing.pth"):
        checkpoint.read_state_dict(str(tmp_path / "nothing.pth"))


def test_checkpoint_skips_batchnorm_running_statistics(tmp_path, caplog):
    cfg = ModelConfig(mixed_precision=False, corr_dtype="float32", context_norm="batch")
    port = TCStereo(cfg, device="cpu", seed=4)
    sd = dict(port.state_dict())
    norms = [k[:-len(".weight")] for k in sd if ".norm" in k and k.endswith(".weight")]
    for n in norms:  # what nn.BatchNorm2d adds to a reference checkpoint
        c = sd[n + ".weight"].numel()
        sd.update({n + ".running_mean": torch.zeros(c), n + ".running_var": torch.ones(c),
                   n + ".num_batches_tracked": torch.tensor(7)})
    torch.save({"model": sd}, tmp_path / "bn.pth")
    with caplog.at_level("INFO", logger="tcs_tpu_torch.utils.checkpoint"):
        loaded = checkpoint.load_weights(TCStereo(cfg, device="cpu", seed=5),
                                         str(tmp_path / "bn.pth"))
    assert f"skipped {3 * len(norms)} BatchNorm running statistics" in caplog.text
    assert all(torch.equal(loaded.state_dict()[k], v) for k, v in port.state_dict().items())


def _scripts_evaluate():
    spec = importlib.util.spec_from_file_location(
        "scripts_evaluate", os.path.join(ROOT, "scripts", "evaluate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("flags", [
    [],
    ["--context_norm", "group", "--no_shared_backbone", "--slow_fast_gru"],
    ["--context_norm", "batch", "--shared_backbone", "--no_mixed_precision"],
    ["--context_norm", "instance", "--mixed_precision", "--corr_levels", "3",
     "--corr_radius", "3", "--n_downsample", "2", "--n_gru_layers", "3"],
    ["--hidden_dims", "64", "96", "128", "--context_norm", "none"],
])
def test_cli_config_matches_scripts_evaluate(flags):
    ref = _scripts_evaluate()
    argv = ["--dataset", "TartanAir", *flags]
    ours = cli.build_model_config(cli.parse_args(argv))
    theirs = ref.build_model_config(ref.parse_args(argv))
    for f in ModelConfig.__dataclass_fields__:
        assert getattr(ours, f) == getattr(theirs, f), f


def test_cli_main_returns_the_in_process_result(trees, weights, pth, capsys):
    _, port = weights
    flags = ["--no_mixed_precision", "--valid_iters", "1"]
    res = cli.main(["--dataset", "TartanAir", "--data_root", trees, "--restore_ckpt", pth,
                    "--device", "cpu", *flags])
    printed = capsys.readouterr().out
    assert "The model has 16.74M learnable parameters." in printed
    cfg = cli.build_model_config(cli.parse_args(["--dataset", "TartanAir", *flags]))
    model = TCStereo(cfg, device="cpu")
    model.load_state_dict(port.state_dict())
    want = evaluate.validate_tartanair(model, cfg, iters=1, root=trees, device="cpu")
    assert res == want
    with pytest.raises(SystemExit, match="missing.pth"):
        cli.main(["--dataset", "kitti", "--restore_ckpt", os.path.join(trees, "missing.pth"),
                  "--device", "cpu"])
