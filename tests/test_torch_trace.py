"""The trace capture (``utils/profiling.trace``) and trace summary
(``utils/trace_summary.py``), and the port's public geometry and debug
helpers (``geometry.py``, ``utils/debug.py``) against ``tcs_tpu``'s.

The summary is held exactly on a hand-built trace shaped as kineto writes
one on a GPU (this host has none), with module ranges and with stage spans;
real CPU traces of a small forward and of a small evaluator's two frames
show the capture, the module ranges, the stage spans and that no CPU op
counts as device time. No JAX program is compiled here.
"""

import gzip
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcs_tpu import geometry as jax_geometry
from tcs_tpu.utils import debug as jax_debug
from tcs_tpu_torch import ModelConfig, geometry
from tcs_tpu_torch.evaluate import TemporalEvaluator
from tcs_tpu_torch.models import CameraParams, TCStereo, TemporalState
from tcs_tpu_torch.utils import debug, profiling, trace_summary
from tcs_tpu_torch.utils.trace_summary import (BACKWARD, NO_MODULE, NO_STAGE, STAGE_RANGE,
                                               latest_trace_path, print_summary,
                                               summarize, summarize_trace)

torch.set_num_threads(2)

FWD, BWD = (1, 10), (1, 20)  # (pid, tid): the forward thread, autograd's device thread


def _x(cat, name, ts, dur, where=FWD, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": where[0],
            "tid": where[1], "args": args}


def _launch(ts, corr, where=FWD, name="cudaLaunchKernel"):
    return _x("cuda_runtime", name, ts, 5, where, correlation=corr)


def _device(cat, name, corr, dur, ts=5000):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts + corr, "dur": dur, "pid": 0,
            "tid": 7, "args": {"correlation": corr, "device": 0, "stream": 7}}


SYNTHETIC = [
    _x("user_annotation", "step", 0, 1000),
    _x("cpu_op", "aten::add", 0, 999),  # a CPU op: no device time
    _x("user_annotation", "module::Net", 10, 500),
    _x("user_annotation", "module::enc", 20, 200),
    _x("user_annotation", "module::enc.conv", 30, 100),
    _x("cpu_op", "aten::conv2d", 35, 60, **{"Sequence number": 7}),
    _launch(40, 1),
    _launch(150, 2),
    _launch(300, 3, name="cudaMemcpyAsync"),
    _launch(600, 4),
    _x("cpu_op", "autograd::engine::evaluate_function: ConvolutionBackward0", 700, 100, BWD,
       **{"Sequence number": 7, "Fwd thread id": 1}),
    _launch(710, 5, BWD),
    _x("cpu_op", "autograd::engine::evaluate_function: AddBackward0", 820, 50, BWD,
       **{"Sequence number": 99, "Fwd thread id": 1}),
    _launch(830, 6, BWD),
    _launch(900, 7, name="cudaMemsetAsync"),
    _device("kernel", "void conv_fwd_kernel<float>(float const*)", 1, 50),
    _device("kernel", "elementwise_kernel", 2, 20),
    _device("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 3, 10),
    _device("kernel", "reduce_kernel", 4, 5),
    _device("kernel", "dgrad_kernel", 5, 40),
    _device("kernel", "elementwise_backward", 6, 8),
    _device("gpu_memset", "Memset (Device)", 7, 2),
    _device("kernel", "orphan_kernel", 8, 3),  # its launch is not in the trace
    _device("gpu_user_annotation", "module::enc", 1, 500),  # a range, not device work
    {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 1, "ts": 40, "pid": 1, "tid": 10},
]


def test_summary_of_a_kineto_shaped_trace_is_exact(tmp_path, capsys):
    """Correlated launches in nested module ranges, a backward kernel linked
    to its forward op's module by the sequence number and one with no such
    op, a copy and a fill, a kernel outside every module and one whose
    launch is missing."""
    path = tmp_path / "run" / "host_1.123.pt.trace.json.gz"
    path.parent.mkdir()
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": SYNTHETIC}, f)
    s = summarize_trace(str(tmp_path))
    ms = {"void conv_fwd_kernel<float>(float const*)": 0.05, "elementwise_kernel": 0.02,
          "Memcpy HtoD (Pageable -> Device)": 0.01, "reduce_kernel": 0.005,
          "dgrad_kernel": 0.04, "elementwise_backward": 0.008, "Memset (Device)": 0.002,
          "orphan_kernel": 0.003}
    assert dict(s.by_op) == pytest.approx(ms, abs=1e-15)
    assert dict(s.launches) == dict.fromkeys(ms, 1)
    assert dict(s.by_module) == pytest.approx(
        {"enc.conv": 0.09, "enc": 0.02, "Net": 0.01, BACKWARD: 0.008, NO_MODULE: 0.01},
        abs=1e-15)
    assert dict(s.by_category) == pytest.approx(
        {"conv": 0.05, "elementwise": 0.02, "memcpy": 0.01, "reduce": 0.005,
         "conv backward": 0.04, "backward elementwise/other": 0.008, "memset": 0.002,
         "other": 0.003}, abs=1e-15)
    assert s.total_ms == pytest.approx(0.138, abs=1e-15) and s.events == 8
    assert s.unattributed_ms == pytest.approx(0.01, abs=1e-15)
    assert s.jit_ms == {"step": 1.0}
    print_summary(s, steps=2, top=3)
    out = capsys.readouterr().out
    assert "    0.045   65.2  enc.conv\n" in out and "(no module) 7.2 %" in out
    # strip_prefixes takes a wrapper's prefix off the module paths
    assert "conv" in summarize_trace(str(tmp_path), strip_prefixes=("enc.",)).by_module


# The same trace with stage spans on the forward thread: the conv op (sequence
# number 7) and the first launch in model.encode, the second launch in an
# iteration, the copy's launch in model.frame alone; the backward launch of
# sequence number 7 goes to model.encode through its forward op.
STAGED = SYNTHETIC + [
    _x("user_annotation", STAGE_RANGE + "model.frame", 5, 515),
    _x("user_annotation", STAGE_RANGE + "model.encode", 20, 100),
    _x("user_annotation", STAGE_RANGE + "model.iter", 140, 60),
]


def test_stage_summary_of_a_kineto_shaped_trace_is_exact(capsys):
    """Each device event goes to the innermost stage span around its launch,
    a backward launch to its forward op's stage, the rest to no stage; the
    module tables and the top-level user ranges are those without spans."""
    s, plain = summarize(STAGED), summarize(SYNTHETIC)
    assert dict(s.by_stage) == pytest.approx(
        {"model.encode": 0.09, "model.iter": 0.02, "model.frame": 0.01, BACKWARD: 0.008,
         NO_STAGE: 0.01}, abs=1e-15)
    assert dict(s.stage_launches) == {"model.encode": 2, "model.iter": 1, "model.frame": 1,
                                      BACKWARD: 1, NO_STAGE: 3}
    assert dict(plain.by_stage) == pytest.approx({NO_STAGE: 0.09, BACKWARD: 0.048}, abs=1e-15)
    assert (s.by_module, s.module_launches, s.jit_ms) == (
        plain.by_module, plain.module_launches, plain.jit_ms)
    print_summary(s, steps=2)
    out = capsys.readouterr().out
    assert "    0.045   65.2          1.0  model.encode\n" in out
    assert "    0.004    5.8          0.5  backward\n" in out


def test_a_span_without_a_profiler_is_the_shared_no_op(monkeypatch):
    """No profiler records: ``span`` constructs no ``record_function`` and
    returns one shared object; under a profiler, a range named ``tcs::``."""
    built = []
    real = torch.autograd.profiler.record_function

    def counting(name, *args):
        built.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    idle = profiling.span("eval.inputs")
    assert profiling.span("model.iter") is idle and not built
    with idle:
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("model.iter") as rf:
            pass
    assert built == [STAGE_RANGE + "model.iter"] and rf is not idle
    assert profiling.span("model.iter") is idle


def _tiny(seed=0):
    cfg = ModelConfig(mixed_precision=False, corr_dtype="float32")
    model = TCStereo(cfg, device="cpu", seed=seed)
    cam = CameraParams(K=torch.tensor([[[80.0, 0, 48], [0, 80, 32], [0, 0, 1]]]),
                       baseline=torch.full((1,), 0.5))
    x = torch.from_numpy(np.random.default_rng(seed).uniform(0, 255, (2, 1, 64, 96, 3))
                         .astype(np.float32))

    def run():
        state = TemporalState.zeros(1, 64, 96, cfg, device="cpu")
        return model(x[0], x[1], state, cam, torch.eye(4)[None], iters=1).flow

    return model, run


def test_cpu_trace_of_a_forward(tmp_path):
    """A real ``trace`` of a small forward on the CPU: the newest trace is
    found, it holds a range a module call named by its path, no CPU op is
    device time, the hooks go with the block, and the forward's result is
    the one without tracing."""
    model, run = _tiny()
    with torch.no_grad():
        plain = run()
        with profiling.trace(str(tmp_path / "old")):
            run()
        with profiling.trace(str(tmp_path / "new"), model):
            with torch.autograd.profiler.record_function("frame"):
                traced = run()
        after = run()
    assert torch.equal(plain, traced) and torch.equal(plain, after)
    assert not any(m._forward_hooks or m._forward_pre_hooks for m in model.modules())
    path = latest_trace_path(str(tmp_path))
    assert os.path.dirname(path) == str(tmp_path / "new") and path.endswith(".pt.trace.json.gz")
    with gzip.open(path, "rt") as f:
        names = {e["name"] for e in json.load(f)["traceEvents"] if e.get("ph") == "X"}
    ranges = {n[len(trace_summary.MODULE_RANGE):] for n in names
              if n.startswith(trace_summary.MODULE_RANGE)}
    called = {p or "TCStereo" for p, m in model.named_modules()
              if not isinstance(m, (torch.nn.ModuleList, torch.nn.ModuleDict))}
    assert called <= ranges <= {p or "TCStereo" for p, _ in model.named_modules()}
    s = summarize_trace(str(tmp_path / "new"))
    assert s.total_ms == 0.0 and s.events == 0 and not s.by_op
    assert set(s.jit_ms) == {"frame"} and s.jit_ms["frame"] > 0


MODEL_STAGES = ("model.encode", "model.cost_volume", "model.context", "model.completion",
                 "model.state_warp", "model.upsample")


def test_cpu_trace_of_a_bootstrap_and_a_carried_frame_holds_every_stage(tmp_path):
    """The evaluator's two calls at 2 iterations, a bootstrap and a carried
    frame, traced on the CPU: each call holds its input and output spans
    and one ``model.frame`` around every model span, with ``model.argmax``
    on the bootstrap, ``model.warp`` on the carried frame and one
    ``model.iter`` an iteration; the disparities are those without tracing."""
    cfg = ModelConfig(mixed_precision=False, corr_dtype="float32")
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 255, (2, 2, 64, 96, 3)).astype(np.float32)
    K = np.array([[80.0, 0, 48], [0, 80, 32], [0, 0, 1]], np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)] * 2)
    poses[1, 0, 3] = 0.05
    ev = TemporalEvaluator(TCStereo(cfg, device="cpu"), cfg, iters=2, device="cpu")

    def two_frames():
        ev.reset()
        return [ev(images[k, 0], images[k, 1], K, 0.5, poses[k]) for k in range(2)]

    plain = two_frames()
    with profiling.trace(str(tmp_path)):
        traced = two_frames()
    assert all(np.array_equal(a, b) for a, b in zip(plain, traced))
    with gzip.open(latest_trace_path(str(tmp_path)), "rt") as f:
        spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len(STAGE_RANGE):])
                       for e in json.load(f)["traceEvents"]
                       if e.get("ph") == "X" and e["name"].startswith(STAGE_RANGE))
    frames = [sp for sp in spans if sp[2] == "model.frame"]
    assert len(frames) == 2
    calls = [sp for sp in spans if sp[2] == "eval.inputs"]
    assert len(calls) == 2 and len([sp for sp in spans if sp[2] == "eval.output"]) == 2
    for (s0, e0, _), first_of_call, init in zip(frames, calls, ("model.argmax", "model.warp")):
        inside = [name for s, e, name in spans if s0 < s and e <= e0]
        assert sorted(inside) == sorted(MODEL_STAGES + (init,) + ("model.iter",) * 2)
        assert first_of_call[1] <= s0
    model_spans = [sp for sp in spans if sp[2].startswith("model.") and sp[2] != "model.frame"]
    assert all(any(s0 <= s and e <= e0 for s0, e0, _ in frames) for s, e, _ in model_spans)


def test_nan_checks_fail_at_the_first_non_finite_result():
    debug.enable_nan_checks()
    try:
        x = torch.tensor([1.0, 0.0], requires_grad=True)
        y = x * 2  # finite: passes
        with pytest.raises(FloatingPointError, match="aten.log"):
            torch.log(y - 2)
        with pytest.raises(FloatingPointError, match="aten.div"):
            torch.tensor([1.0]) / torch.tensor([0.0])  # an infinity, which jax_debug_nans passes
    finally:
        debug.enable_nan_checks(False)
    assert torch.isinf(torch.tensor([1.0]) / torch.tensor([0.0])).all()
    assert not torch.is_anomaly_enabled()


def test_finite_checks_name_a_dataclass_field():
    """The port's state types are dataclasses: a leaf's path is its field."""
    cam = CameraParams(K=torch.eye(3)[None], baseline=torch.tensor([float("nan")]))
    assert not debug.check_finite_tree({"cam": cam})
    with pytest.raises(FloatingPointError, match=r"non-finite values in s\['cam'\]\.baseline$"):
        debug.assert_finite({"cam": cam}, "s")


TREES = {
    "finite": {"b": [np.ones(3), (np.zeros(2), np.arange(3))], "a": np.float32(2)},
    "inf_leaf": {"b": [np.ones(3), (np.zeros(2), np.array([1, np.inf]))], "a": np.float32(2)},
    "nan_first": [np.array([np.nan]), {"z": np.ones(1)}],
    "nested_nan": {"x": {"y": [np.ones(2), np.array([[0.0, np.nan]])]}},
}


@pytest.mark.parametrize("name", list(TREES))
def test_finite_checks_are_tcs_tpus(name):
    tree = TREES[name]
    as_torch = jax.tree_util.tree_map(torch.from_numpy, jax.tree_util.tree_map(np.asarray, tree))
    want = jax_debug.check_finite_tree(tree)
    assert debug.check_finite_tree(tree) == debug.check_finite_tree(as_torch) == want
    try:
        jax_debug.assert_finite(tree, "v")
        message = None
    except FloatingPointError as e:
        message = str(e)
    for t in (tree, as_torch):
        if message is None:
            debug.assert_finite(t, "v")
        else:
            with pytest.raises(FloatingPointError) as e:
                debug.assert_finite(t, "v")
            assert str(e.value) == message


def _geometry_inputs():
    rng = np.random.default_rng(0)
    disp = rng.uniform(-1, 30, (2, 5, 7, 1))
    disp[0, 0, 0] = 0.0
    depth = rng.uniform(0.5, 9, (2, 5, 7, 1))
    depth[1, 2, 3], depth[1, 2, 4] = 0.0, np.nan
    fx = rng.uniform(100, 700, 2)
    K = np.stack([np.array([[f, 0.3, 3.1], [0, f * 1.01, 2.2], [0, 0, 1.0]]) for f in fx])
    T = np.stack([np.eye(4)] * 2)
    T[:, :3, :3] = np.linalg.qr(rng.normal(size=(2, 3, 3)))[0]
    T[:, :3, 3] = rng.normal(size=(2, 3))
    points = depth * rng.normal(size=(2, 5, 7, 3))
    return dict(disp=disp, depth=depth, baseline=rng.uniform(0.1, 1, 2), fx=fx, K=K,
                K_inv=np.linalg.inv(K), T=T, points=points)


GEOMETRY = {
    "disp2depth": ("disp", "baseline", "fx"),
    "depth2disp": ("depth", "baseline", "fx"),
    "pixel2point": ("depth", "K_inv"),
    "point2pixel": ("points", "depth", "K"),
    "relative_transform": ("points", "T"),
}


@pytest.mark.parametrize("name", list(GEOMETRY))
def test_geometry_helpers_are_tcs_tpus_in_float64(name):
    """NHWC tensors in float64; zero and NaN depths give −1 on both sides."""
    inputs = _geometry_inputs()
    args = [inputs[k] for k in GEOMETRY[name]]
    with jax.enable_x64(True):
        want = np.asarray(getattr(jax_geometry, name)(*map(jnp.asarray, args)))
    got = getattr(geometry, name)(*map(torch.from_numpy, args))
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-12)
    assert np.array_equal(np.isfinite(got.numpy()), np.isfinite(want))
