"""The port on tcs_tpu's trained weights against tcs_tpu, at 64×96 on the CPU.

``tests/fixtures/convergence_params.npz`` is a trained 16,735,005-parameter
tree in fp16 (``scripts/convergence_synthetic.py --save-params``), the one
``tests/test_train.py::test_temporal_state_beats_reset_with_trained_weights``
holds the paper's claim with. Random weights keep disparities near zero; the
trained ones put the warp path of frame 1 to work. The protocol is that
test's: four two-plane clips of ``SyntheticStereoSequence`` (2 frames),
each drawn from ``default_rng(10_000 + clip)``.

Three tcs_tpu programs are compiled: ``make_eval_step`` in the fp32 config
(``mixed_precision=False, corr_dtype='float32'``) at 1 and 5 iterations
(``iters`` is static there), and in the default bf16 config at 5.

Clip 0's frame 1 in the fp32 config is the one case that does not agree, and
it is a strict xfail. The two packages compute frame 1 alike from a given
frame-0 state (``test_frame1_from_one_state_matches``: ≤ 3e-5 px on every
clip, and tcs_tpu handed the port's state lands on the port's frame 1). What
differs is that state: frame 0's convolutions sum in another order, and its
``disp_q`` is up to 6 ulps from tcs_tpu's (307 of 384 cells differ). The
dataset's camera slides along x by a whole number of pixels, so in exact
arithmetic every splat target of frame 1 sits on an integer row; in fp32 the
projected row ``v`` of a source lands on it or one ulp below it, depending on
those ulps of ``disp_q``. One ulp below, ``floor`` opens a tap on the row
above with a weight of about 1e-9 (source (2, 23) → target (1, 23):
``ty = 1.99999988``, weight 5.6e-10 in tcs_tpu; source (12, 23) → target
(11, 23): ``ty = 11.999999``, weight 3.7e-8 in the port), and the splat's
coverage mask ``norm != 0`` takes that cell. The completion then reads it as
a sparse seed: 0.71 px apart at 1 iteration, 0.081 px at 5 (two intra-op
threads; 1.02 px at 1 iteration with four). tcs_tpu has the same edge: it
moves as far when given the port's frame-0 state. ROADMAP Queue 3 logs it.

The bf16 config's frame 0, stage by stage (``python
scripts/parity_bf16_frame0.py``, clip 2, 2 threads; mean |Δ| bf16 /
fp32 config): the context encoder's net0 3.2e-3 / 7.0e-7 (64 % of its
entries an ulp or more apart), the matching features 2.9e-3 / 5.7e-7, the
cost volume 5.2e-4 / 1.2e-7, the argmax disparity 5.2e-3 / 0 (2 of 384
cells a pixel apart), the completed disparity 4.8e-3 / 1.6e-7 and the flow
after 5 iterations 4.1e-3 / 4.6e-7 px. Each stage alone, the port's module
on tcs_tpu's input: the convolutions put 0 to 8e-4 of their outputs an ulp
apart (the order of the fp32 sums), the hidden-state fusion none; the
matching head 51 % and the disparity completion's hidden states 7 to 26 %,
because tcs_tpu's compiled program feeds each instance norm the
convolution's fp32 result (XLA drops the bf16 rounding that its source asks
for: the norm of a jitted bf16 convolution equals the norm of its fp32
result on every entry; the port keeps the rounding, and would need fp32
convolutions there to copy the compiler). With tcs_tpu's
encoder outputs put in the port, frame 0 is 2.2e-3 px from tcs_tpu's. The
jump is the bf16 rounding of the encoders, amplified: tcs_tpu itself moves
7.1e-3 px when its two-image trunk is packed along channels (its test mode)
or stacked along the batch (its training), one function summed in two
orders. Three roundings of tcs_tpu's that the port lacked are copied
(``tests/test_torch_ops.py``): the bias added after the convolution's bf16
rounding (30 % of a convolution's outputs an ulp apart without it), the
sigmoid as bf16 1 / (1 + exp(−x)) (34 %), the leaky ReLU's slope in bf16
(9 %). Frame 0's mean |Δflow| over the four clips went from 3.20e-3,
4.05e-3, 7.45e-3, 4.53e-3 to 1.46e-3, 4.91e-3, 4.09e-3, 1.86e-3 px, and
frame 1's from 1.71e-3, 4.45e-3, 4.70e-3, 2.43e-3 to 1.19e-3, 2.86e-3,
2.11e-3, 1.07e-3 px.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcs_tpu.config import ModelConfig as JaxConfig
from tcs_tpu.data.synthetic import SyntheticStereoSequence
from tcs_tpu.models import CameraParams as JaxCam
from tcs_tpu.models import TCStereo as JaxTCStereo
from tcs_tpu.models import TemporalState as JaxState
from tcs_tpu.train import make_eval_step
from tcs_tpu.utils.checkpoint import load_params_npz as jax_load_params_npz
from tcs_tpu_torch import ModelConfig
from tcs_tpu_torch.convert import params_from_state_dict, state_dict_from_jax
from tcs_tpu_torch.models import CameraParams, TCStereo, TemporalState
from tcs_tpu_torch.utils.checkpoint import load_params_npz, save_params_npz

# The test processes share the host: two intra-op threads each, so that
# several workers do not oversubscribe its cores.
torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "convergence_params.npz")
H, W, CLIPS = 64, 96, 4
FLOW_TOL = 1e-3  # px, fp32 config
BF16_MEAN_TOL = 5e-3  # px, mean |Δflow| of a clip's last frame, bf16 config
# px, frame 0's mean |Δflow|, bf16 config: the largest measured, 4.91e-3 on
# clip 1, with a margin of a fifth (module docstring)
BF16_FRAME0_MEAN_TOL = 6e-3
BF16_EPE_TOL = 5e-3  # px, EPE against the ground truth, bf16 config
CLAIM_TOL = 2e-2  # px, carried and reset means against tcs_tpu's
CONFIGS = {"fp32": dict(mixed_precision=False, corr_dtype="float32"), "bf16": {}}
FRAME1_FLIP = pytest.mark.xfail(strict=True, reason=(
    "frame 0's disp_q is up to 6 ulps from tcs_tpu's (convolution summation order); "
    "in frame 1 a splat target row of an integer camera shift lands on the integer in "
    "one package and one ulp below it in the other (ty = 1.99999988 at source (2, 23)), "
    "so the coverage mask norm != 0 differs at quarter-grid cells (1, 23) and (11, 23) "
    "(ROADMAP Queue 3)"))


def _clips():
    ds = SyntheticStereoSequence(n_samples=CLIPS, frame_length=2, height=H, width=W,
                                 layered_frac=1.0)
    return [ds.load_sample(ci, np.random.default_rng(10_000 + ci)) for ci in range(CLIPS)]


def _jax_target(jcfg):
    img = jnp.zeros((1, H, W, 3))
    cam = JaxCam(K=jnp.eye(3)[None], baseline=jnp.ones((1,)))
    return jax.eval_shape(
        lambda key: JaxTCStereo(cfg=jcfg).init(key, img, img, JaxState.zeros(1, H, W, jcfg),
                                               cam, jnp.eye(4)[None], iters=1,
                                               test_mode=False),
        jax.random.PRNGKey(0))


def _occlude(s, t):
    """tests/test_train.py's occluded frame: the foreground's right-view
    projection (and a 2-pixel margin) painted with the image's mean colour.
    Returns the right image and the foreground's box."""
    disp_gt = -s["flow"][t][..., 0]
    fg = disp_gt > disp_gt.min() + 0.5
    ys, xs = np.where(fg)
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    d_fg = int(round(disp_gt[fg].max()))
    img2 = s["image2"][t].copy()
    img2[max(y0 - 2, 0):y1 + 2, max(x0 - d_fg - 2, 0):x1 - d_fg + 2] = \
        img2.reshape(-1, 3).mean(0)
    return img2, (y0, y1, x0, x1)


def _port_state(js) -> TemporalState:
    return TemporalState(disp_q=torch.from_numpy(np.array(js.disp_q)),
                         net_list=tuple(torch.from_numpy(np.array(n)) for n in js.net_list),
                         fmap1=torch.from_numpy(np.array(js.fmap1)),
                         T_prev=torch.from_numpy(np.array(js.T_prev)), valid=bool(js.valid))


def _jax_state(ts: TemporalState) -> JaxState:
    return JaxState(disp_q=jnp.asarray(ts.disp_q.numpy()),
                    net_list=tuple(jnp.asarray(n.numpy()) for n in ts.net_list),
                    fmap1=jnp.asarray(ts.fmap1.numpy()), T_prev=jnp.asarray(ts.T_prev.numpy()),
                    valid=jnp.asarray(ts.valid))


class Runs:
    """Both packages on the fixture, each run computed once per module."""

    def __init__(self):
        self.clips = _clips()
        self._cache = {}

    def _once(self, key, fn):
        if key not in self._cache:
            self._cache[key] = fn()
        return self._cache[key]

    def jax_target(self):
        """The tree's structure, the same in every config."""
        return self._once("target", lambda: _jax_target(JaxConfig(**CONFIGS["fp32"])))

    def jax_params(self):
        return self._once("jparams", lambda: jax_load_params_npz(FIXTURE, self.jax_target()))

    def jax_step(self, name, iters):
        return self._once(("jstep", name, iters), lambda: make_eval_step(
            JaxTCStereo(cfg=JaxConfig(**CONFIGS[name])), iters=iters))

    def port(self, name):
        def build():
            model = TCStereo(ModelConfig(**CONFIGS[name]), device="cpu")
            if name == "fp32":
                return load_params_npz(model, FIXTURE)
            model.load_state_dict(self.port("fp32").state_dict())
            return model
        return self._once(("port", name), build)

    def jax_frame(self, name, iters, ci, t, state, img2=None):
        s = self.clips[ci]
        cam = JaxCam(K=jnp.asarray(s["K"])[None], baseline=jnp.asarray([float(s["baseline"])]))
        flow, new = self.jax_step(name, iters)(
            self.jax_params(), jnp.asarray(s["image1"][t])[None],
            jnp.asarray(s["image2"][t] if img2 is None else img2)[None], state, cam,
            jnp.asarray(s["T"][t])[None])
        return np.asarray(flow)[0, ..., 0], new

    def port_frame(self, name, iters, ci, t, state, img2=None):
        s = self.clips[ci]

        def tensor(a):
            return torch.from_numpy(np.asarray(a, np.float32))[None]

        cam = CameraParams(K=tensor(s["K"]), baseline=torch.tensor([float(s["baseline"])]))
        out = self.port(name)(tensor(s["image1"][t]),
                              tensor(s["image2"][t] if img2 is None else img2), state, cam,
                              tensor(s["T"][t]), iters=iters)
        return out.flow.numpy()[0, ..., 0], out.new_state

    def streams(self, name, iters, ci):
        """Both packages' flows of frames 0 and 1, each on its own carry,
        and their states after frame 0."""
        def run():
            jcfg, cfg = JaxConfig(**CONFIGS[name]), ModelConfig(**CONFIGS[name])
            js, ts = JaxState.zeros(1, H, W, jcfg), TemporalState.zeros(1, H, W, cfg,
                                                                           device="cpu")
            jflows, tflows, states = [], [], []
            for t in range(2):
                jf, js = self.jax_frame(name, iters, ci, t, js)
                tf, ts = self.port_frame(name, iters, ci, t, ts)
                jflows.append(jf)
                tflows.append(tf)
                states.append((js, ts))
            return jflows, tflows, states[0]
        return self._once(("streams", name, iters, ci), run)


@pytest.fixture(scope="module")
def runs():
    return Runs()


def _frame_cases():
    for ci in range(CLIPS):
        for iters in (1, 5):
            for t in (0, 1):
                marks = [FRAME1_FLIP] if (ci, t) == (0, 1) else []
                yield pytest.param(ci, iters, t, marks=marks, id=f"clip{ci}-iters{iters}-frame{t}")


@pytest.mark.parametrize("ci,iters,t", _frame_cases())
def test_fp32_flows_match_tcs_tpu(runs, ci, iters, t):
    """Each package on its own carry, as a user streams the clip."""
    jflows, tflows, _ = runs.streams("fp32", iters, ci)
    err = np.abs(jflows[t] - tflows[t])
    print(f"clip {ci} iters {iters} frame {t}: max |dflow| {err.max():.3e} px, "
          f"{int((err > 1e-2).sum())} pixels over 1e-2")
    assert err.max() <= FLOW_TOL


@pytest.mark.parametrize("iters", [1, 5])
@pytest.mark.parametrize("ci", range(CLIPS))
def test_frame1_from_one_state_matches(runs, ci, iters):
    """Frame 1 from one frame-0 state, each package: from tcs_tpu's state the
    port is tcs_tpu, and from the port's state tcs_tpu is the port. The two
    compute the warp path alike; on clip 0 the two states lie on either side
    of an edge of that function (module docstring)."""
    jflows, tflows, (js, ts) = runs.streams("fp32", iters, ci)
    port_from_jax, _ = runs.port_frame("fp32", iters, ci, 1, _port_state(js))
    jax_from_port, _ = runs.jax_frame("fp32", iters, ci, 1, _jax_state(ts))
    a = np.abs(port_from_jax - jflows[1]).max()
    b = np.abs(jax_from_port - tflows[1]).max()
    print(f"clip {ci} iters {iters}: port from tcs_tpu's state {a:.3e} px, tcs_tpu from the "
          f"port's state {b:.3e} px; own carries {np.abs(jflows[1] - tflows[1]).max():.3e}")
    assert a <= FLOW_TOL and b <= FLOW_TOL


@pytest.mark.parametrize("ci", range(CLIPS))
def test_bf16_config_matches_tcs_tpus_bf16(runs, ci):
    """The default config (bf16 conv stacks and pyramid) on both sides:
    rounding in bf16 differs between the two packages' convolutions, so the
    flows are held by their mean, and by their EPE against the ground truth
    on both frames; frame 0's mean is held at what the stage-by-stage
    comparison explains (module docstring)."""
    jflows, tflows, _ = runs.streams("bf16", 5, ci)
    s = runs.clips[ci]
    for t in range(2):
        err = np.abs(jflows[t] - tflows[t])
        gt = s["flow"][t][..., 0]
        epe_j, epe_t = np.abs(jflows[t] - gt).mean(), np.abs(tflows[t] - gt).mean()
        print(f"clip {ci} frame {t}: |dflow| max {err.max():.3e} mean {err.mean():.3e} px; "
              f"EPE tcs_tpu {epe_j:.5f} port {epe_t:.5f} px")
        assert abs(epe_j - epe_t) <= BF16_EPE_TOL
        if t == 0:
            assert err.mean() <= BF16_FRAME0_MEAN_TOL
    assert err.mean() <= BF16_MEAN_TOL


def test_carried_state_beats_reset_as_in_tcs_tpu(runs):
    """tests/test_train.py's claim through both packages (fp32 config, 5
    iterations): frame 1 with its right view's foreground erased, from the
    carried state and from a reset, EPE over the foreground's box, mean over
    the four clips."""
    means = {}
    for pkg, side, frame, zeros in (
            ("tcs_tpu", 0, runs.jax_frame,
             lambda: JaxState.zeros(1, H, W, JaxConfig(**CONFIGS["fp32"]))),
            ("port", 1, runs.port_frame,
             lambda: TemporalState.zeros(1, H, W, ModelConfig(**CONFIGS["fp32"]),
                                         device="cpu"))):
        errs = {"carried": [], "reset": []}
        for ci, s in enumerate(runs.clips):
            carried = runs.streams("fp32", 5, ci)[2][side]  # after the clean frame 0
            img2, (y0, y1, x0, x1) = _occlude(s, 1)
            for key, state in (("carried", carried), ("reset", zeros())):
                flow, _ = frame("fp32", 5, ci, 1, state, img2)
                errs[key].append(float(np.abs(flow - s["flow"][1][..., 0])[y0:y1, x0:x1].mean()))
        means[pkg] = {k: float(np.mean(v)) for k, v in errs.items()}
        print(f"{pkg}: carried {means[pkg]['carried']:.4f} px, reset "
              f"{means[pkg]['reset']:.4f} px (per clip {errs})")
    assert means["port"]["carried"] < means["port"]["reset"]
    for k in ("carried", "reset"):
        assert abs(means["port"][k] - means["tcs_tpu"][k]) <= CLAIM_TOL, k


def test_port_reads_the_fixture(runs):
    """The port's reader gives the weights tcs_tpu's reader gives."""
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, runs.jax_params()))
    got = runs.port("fp32").state_dict()
    assert sorted(got) == sorted(want)
    assert sum(v.numel() for v in got.values()) == 16_735_005
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_tcs_tpu_reads_what_the_port_writes(runs, tmp_path):
    path = str(tmp_path / "params.npz")
    save_params_npz(runs.port("fp32"), path)
    with np.load(path) as mine, np.load(FIXTURE) as theirs:
        assert sorted(mine.files) == sorted(theirs.files)
        for k in theirs.files:
            assert mine[k].dtype == np.float16
            assert np.array_equal(mine[k].view(np.uint16), theirs[k].view(np.uint16)), k
    back = jax_load_params_npz(path, runs.jax_target())
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    want = dict((jax.tree_util.keystr(k), v) for k, v in
                jax.tree_util.tree_leaves_with_path(runs.jax_params()))
    assert len(flat_back) == len(want)
    for k, v in flat_back:
        assert np.array_equal(np.asarray(v), np.asarray(want[jax.tree_util.keystr(k)]))


def test_reader_is_strict(tmp_path):
    """A key the model lacks, or one the file lacks, raises and is named."""
    cfg = ModelConfig(**CONFIGS["fp32"])
    with np.load(FIXTURE) as data:
        arrays = {k: data[k] for k in data.files}
    gone = "['params']['cnet']['conv1']['Conv_0']['bias']"
    extra = "['params']['cnet']['conv9']['Conv_0']['bias']"
    for name, edit in (("missing", lambda a: a.pop(gone)),
                       ("extra", lambda a: a.__setitem__(extra, a[gone]))):
        edited = dict(arrays)
        edit(edited)
        path = str(tmp_path / f"{name}.npz")
        np.savez(path, **edited)
        with pytest.raises(KeyError) as raised:
            load_params_npz(TCStereo(cfg, device="cpu"), path)
        assert (extra if name == "extra" else gone) in raised.value.args[0]


def test_params_from_state_dict_inverts_state_dict_from_jax(runs):
    """The fixture's tree through both converters, bit for bit."""
    tree = jax.tree_util.tree_map(np.asarray, runs.jax_params())
    back = params_from_state_dict(state_dict_from_jax(tree))
    a = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(tree)}
    b = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(back)}
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
