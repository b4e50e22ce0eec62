"""The training side of the port's data against tcs_tpu, and the host core
(``tcs_tpu_torch/csrc/host_io.c``) against its numpy versions, on inputs made
from a seed.

Bounds, with the largest reading measured on an 8-core x86 CPU beside each:
- PNG: the host core's unfiltering equals ``png._unfilter_diagonals`` and
  ``read_png`` equals tcs_tpu's libpng reader bit for bit, for every row
  filter and mixes of them, bit depths 8 and 16, gray, gray+alpha, RGB,
  RGBA and palette (measured: equal);
- the resize: the host core equals ``resize_bilinear_plain`` bit for bit
  (equal); the colour jitter: within 1 uint8 level, on under 2 % of the
  values, as ``tests/test_data.py`` holds tcs_tpu's own core (measured:
  equal on these inputs; 1 level on under 1e-5 of a 540x960 stack);
- the augmentors, ``load_sample`` and ``load_pair`` with tcs_tpu's native
  dispatch off and the port's plain versions in place of its core: equal to
  tcs_tpu's numpy path (images, flow, valid and K: equal); with both cores
  on: images within 1 level and within 1e-3 on all but 2 % of the values
  (measured: 0.74 at most, 0.05 % beyond 1e-3), flow within 1e-4 px
  (3.9e-5), the sparse valid mask equal (equal);
- datasets, ``fetch_dataset``, the loader and the pose tool: indices, K,
  baselines and lengths equal; batches equal; poses within 1e-9 (equal).

Nothing here compiles a JAX program: tcs_tpu's data side is numpy.
"""

import os
import shutil
import signal
import struct
import time
import zlib

import numpy as np
import pytest
import torch

from tcs_tpu.data import augmentor as jax_aug
from tcs_tpu.data import datasets as jax_datasets
from tcs_tpu.data import frame_utils as jax_fu
from tcs_tpu.data import loader as jax_loader
from tcs_tpu.data import native_io
from tcs_tpu_torch.config import TrainConfig
from tcs_tpu_torch.data import (_host, augmentor, datasets, fabricate, frame_utils,
                                kitti_raw_pose, loader, png)
from tools import preprocess_kitti_raw_pose as jax_pose_tool

# The test processes share the host: two intra-op threads each, so that
# several workers do not oversubscribe its cores.
torch.set_num_threads(2)

H, W = 23, 37  # odd sizes: rows of every length
JITTER_SHARE = 0.02  # of the values that may round to the other uint8 level
IMAGE_TOL, IMAGE_SHARE = 1e-3, 0.02  # images, both cores on: a float32 resize against float64
FLOW_TOL = 1e-4  # px, both cores on
CROP = (32, 64)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

PNG_KINDS = {  # name: (colour type, bit depth, samples per pixel)
    "gray8": (0, 8, 1), "gray16": (0, 16, 1), "gray_alpha8": (4, 8, 2),
    "gray_alpha16": (4, 16, 2), "rgb8": (2, 8, 3), "rgb16": (2, 16, 3),
    "rgba8": (6, 8, 4), "rgba16": (6, 16, 4), "palette8": (3, 8, 1)}
FILTER_MIXES = [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4), (4, 3, 1, 2, 0, 4)]


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _png_file(path, kind, filters, seed):
    """A PNG of ``kind`` whose row r is filtered with ``filters[r % len]``;
    returns its (filter byte + bytes) rows and bytes per pixel."""
    color, depth, ch = PNG_KINDS[kind]
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    smooth = (0.5 + 0.4 * np.sin(xx / 5.0 + yy / 7.0))[..., None] * np.ones(ch)
    top = 2 ** depth - 1 if color != 3 else 15
    arr = np.clip(smooth * top + rng.integers(-top // 8, top // 8 + 1, (H, W, ch)), 0, top)
    arr = arr.astype(np.uint16 if depth == 16 else np.uint8)
    rows = arr.astype(">u2") if depth == 16 else arr
    rows = np.ascontiguousarray(rows).view(np.uint8).reshape(H, -1).astype(np.int32)
    bpp = rows.shape[1] // W
    out = []
    for r in range(H):
        k = filters[r % len(filters)]
        cur, prev = rows[r], rows[r - 1] if r else np.zeros_like(rows[0])
        a = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        p = a + prev - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        pred = [0 * cur, a, prev, (a + prev) // 2, paeth][k]
        out.append(np.concatenate([[k], (cur - pred) % 256]).astype(np.uint8))
    raw = np.stack(out)
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, color, 0, 0, 0))
    if color == 3:
        body += _chunk(b"PLTE", rng.integers(0, 256, (16, 3), dtype=np.uint8).tobytes())
    body += _chunk(b"IDAT", zlib.compress(raw.tobytes())) + _chunk(b"IEND", b"")
    path.write_bytes(png.SIGNATURE + body)
    return raw, bpp


@pytest.mark.parametrize("filters", FILTER_MIXES, ids=lambda f: "".join(map(str, f)))
@pytest.mark.parametrize("kind", list(PNG_KINDS))
def test_png_host_core_matches_numpy_and_tcs_tpu(tmp_path, kind, filters):
    path = tmp_path / f"{kind}.png"
    raw, bpp = _png_file(path, kind, filters, seed=31 * len(filters) + list(PNG_KINDS).index(kind))
    want = png._unfilter_diagonals(raw[:, 1:], raw[:, 0], bpp)
    assert np.array_equal(_host.png_unfilter(raw, bpp), want)
    assert np.array_equal(png.read_png(path), native_io.read_png(str(path)))
    if PNG_KINDS[kind][0] != 4:  # tcs_tpu's read_image keeps gray+alpha as 2 channels
        assert np.array_equal(frame_utils.read_image(path), jax_fu.read_image(str(path)))


def test_png_writer_filters_and_refusals(tmp_path):
    rng = np.random.default_rng(3)
    for arr in (rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
                rng.integers(0, 65536, (H, W), dtype=np.uint16)):
        for f in ("none", "paeth"):
            png.write_png(tmp_path / "w.png", arr, filter=f)
            assert np.array_equal(png.read_png(tmp_path / "w.png"), arr)
            assert np.array_equal(native_io.read_png(str(tmp_path / "w.png")), arr)
    with pytest.raises(ValueError, match="filter"):
        png.write_png(tmp_path / "w.png", arr, filter="up")
    raw = np.zeros((2, 7), np.uint8)
    raw[1, 0] = 5
    with pytest.raises(ValueError, match="unknown row filter 5 in row 1"):
        _host.png_unfilter(raw, 3)


def test_host_core_build_raises_without_a_compiler(monkeypatch, tmp_path):
    """A missing compiler is an error, never a silent switch to numpy."""
    monkeypatch.setattr(_host, "_lib", None)
    monkeypatch.setattr(_host, "_BUILD", tmp_path)
    monkeypatch.setattr(_host.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="no host C compiler"):
        _host.lib()


def test_host_core_build_failure_names_the_cause(monkeypatch, tmp_path):
    bad = tmp_path / "host_io.c"
    bad.write_text("int broken(")
    monkeypatch.setattr(_host, "_lib", None)
    monkeypatch.setattr(_host, "_BUILD", tmp_path / "build")
    monkeypatch.setattr(_host, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="building the host core failed"):
        _host.lib()


# ---------------------------------------------------------------------------
# Host core against its numpy versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,out", [((23, 37, 3), (31, 52)), ((40, 60, 1), (29, 44)),
                                       ((17, 19), (40, 11)), ((5, 8, 3), (5, 8))])
def test_resize_host_core_is_the_plain_resize(shape, out):
    rng = np.random.default_rng(sum(out))
    img = rng.uniform(-50, 300, shape).astype(np.float32)
    got = _host.resize_bilinear(img, *out)
    assert got.dtype == np.float64
    assert np.array_equal(got, augmentor.resize_bilinear_plain(img, *out))
    ones = _host.resize_bilinear(np.ones(shape, np.float32), *out)
    assert (ones == 1.0).all()  # the sparse valid mask's == 1.0 test keeps every pixel


@pytest.mark.parametrize("seed", range(6))
def test_color_jitter_host_core_against_plain(seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    order = rng.permutation(4)
    factors = [rng.uniform(0.6, 1.4), rng.uniform(0.6, 1.4), rng.uniform(0.0, 1.4),
               rng.uniform(-0.16, 0.16)]
    gamma, gain = (1.0, 1.0) if seed % 2 else (rng.uniform(0.8, 1.2), rng.uniform(0.9, 1.1))
    got = _host.color_jitter(img, order, factors, gamma, gain)
    want = augmentor.color_jitter_plain(img, order, factors, gamma, gain)
    d = np.abs(got.astype(np.int16) - want)
    assert d.max() <= 1 and (d > 0).mean() < JITTER_SHARE, (d.max(), (d > 0).mean())


# ---------------------------------------------------------------------------
# Augmentors against tcs_tpu
# ---------------------------------------------------------------------------

@pytest.fixture
def plain_paths(monkeypatch):
    """tcs_tpu's native dispatch off, the port's plain versions in place of
    its host core: both sides run the same numpy."""
    monkeypatch.setattr(native_io, "available", lambda: False)
    monkeypatch.setattr(native_io, "has_color_jitter", lambda: False)
    monkeypatch.setattr(augmentor, "resize_bilinear", augmentor.resize_bilinear_plain)
    monkeypatch.setattr(augmentor, "color_jitter", augmentor.color_jitter_plain)


def _clip(seed, T=2, h=60, w=90, sparse=False):
    """Frames of a two-plane scene with noise, its flow and valid mask."""
    rng = np.random.default_rng(seed)
    left, right, disp, _ = fabricate.scene(rng, T, h, w, fx=100.0, baseline=0.5)
    valid = np.ones((T, h, w, 1), np.float32)
    if sparse:
        valid = (rng.random((T, h, w, 1)) < 0.8).astype(np.float32)
        disp = disp * valid[..., 0]
    K = np.array([[100.0, 0, w / 2], [0, 100.0, h / 2], [0, 0, 1]])
    return left, right, -disp[..., None].astype(np.float32), valid, K


AUGMENTORS = {  # name: (class name, constructor keywords, attributes set after, sparse input)
    "dense": ("TemporalFlowAugmentor", {}, {}, False),
    "dense_unscaled": ("TemporalFlowAugmentor", {}, {"spatial_aug_prob": 0.0}, False),
    "dense_yjitter": ("TemporalFlowAugmentor", {"yjitter": True}, {}, False),
    "sparse": ("TemporalSparseFlowAugmentor", {}, {}, True),
    "sparse_unscaled": ("TemporalSparseFlowAugmentor", {}, {"spatial_aug_prob": 0.0}, True),
    "pair_flip_h": ("FlowAugmentor", {"do_flip": "h", "yjitter": True}, {}, False),
    "pair_flip_hf": ("FlowAugmentor", {"do_flip": "hf"}, {}, False),
    "pair_flip_v": ("FlowAugmentor", {"do_flip": "v"}, {"v_flip_prob": 1.0}, False),
    "pair_sparse_flip_hf": ("SparseFlowAugmentor", {"do_flip": "hf"}, {}, True),
    "pair_sparse_flip_v": ("SparseFlowAugmentor", {"do_flip": "v"}, {"v_flip_prob": 1.0,
                                                                      "spatial_aug_prob": 0.5},
                           True),
}


def _augment(mod, name, seed):
    cls, kw, attrs, sparse = AUGMENTORS[name]
    aug = getattr(mod, cls)(crop_size=CROP, min_scale=-0.2, max_scale=0.4, **kw)
    for k, v in attrs.items():
        setattr(aug, k, v)
    s1, s2, flow, valid, K = _clip(seed, T=1 if cls in ("FlowAugmentor", "SparseFlowAugmentor")
                                   else 2, sparse=sparse)
    return aug(s1, s2, flow, valid, K, np.random.default_rng(seed))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", list(AUGMENTORS))
def test_augmentor_plain_path_is_tcs_tpus(plain_paths, name, seed):
    ours, theirs = _augment(augmentor, name, seed), _augment(jax_aug, name, seed)
    assert ours[0].shape == (1 if name.startswith("pair") else 2, *CROP, 3)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", list(AUGMENTORS))
def test_augmentor_host_core_against_tcs_tpus_core(name, seed):
    assert native_io.available() and native_io.has_color_jitter()
    (i1, i2, f, v, K), (j1, j2, jf, jv, jK) = (_augment(augmentor, name, seed),
                                              _augment(jax_aug, name, seed))
    for a, b in ((i1, j1), (i2, j2)):
        d = np.abs(a - b)
        assert d.max() <= 1.0 and (d > IMAGE_TOL).mean() < IMAGE_SHARE, (d.max(),
                                                                        (d > IMAGE_TOL).mean())
    assert np.abs(f - jf).max() <= FLOW_TOL
    assert np.array_equal(v, jv) and np.array_equal(K, jK)


def test_resize_sparse_flow_map_is_tcs_tpus():
    _, _, flow, valid, _ = _clip(4, T=1, sparse=True)
    for fx, fy in ((1.3, 1.3), (0.8, 0.8), (1.07, 0.93)):
        for a, b in zip(augmentor.resize_sparse_flow_map(flow[0], valid[0], fx, fy),
                        jax_aug.resize_sparse_flow_map(flow[0], valid[0], fx, fy)):
            assert np.array_equal(a, b)


def test_temporal_augmentors_refuse_flips():
    for cls in (augmentor.TemporalFlowAugmentor, augmentor.TemporalSparseFlowAugmentor):
        with pytest.raises(ValueError, match="do_flip"):
            cls(crop_size=CROP, do_flip="hf")
    with pytest.raises(ValueError, match="do_flip"):
        augmentor.FlowAugmentor(crop_size=CROP, do_flip="x")


# ---------------------------------------------------------------------------
# Datasets, fetch_dataset and the loader
# ---------------------------------------------------------------------------

def _single_pair_trees(root):
    """Small SintelStereo, ETH3D, Middlebury and FallingThings trees."""
    rng = np.random.default_rng(11)
    img = lambda: rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)  # noqa: E731
    for p in ("training/clean_left/alley_1", "training/clean_right/alley_1",
              "training/disparities/alley_1", "training/occlusions/alley_1"):
        os.makedirs(os.path.join(root, "SintelStereo", p), exist_ok=True)
    for i in range(2):
        f = f"frame_{i + 1:04d}.png"
        png.write_png(os.path.join(root, "SintelStereo/training/clean_left/alley_1", f), img())
        png.write_png(os.path.join(root, "SintelStereo/training/clean_right/alley_1", f), img())
        png.write_png(os.path.join(root, "SintelStereo/training/disparities/alley_1", f), img())
        png.write_png(os.path.join(root, "SintelStereo/training/occlusions/alley_1", f),
                      (rng.random((24, 40)) < 0.1).astype(np.uint8) * 255)
    for scene in ("delivery_area_1l", "electro_1l"):
        for d in ("two_view_training", "two_view_training_gt"):
            os.makedirs(os.path.join(root, "ETH3D", d, scene), exist_ok=True)
        png.write_png(os.path.join(root, "ETH3D/two_view_training", scene, "im0.png"), img())
        png.write_png(os.path.join(root, "ETH3D/two_view_training", scene, "im1.png"), img())
        disp = rng.uniform(1, 30, (24, 40)).astype(np.float32)
        disp[rng.random((24, 40)) < 0.2] = np.inf
        frame_utils.writePFM(os.path.join(root, "ETH3D/two_view_training_gt", scene,
                                          "disp0GT.pfm"), disp)
    for name in ("Adirondack", "Jadeplant"):
        # the scene names come from trainingF whatever the split (tcs_tpu :584)
        os.makedirs(os.path.join(root, "Middlebury/MiddEval3/trainingF", name), exist_ok=True)
        base = os.path.join(root, "Middlebury/MiddEval3/trainingH", name)
        os.makedirs(base, exist_ok=True)
        png.write_png(os.path.join(base, "im0.png"), img())
        png.write_png(os.path.join(base, "im1.png"), img())
        frame_utils.writePFM(os.path.join(base, "disp0GT.pfm"),
                             rng.uniform(1, 30, (24, 40)).astype(np.float32))
        png.write_png(os.path.join(base, "mask0nocc.png"),
                      (rng.random((24, 40)) < 0.8).astype(np.uint8) * 255)
    # JPEG frames through the port's encoder, depth in FallingThings' unit
    fabricate.falling_things_tree(root, scenes=("single",), frames=2, height=24, width=40)
    with open(os.path.join(root, "FallingThings/filenames.txt"), "w") as f:  # unsorted
        f.write("fat/single/000001.left.jpg\nfat/single/000000.left.jpg\n")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_trees"))
    fabricate.sceneflow_train_tree(root, frames=4, height=48, width=72)
    fabricate.tartanair_train_tree(root, frames=5, height=48, width=72)
    fabricate.tartanair_tree(root, sequences=(("gascola", "Easy", "P001"),), frames=3,
                             height=48, width=72)  # a held-out video, left out of training
    fabricate.kitti_raw_tree(root, frames=5, height=48, width=96)
    kitti_raw_pose.main(["--root", os.path.join(root, "kitti_raw")])
    _single_pair_trees(root)
    return root


def _cfg(trees, name, **kw):
    return TrainConfig(train_dataset=name, data_root=trees, image_size=CROP, **kw)


RECIPE_CASES = {  # name: (train_dataset, TrainConfig keywords)
    "sceneflow": ("sceneflow", {}),
    "sceneflow_fl3": ("sceneflow", {"frame_length": 3}),
    "sceneflow_single": ("sceneflow", {"temporal": False, "frame_length": 1}),
    "TartanAir_fl4": ("TartanAir", {"frame_length": 4, "saturation_range": (0.0, 1.4)}),
    "TartanAir_single": ("TartanAir", {"temporal": False, "frame_length": 1}),
    "kitti_raw_fl4": ("kitti_raw", {"frame_length": 4, "saturation_range": (0.7, 1.3),
                                    "spatial_scale": (-0.2, 0.2)}),
    "sintel_eth3d": ("sintel_stereo+eth3d", {"temporal": False, "frame_length": 1}),
    "middlebury_falling": ("middlebury_H+falling_things", {"temporal": False,
                                                           "frame_length": 1}),
}


def _index(ds):
    """Every list the dataset indexes, and its K and baselines."""
    if hasattr(ds, "parts"):
        return [ds.baseline, len(ds)] + [_index(p) for p in ds.parts]
    K = ds.intrinsic_K if isinstance(ds.intrinsic_K, list) else [ds.intrinsic_K]
    return [len(ds), ds.image_list, ds.disparity_list, ds.flow_list, ds.baseline,
            [np.asarray(k).tolist() if k is not None else None for k in K],
            [[np.asarray(p).tolist() for p in poses] for poses in ds.pose_list],
            type(ds.augmentor).__name__, ds.temporal, ds.sparse]


@pytest.mark.parametrize("case", list(RECIPE_CASES))
def test_fetch_dataset_matches_tcs_tpu(trees, case):
    from tcs_tpu.config import TrainConfig as JaxTrainConfig

    name, kw = RECIPE_CASES[case]
    ours = datasets.fetch_dataset(_cfg(trees, name, **kw))
    theirs = jax_datasets.fetch_dataset(JaxTrainConfig(train_dataset=name, data_root=trees,
                                                       image_size=CROP, **kw))
    assert len(ours) > 0
    assert _index(ours) == _index(theirs)


LOAD_CASES = ("sceneflow", "TartanAir_fl4", "kitti_raw_fl4", "sceneflow_single",
              "sintel_eth3d", "middlebury_falling")


@pytest.mark.parametrize("case", LOAD_CASES)
def test_load_sample_plain_path_is_tcs_tpus(trees, plain_paths, case):
    from tcs_tpu.config import TrainConfig as JaxTrainConfig

    name, kw = RECIPE_CASES[case]
    ours = datasets.fetch_dataset(_cfg(trees, name, **kw))
    theirs = jax_datasets.fetch_dataset(JaxTrainConfig(train_dataset=name, data_root=trees,
                                                       image_size=CROP, **kw))
    if case == "sceneflow_single":
        # tcs_tpu reads a K that single SceneFlow pairs do not have
        # (datasets.py:149); the port drops it, as the pair's K is dropped
        with pytest.raises(IndexError):
            theirs.load_sample(0, np.random.default_rng(0))
        for part in theirs.parts:
            part.intrinsic_K = None
    # every single-pair sample: FallingThings' JPEG ones and Middlebury's
    picks = (range(len(ours)) if case == "middlebury_falling"
             else np.random.default_rng(0).choice(len(ours), min(3, len(ours)), replace=False))
    for i in picks:
        a = ours.load_sample(int(i), np.random.default_rng((5, int(i))))
        b = theirs.load_sample(int(i), np.random.default_rng((5, int(i))))
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (i, k)


def test_single_pair_readers_match_tcs_tpu(trees):
    sintel = os.path.join(trees, "SintelStereo/training/disparities/alley_1/frame_0001.png")
    mid = os.path.join(trees, "Middlebury/MiddEval3/trainingH/Adirondack/disp0GT.pfm")
    for ours, theirs, path in ((frame_utils.readDispSintelStereo, jax_fu.readDispSintelStereo,
                                sintel),
                               (frame_utils.readDispMiddlebury, jax_fu.readDispMiddlebury, mid)):
        for a, b in zip(ours(path), theirs(path)):
            assert np.array_equal(a, b)
    ft = os.path.join(trees, "FallingThings/fat/readers")  # beside the dataset's files
    os.makedirs(ft, exist_ok=True)
    png.write_png(os.path.join(ft, "000000.left.depth.png"),
                  np.random.default_rng(2).integers(1, 60000, (24, 40)).astype(np.uint16))
    with open(os.path.join(ft, "_camera_settings.json"), "w") as f:
        f.write('{"camera_settings": [{"intrinsic_settings": {"fx": 768.2}}]}')
    path = os.path.join(ft, "000000.left.depth.png")
    for a, b in zip(frame_utils.readDispFallingThings(path), jax_fu.readDispFallingThings(path)):
        assert np.array_equal(a, b)


def test_loader_batches_are_tcs_tpus(trees, plain_paths):
    cfg = _cfg(trees, "TartanAir", frame_length=3)
    ours = loader.SequenceLoader(datasets.fetch_dataset(cfg), 2, seed=9, num_workers=0)
    from tcs_tpu.config import TrainConfig as JaxTrainConfig

    theirs = jax_loader.SequenceLoader(jax_datasets.fetch_dataset(JaxTrainConfig(
        train_dataset="TartanAir", data_root=trees, image_size=CROP, frame_length=3)),
        2, seed=9, num_workers=2)
    assert len(ours) == len(theirs)
    for epoch in (1, 2):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        idx = ours.batch_indices()
        for k, (a, b) in enumerate(zip(ours, theirs)):
            assert np.array_equal(a["index"], idx[k])
            for key in b:
                assert np.array_equal(a[key], b[key]), (epoch, k, key)
            if k == 3:
                break


def test_loader_shards_partition_the_padded_epoch(trees):
    ds = datasets.fetch_dataset(_cfg(trees, "kitti_raw", frame_length=2))
    n = len(ds)
    for shards in (1, 3, 4):
        parts = [loader.SequenceLoader(ds, 1, seed=2, shard_id=s, num_shards=shards)
                 for s in range(shards)]
        per = -(-n // shards)
        got = [p._epoch_indices(3) for p in parts]
        assert all(len(g) == per for g in got)
        together = np.concatenate(got)
        assert sorted(set(together.tolist())) == list(range(n))
        assert len(together) == per * shards  # padding repeats the first few
        theirs = [jax_loader.SequenceLoader(ds, 1, seed=2, shard_id=s, num_shards=shards)
                  for s in range(shards)]
        for t in theirs:
            t.set_epoch(3)
        assert all(np.array_equal(a, t._epoch_indices()) for a, t in zip(got, theirs))


def test_loader_gives_the_same_batches_for_any_number_of_workers(trees):
    ds = datasets.fetch_dataset(_cfg(trees, "sceneflow"))
    runs = {}
    for workers in (0, 1, 3):
        with loader.SequenceLoader(ds, 3, seed=4, num_workers=workers, prefetch=2) as ld:
            batches = ld.stream(2, start_batch=1)
            runs[workers] = [next(batches) for _ in range(4)]
            batches.close()
    assert [(e, k) for e, k, _ in runs[0]] == [(2, 1), (2, 2), (2, 3), (2, 4)]
    for workers in (1, 3):
        for (e, k, a), (f, j, b) in zip(runs[0], runs[workers]):
            assert (e, k) == (f, j) and a.keys() == b.keys()
            assert all(np.array_equal(a[key], b[key]) for key in a)


def test_loader_starts_at_the_batch_it_is_given(trees):
    ds = datasets.fetch_dataset(_cfg(trees, "TartanAir", frame_length=2))
    ld = loader.SequenceLoader(ds, 4, seed=1, num_workers=0)
    ld.set_epoch(5)
    whole = [b["index"].tolist() for b in ld]
    ld.set_epoch(6)
    following = [b["index"].tolist() for b in ld]
    n = len(ld)
    batches = ld.stream(5, start_batch=7)
    resumed = [next(batches) for _ in range(n - 7 + 2)]
    batches.close()
    assert [(e, k) for e, k, _ in resumed] == [(5, k) for k in range(7, n)] + [(6, 0), (6, 1)]
    assert [b["index"].tolist() for *_, b in resumed] == whole[7:] + following[:2]
    batches = ld.stream(5, start_batch=n)  # the epoch was done: the next one
    assert next(batches)[:2] == (6, 0)
    batches.close()
    with pytest.raises(ValueError, match="batch"):
        ld.stream(5, start_batch=n + 1)


def _ignores(pid: int, signum: int) -> bool:
    with open(f"/proc/{pid}/status") as f:
        mask = int(next(line for line in f if line.startswith("SigIgn:")).split()[1], 16)
    return bool(mask >> (signum - 1) & 1)


def test_workers_outlive_a_signal_to_the_process_group(trees):
    """A preemption that signals the whole group (a job scheduler, Ctrl-C)
    reaches the workers too; they ignore it, and the consumer goes on to
    checkpoint on its own batches and then shuts them down."""
    ds = datasets.fetch_dataset(_cfg(trees, "TartanAir", frame_length=2))
    with loader.SequenceLoader(ds, 1, seed=3, num_workers=2, prefetch=1) as ld:
        batches = ld.stream(0)
        next(batches)
        pids = list(ld._pool._processes)
        deadline = time.time() + 60
        while not all(_ignores(p, s) for p in pids for s in (signal.SIGTERM, signal.SIGINT)):
            assert time.time() < deadline, "a worker still takes SIGTERM or SIGINT"
            time.sleep(0.05)
        for pid in pids:
            os.kill(pid, signal.SIGTERM)
            os.kill(pid, signal.SIGINT)
        assert [next(batches)[1] for _ in range(3)] == [1, 2, 3]
        assert all(p.is_alive() for p in ld._pool._processes.values())
        batches.close()


class FailingDataset:
    """Sample 3 cannot be read."""

    def __len__(self):
        return 8

    def load_sample(self, index, rng):
        if index == 3:
            raise OSError("sample 3 is unreadable")
        return {"x": np.full(2, index, np.float32)}


@pytest.mark.parametrize("workers", [0, 2])
def test_a_workers_error_reaches_the_consumer(workers):
    with loader.SequenceLoader(FailingDataset(), 2, seed=0, num_workers=workers) as ld:
        ld.set_epoch(0)
        with pytest.raises(OSError, match="sample 3 is unreadable"):
            for _ in ld:
                pass


def test_batch_goes_to_the_device_as_a_sequence_batch(trees):
    from tcs_tpu_torch.train import SequenceBatch

    ds = datasets.fetch_dataset(_cfg(trees, "TartanAir", frame_length=2))
    ld = loader.SequenceLoader(ds, 2, num_workers=0)
    ld.set_epoch(1)
    batch = next(iter(ld))
    sb = SequenceBatch.from_loader(batch, "cpu")
    assert sb.image1.shape == (2, 2, *CROP, 3) and sb.baseline.shape == (2,)
    assert all(torch.equal(getattr(sb, k), torch.from_numpy(batch[k]))
               for k in ("image1", "image2", "flow", "valid", "T", "K", "baseline"))


# ---------------------------------------------------------------------------
# KITTI raw poses
# ---------------------------------------------------------------------------

def test_kitti_raw_poses_match_the_reference_tool(trees, tmp_path):
    day = os.path.join(trees, "kitti_raw", "2011_09_26")
    copy = tmp_path / "2011_09_26"
    shutil.copytree(day, copy, ignore=shutil.ignore_patterns("*.png"))
    jax_pose_tool.process_scene(str(copy))
    seqs = sorted(d for d in os.listdir(day) if d.endswith("_sync"))
    assert len(seqs) == 2
    for seq in seqs:
        ours = np.loadtxt(os.path.join(day, seq, "pose.txt"))
        theirs = np.loadtxt(copy / seq / "pose.txt")
        assert ours.shape == (5, 12) and np.abs(ours - theirs).max() <= 1e-9
