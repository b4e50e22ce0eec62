"""The port's data side against PIL and tcs_tpu, on files made from a seed.

The PNG codec (``tcs_tpu_torch/data/png.py``) is held to PIL bit for bit:
files PIL writes (it picks its row filters itself), files written here with
each row filter on purpose, and round trips both ways. The readers, pose
parsers and test datasets are held to ``tcs_tpu.data`` on the same files.
Nothing here compiles a JAX program.
"""

import dataclasses
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from tcs_tpu.data import datasets as jax_datasets
from tcs_tpu.data import frame_utils as jax_fu
from tcs_tpu_torch.data import datasets, fabricate, frame_utils, png

Image = pytest.importorskip("PIL.Image")

# The test processes share the host: two intra-op threads each, so that
# several workers do not oversubscribe its cores.
torch.set_num_threads(2)

H, W = 24, 37  # odd width: rows of every length


def _image(mode, seed=0):
    """A smooth image with noise (PIL then picks a mix of row filters)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    smooth = 100 + 60 * np.sin(xx / 5.0)[..., None] + 40 * np.cos(yy / 4.0)[..., None]
    ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    img = smooth + rng.integers(-20, 20, size=(H, W, ch)) + 30 * np.arange(ch)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if ch == 1 else img


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _encode(arr, depth, color, filters, interlace=0):
    """A PNG whose row r carries filter ``filters[r % len(filters)]``."""
    rows = np.ascontiguousarray(arr.astype(">u2") if depth == 16 else arr)
    rows = rows.view(np.uint8).reshape(arr.shape[0], -1).astype(np.int32)
    bpp = rows.shape[1] // arr.shape[1]
    out = []
    for r in range(rows.shape[0]):
        kind = filters[r % len(filters)]
        cur = rows[r]
        prev = rows[r - 1] if r else np.zeros_like(cur)
        a = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if kind == 4:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        else:
            pred = [0 * cur, a, prev, (a + prev) // 2][kind]
        out.append(np.concatenate([[kind], (cur - pred) % 256]).astype(np.uint8))
    header = struct.pack(">IIBBBBB", arr.shape[1], arr.shape[0], depth, color, 0, 0, interlace)
    return (png.SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(np.concatenate(out).tobytes()))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "I;16", "P"])
def test_png_reads_what_pil_writes(tmp_path, mode):
    path = tmp_path / "x.png"
    if mode == "I;16":
        arr = np.random.default_rng(1).integers(0, 65536, size=(H, W)).astype(np.uint16)
        Image.fromarray(arr).save(path)
    elif mode == "P":
        Image.fromarray(_image("RGB")).quantize(colors=50).save(path)
    else:
        Image.fromarray(_image(mode), mode).save(path)
    got = png.read_png(path)
    want = np.asarray(Image.open(path).convert("RGB") if mode == "P" else Image.open(path))
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4), (4, 2, 3, 1)])
@pytest.mark.parametrize("kind", ["rgb8", "gray16", "rgba8"])
def test_png_undoes_every_row_filter(tmp_path, filters, kind):
    rng = np.random.default_rng(len(filters) * 7 + filters[0])
    if kind == "gray16":
        arr, depth, color = rng.integers(0, 65536, size=(H, W)).astype(np.uint16), 16, 0
    else:
        ch, color = (3, 2) if kind == "rgb8" else (4, 6)
        arr, depth = rng.integers(0, 256, size=(H, W, ch)).astype(np.uint8), 8
    path = tmp_path / "f.png"
    path.write_bytes(_encode(arr, depth, color, filters))
    assert np.array_equal(np.asarray(Image.open(path)), arr)  # the file is a valid PNG
    assert np.array_equal(png.read_png(path), arr)


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "gray16"])
def test_png_round_trips_through_pil(tmp_path, kind):
    rng = np.random.default_rng(5)
    arr = {"gray8": lambda: rng.integers(0, 256, (H, W)).astype(np.uint8),
           "rgb8": lambda: rng.integers(0, 256, (H, W, 3)).astype(np.uint8),
           "gray16": lambda: rng.integers(0, 65536, (H, W)).astype(np.uint16)}[kind]()
    png.write_png(tmp_path / "port.png", arr)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "port.png")), arr)
    Image.fromarray(arr).save(tmp_path / "pil.png")
    assert np.array_equal(png.read_png(tmp_path / "pil.png"), arr)


def test_png_refuses_what_it_does_not_read(tmp_path):
    arr = np.zeros((4, 5, 3), np.uint8)
    path = tmp_path / "interlaced.png"
    path.write_bytes(_encode(arr, 8, 2, (0,), interlace=1))
    with pytest.raises(ValueError, match="interlaced.png.*interlaced"):
        png.read_png(path)
    Image.fromarray(np.eye(8, dtype=bool)).save(tmp_path / "bits.png")  # 1-bit gray
    with pytest.raises(ValueError, match="bits.png.*bit depth 1"):
        png.read_png(tmp_path / "bits.png")
    with pytest.raises(ValueError, match="cannot write"):
        png.write_png(tmp_path / "f.png", np.zeros((4, 5), np.float32))
    (tmp_path / "x.jpg").write_bytes(b"\xff\xd8")  # a JPEG cut after its first marker
    with pytest.raises(IOError, match="x.jpg.*truncated JPEG"):
        frame_utils.read_image(tmp_path / "x.jpg")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Images, ground truth and pose files, each written once."""
    d = tmp_path_factory.mktemp("files")
    rng = np.random.default_rng(2)
    for mode in ("L", "LA", "RGB", "RGBA"):
        Image.fromarray(_image(mode, seed=3), mode).save(d / f"{mode}.png")
    Image.fromarray(_image("RGB", seed=4)).quantize(colors=40).save(d / "P.png")
    Image.fromarray(rng.integers(0, 65536, (H, W)).astype(np.uint16)).save(d / "I16.png")
    disp = rng.uniform(0.5, 90, size=(H, W)).astype(np.float32)
    disp[::5, ::3] = 0  # invalid in KITTI's encoding
    frame_utils.writeDispKITTI(str(d / "kitti.png"), disp)
    jax_fu.writePFM(str(d / "jax.pfm"), disp)
    frame_utils.writePFM(str(d / "port.pfm"), disp)
    np.save(d / "depth.npy", rng.uniform(1, 80, size=(H, W)).astype(np.float32))
    q = rng.normal(size=(5, 4))
    t = rng.normal(size=(5, 3)) * 10
    (d / "tartan.txt").write_text("".join(
        " ".join(f"{v:.9g}" for v in (*ti, *qi)) + "\n" for ti, qi in zip(t, q)))
    mats = []
    for _ in range(5):  # cam→world: a rotation and a translation
        m = np.eye(4)
        m[:3, :3], m[:3, 3] = np.linalg.qr(rng.normal(size=(3, 3)))[0], rng.normal(size=3)
        mats.append(m)
    (d / "sceneflow.txt").write_text("".join(
        f"Frame {i}\nL " + " ".join(f"{v:.9g}" for v in m.reshape(-1)) + "\nR "
        + " ".join("0" for _ in range(16)) + "\n\n" for i, m in enumerate(mats)))
    (d / "kitti_pose.txt").write_text("".join(
        " ".join(f"{v:.9g}" for v in m[:3].reshape(-1)) + "\n" for m in mats))
    (d / "calib.txt").write_text("calib_time: 09-Jan-2012 13:57:47\nP_rect_02: "
                                 + " ".join(f"{v}" for v in fabricate.KITTI_P_RECT_02) + "\n")
    return d


@pytest.mark.parametrize("name", ["L.png", "LA.png", "RGB.png", "RGBA.png", "P.png",
                                  "I16.png"])
def test_read_image_matches_tcs_tpu(files, name):
    got = frame_utils.read_image(str(files / name))
    assert got.dtype == np.uint8 and got.shape == (H, W, 3)
    if name == "LA.png":  # tcs_tpu keeps both channels of gray+alpha
        assert np.array_equal(got, np.repeat(_image("LA", seed=3)[..., :1], 3, axis=2))
    else:
        assert np.array_equal(got, jax_fu.read_image(str(files / name)))


def test_disparity_readers_and_writers_match_tcs_tpu(files):
    for a, b in zip(frame_utils.readDispKITTI(str(files / "kitti.png")),
                    jax_fu.readDispKITTI(str(files / "kitti.png"))):
        assert np.array_equal(a, b)
    assert np.array_equal(frame_utils.read_uint16_png(str(files / "I16.png")),
                          jax_fu.read_uint16_png(str(files / "I16.png")))
    for name in ("jax.pfm", "port.pfm"):
        assert np.array_equal(frame_utils.readPFM(str(files / name)),
                              jax_fu.readPFM(str(files / name)))
        assert np.array_equal(frame_utils.read_gen(str(files / name)),
                              jax_fu.read_gen(str(files / name)))
    assert (files / "jax.pfm").read_bytes() == (files / "port.pfm").read_bytes()
    for a, b in zip(frame_utils.readDispTartanAir(str(files / "depth.npy")),
                    jax_fu.readDispTartanAir(str(files / "depth.npy"))):
        assert np.array_equal(a, b)
    for name in ("depth.npy", "RGB.png"):
        assert np.array_equal(frame_utils.read_gen(str(files / name)),
                              jax_fu.read_gen(str(files / name)))


def test_pose_and_calibration_readers_match_tcs_tpu(files):
    for ours, theirs, name in (
            (frame_utils.read_tartanair_extrinsic, jax_fu.read_tartanair_extrinsic, "tartan.txt"),
            (frame_utils.readsceneflow_pose, jax_fu.readsceneflow_pose, "sceneflow.txt"),
            (frame_utils.read_kitti_extrinsic, jax_fu.read_kitti_extrinsic, "kitti_pose.txt")):
        a, b = ours(str(files / name)), theirs(str(files / name))
        assert len(a) == len(b) == 5
        assert max(np.abs(x - y).max() for x, y in zip(a, b)) <= 1e-12
    a = frame_utils.read_calib_file(str(files / "calib.txt"))
    b = jax_fu.read_calib_file(str(files / "calib.txt"))
    assert a.keys() == b.keys() and np.array_equal(a["P_rect_02"], b["P_rect_02"])
    assert np.array_equal(frame_utils.intrinsics_from_p_rect(a["P_rect_02"]),
                          jax_fu.intrinsics_from_p_rect(b["P_rect_02"]))
    q = np.random.default_rng(9).normal(size=4)
    assert np.abs(frame_utils._quat_to_matrix(*q) - jax_fu._quat_to_matrix(*q)).max() <= 1e-12


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("trees"))
    fabricate.tartanair_tree(root, sequences=(("gascola", "Easy", "P001"),
                                              ("gascola", "Easy", "P005"),  # a training video
                                              ("hospital", "Hard", "P042")),
                             frames=3, height=32, width=64)
    fabricate.things_tree(root, scenes=(("A", "0000"), ("B", "0001")), frames=3,
                          height=32, width=64, unposed_trailing_frame=True)
    fabricate.kitti_tree(root, scenes=("000000", "000001"), frames=4, height=32, width=64)
    return root


def _same_sequences(ours, theirs, n):
    assert len(ours) == len(theirs) == n
    for i in range(n):
        a, b = ours.test_sequence(i), theirs.test_sequence(i)
        assert a[:3] == b[:3]  # image and ground-truth paths (KITTI: the scene)
        assert len(a[3]) == len(b[3]) and all(np.array_equal(x, y) for x, y in zip(a[3], b[3]))
        assert np.array_equal(ours.sample_K(i), theirs.sample_K(i), equal_nan=True)
    assert ours.baseline == theirs.baseline


def test_test_datasets_match_tcs_tpu(trees):
    kws = datasets.tartanair_test_keywords()
    assert kws == jax_datasets.tartanair_test_keywords()
    _same_sequences(
        datasets.TartanAir(None, root=trees, scene_list=[], test_keywords=kws,
                           is_test=True, mode="temporal"),
        jax_datasets.TartanAir(None, root=trees, scene_list=[], test_keywords=kws,
                               is_test=True, mode="temporal"), 2)
    ours = datasets.SceneFlowDatasets(None, root=trees, things_test=True, mode="temporal")
    _same_sequences(ours, jax_datasets.SceneFlowDatasets(None, root=trees, things_test=True,
                                                         mode="temporal"), 2)
    # each scene has 4 frames and 3 poses: the trailing frame is dropped
    assert all(len(ours.test_sequence(i)[0]) == 3 for i in range(2))
    kw = dict(root=os.path.join(trees, "KITTI"), is_test=True, mode="temporal",
              image_set="kitti_seq/kitti2015_testings", index_by_scene=True, num_frames=3)
    _same_sequences(datasets.KITTI(None, **kw), jax_datasets.KITTI(None, **kw), 2)


def test_training_side_raises(trees):
    """The training side refuses what tcs_tpu refuses, with the same errors."""
    from tcs_tpu_torch.config import TrainConfig

    for mod in (datasets, jax_datasets):
        with pytest.raises(NotImplementedError):
            mod.KITTI(None, root=trees, is_test=True, mode="single_frame")
        with pytest.raises(NotImplementedError):
            mod.KITTI(None, root=trees, mode="temporal")
        with pytest.raises(ValueError, match="do_flip"):
            mod.TartanAir({"crop_size": (32, 64), "do_flip": "h"}, root=trees, mode="temporal")
        pairs = mod.TartanAir(None, root=trees, mode="single_frame")
        with pytest.raises(AssertionError, match="load_pair"):
            pairs.load_sample(0, np.random.default_rng(0))
    cfg = TrainConfig(data_root=trees, image_size=(32, 64))
    with pytest.raises(NotImplementedError, match="single-frame only"):
        datasets.fetch_dataset(dataclasses.replace(cfg, train_dataset="kitti"))
    with pytest.raises(ValueError, match="frame_length=1"):
        datasets.fetch_dataset(dataclasses.replace(cfg, train_dataset="eth3d"))
    with pytest.raises(ValueError, match="frame_length=1"):
        datasets.fetch_dataset(dataclasses.replace(cfg, temporal=False))


def test_visualization_and_error_maps_match_tcs_tpu(tmp_path):
    from tcs_tpu.utils import logging_utils as jax_logging
    from tcs_tpu.utils import visualization as jax_vis
    from tcs_tpu_torch.utils import logging_utils, visualization as vis

    rng = np.random.default_rng(4)
    disp = rng.uniform(0, 120, size=(H, W)).astype(np.float32)
    gt = np.where(rng.random((H, W)) < 0.2, 0.0, disp + rng.normal(0, 4, (H, W))).astype(np.float32)
    image = rng.integers(0, 256, size=(H, W, 3)).astype(np.uint8)
    K = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]])
    for style in (True, False):
        assert np.array_equal(vis.pseudo_color_map(disp, 0, 96, kitti_style=style),
                              jax_vis.pseudo_color_map(disp, 0, 96, kitti_style=style))
    assert np.array_equal(vis.error_colormap(disp, gt, gt > 0),
                          jax_vis.error_colormap(disp, gt, gt > 0))
    assert np.array_equal(vis.disparity_panel(image, disp, gt),
                          jax_vis.disparity_panel(image, disp, gt))
    for a, b in zip(vis.disparity_to_pointcloud(disp, image, K, 0.5),
                    jax_vis.disparity_to_pointcloud(disp, image, K, 0.5)):
        assert np.array_equal(a, b)
    pts, cols = vis.disparity_to_pointcloud(disp, image, K, 0.5)
    vis.export_ply(str(tmp_path / "port.ply"), pts[:50], cols[:50])
    jax_vis.export_ply(str(tmp_path / "jax.ply"), pts[:50], cols[:50])
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    vis.save_disparity_panel(str(tmp_path / "panel.png"), image, disp, gt)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "panel.png")),
                          jax_vis.disparity_panel(image, disp, gt))
    logging_utils.MetricsLogger().log_error_map("val/e", disp, gt, out_dir=str(tmp_path / "p"))
    jax_logging.MetricsLogger().log_error_map("val/e", disp, gt, out_dir=str(tmp_path / "j"))
    assert np.array_equal(png.read_png(tmp_path / "p" / "val_e_0.png"),
                          png.read_png(tmp_path / "j" / "val_e_0.png"))
