"""The port's Motion-JPEG ``.avi`` (``tcs_tpu_torch/utils/video.py``) against
OpenCV's reader and writer, and ``submit_kitti(submission=False)``, which
writes one such video a scene where ``tcs_tpu`` calls ``cv2.VideoWriter``.
No JAX program is compiled here."""

import os

import cv2
import numpy as np
import pytest
import torch

from tcs_tpu_torch import ModelConfig
from tcs_tpu_torch import evaluate
from tcs_tpu_torch.data import fabricate
from tcs_tpu_torch.data.jpeg import encode_jpeg, read_jpeg
from tcs_tpu_torch.models import TCStereo
from tcs_tpu_torch.utils.video import MJPGWriter, read_avi
from tcs_tpu_torch.utils.visualization import pseudo_color_map

torch.set_num_threads(2)

# Even sizes: OpenCV's FFMPEG writer drops an odd last row (yuvj420p).
SIZES = ((76, 124), (48, 64))


def frames(h: int, w: int, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    return [np.clip(np.stack([128 + 100 * np.sin(x / 9 + k + c) * np.cos(y / 7) for c in range(3)],
                             -1) + rng.normal(0, 8, (h, w, 3)), 0, 255).astype(np.uint8)
            for k in range(n)]


def captured(path) -> tuple:
    """(frame count, fps, width, height, fourcc, RGB frames) through OpenCV."""
    cap = cv2.VideoCapture(str(path))
    assert cap.isOpened()
    head = (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), cap.get(cv2.CAP_PROP_FPS),
            int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)), int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            int(cap.get(cv2.CAP_PROP_FOURCC)).to_bytes(4, "little").decode())
    out = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        out.append(bgr[..., ::-1])
    cap.release()
    return head, out


def psnr(a, b) -> float:
    return float(10 * np.log10(255.0 ** 2 / np.mean((a.astype(np.float64) - b) ** 2)))


@pytest.mark.parametrize("h,w", SIZES)
def test_opencv_reads_the_port_video(tmp_path, h, w):
    """OpenCV opens the port's file with its frame count, size, fps and
    fourcc; its frames' PSNR is within 1 dB of ``cv2.VideoWriter``'s on the
    same frames, both read back through OpenCV."""
    clip = frames(h, w, 5, seed=h)
    with MJPGWriter(tmp_path / "port.avi", 2, (w, h)) as video:
        for f in clip:
            video.write(f)
    head, ours = captured(tmp_path / "port.avi")
    assert head == (5, 2.0, w, h, "MJPG")
    writer = cv2.VideoWriter(str(tmp_path / "cv2.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 2, (w, h))
    for f in clip:
        writer.write(np.ascontiguousarray(f[..., ::-1]))
    writer.release()
    _, theirs = captured(tmp_path / "cv2.avi")
    assert len(ours) == len(theirs) == 5
    for a, b, f in zip(ours, theirs, clip):
        assert psnr(a, f) >= psnr(b, f) - 1.0


def test_the_port_reads_opencv_and_its_own_video(tmp_path):
    """``read_avi`` gives each frame's JPEG: the port's own frames back bit
    for bit, OpenCV's file with its header's values."""
    clip = frames(48, 64, 3, seed=1)
    with MJPGWriter(tmp_path / "port.avi", 2.5, (64, 48)) as video:
        for f in clip:
            video.write(f)
    avi = read_avi(tmp_path / "port.avi")
    assert (avi.fourcc, avi.fps, avi.width, avi.height) == ("MJPG", 2.5, 64, 48)
    assert avi.frames == [encode_jpeg(f, 95) for f in clip]
    writer = cv2.VideoWriter(str(tmp_path / "cv2.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 2,
                             (64, 48))
    for f in clip:
        writer.write(np.ascontiguousarray(f[..., ::-1]))
    writer.release()
    theirs = read_avi(tmp_path / "cv2.avi")
    assert (theirs.fourcc, theirs.fps, theirs.width, theirs.height) == ("MJPG", 2.0, 64, 48)
    assert [read_jpeg(b).shape for b in theirs.frames] == [(48, 64, 3)] * 3


def test_writer_refuses_bad_frames_and_use_after_release(tmp_path):
    video = MJPGWriter(tmp_path / "v.avi", 2, (64, 48))
    with pytest.raises(ValueError, match="shape"):
        video.write(np.zeros((64, 48, 3), np.uint8))
    video.release()
    video.release()  # a second release does nothing
    with pytest.raises(ValueError, match="released"):
        video.write(np.zeros((48, 64, 3), np.uint8))
    assert read_avi(tmp_path / "v.avi").frames == []
    with pytest.raises(ValueError, match="positive"):
        MJPGWriter(tmp_path / "w.avi", 0, (64, 48))


def test_submit_kitti_writes_one_video_a_scene(tmp_path, monkeypatch):
    """``submit_kitti(submission=False)`` on the CPU: one ``.avi`` a scene at
    2 fps and no PNG; each frame the encoding of the pseudo-colour map of
    the disparity ``TemporalEvaluator`` gave for it."""
    H, W, n = 64, 96, 3
    fabricate.kitti_tree(str(tmp_path), scenes=("000000", "000001"), frames=n, height=H, width=W)
    disps, call = [], evaluate.TemporalEvaluator.__call__

    def recording(self, *args):
        disps.append(call(self, *args))
        return disps[-1]

    monkeypatch.setattr(evaluate.TemporalEvaluator, "__call__", recording)
    cfg = ModelConfig(mixed_precision=False, corr_dtype="float32")
    out = tmp_path / "out"
    assert evaluate.submit_kitti(TCStereo(cfg, device="cpu", seed=0), cfg, iters=1,
                                 root=str(tmp_path / "KITTI"), out_dir=str(out),
                                 submission=False, device="cpu") == {"kitti-fps": 0.0}
    written = sorted(os.path.relpath(os.path.join(d, f), out)
                     for d, _, files in os.walk(out) for f in files)
    assert written == ["video/000000.avi", "video/000001.avi"]
    for s, name in enumerate(("000000", "000001")):
        avi = read_avi(out / "video" / f"{name}.avi")
        assert (avi.fourcc, avi.fps, avi.width, avi.height, len(avi.frames)) == (
            "MJPG", 2.0, W, H, n)
        for k, data in enumerate(avi.frames):
            rgb = pseudo_color_map(disps[s * n + k], vmin=0, vmax=96, kitti_style=True)
            assert data == encode_jpeg(rgb, 95)
        head, _ = captured(out / "video" / f"{name}.avi")
        assert head == (n, 2.0, W, H, "MJPG")
