"""The port's JPEG codec (``tcs_tpu_torch/csrc/jpeg.c``) and PPM reader
against ``tcs_tpu``'s readers (libjpeg through ``native/tcs_io.cc``, PIL) and
PIL's encoder (libjpeg-turbo).

The decoder is held bit for bit over a grid of JPEGs that PIL writes (and
OpenCV, for 4:4:0): sampling 4:4:4, 4:2:2, 4:2:0, 4:4:0 and gray; baseline
and progressive; default and optimised Huffman tables; with and without
restart markers; each at qualities 50, 75, 95 and 100 and sizes 1x1, 7x9,
17x33 and 121x203. No JAX program is compiled here.
"""

import hashlib
import io
import itertools
import json
import os

import cv2
import numpy as np
import pytest
import torch
from PIL import Image, ImageFile

from tcs_tpu.data import frame_utils as jax_fu
from tcs_tpu_torch.data import frame_utils, jpeg

torch.set_num_threads(2)
ImageFile.MAXBLOCK = 1 << 22  # PIL's progressive and optimised writes of tiny images need room

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "jpeg")
QUALITIES = (50, 75, 95, 100)
SIZES = ((1, 1), (7, 9), (17, 33), (121, 203))
SAMPLING = {"444": 0, "422": 1, "420": 2, "440": None, "gray": None}


def picture(h: int, w: int, seed: int, gray: bool = False) -> np.ndarray:
    """Smooth colour waves and noise: both kinds of content a camera gives."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / (6 + c) + c) * np.cos(y / (5 + c) - c)
                     for c in range(3)], -1)
    img = np.clip(base + rng.normal(0, 25, base.shape), 0, 255).astype(np.uint8)
    return img[..., 1] if gray else img


def write_jpeg(img, sampling: str, progressive: bool, optimize: bool, restart: bool,
               quality: int) -> bytes:
    if sampling == "440":  # PIL cannot write 4:4:0; OpenCV's libjpeg can
        params = [cv2.IMWRITE_JPEG_QUALITY, quality,
                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
                  cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
                  cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize),
                  cv2.IMWRITE_JPEG_RST_INTERVAL, 2 if restart else 0]
        ok, enc = cv2.imencode(".jpg", img[..., ::-1], params)
        assert ok
        return enc.tobytes()
    kw = dict(quality=quality, progressive=progressive, optimize=optimize)
    if sampling != "gray":
        kw["subsampling"] = SAMPLING[sampling]
    if restart:
        kw["restart_marker_blocks"] = 3
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


GRID = list(itertools.product(SAMPLING, ("baseline", "progressive"), ("default", "optimised"),
                              ("no_restart", "restart")))


@pytest.mark.parametrize("sampling,mode,tables,restart", GRID,
                         ids=["-".join(c) for c in GRID])
def test_decoder_is_tcs_tpus_read_image(tmp_path, sampling, mode, tables, restart):
    """``read_jpeg`` equals ``tcs_tpu``'s ``read_image`` bit for bit, shape
    included; the port's ``read_image`` tiles a gray image to RGB."""
    for k, (q, (h, w)) in enumerate(itertools.product(QUALITIES, SIZES)):
        img = picture(h, w, seed=k, gray=sampling == "gray")
        path = tmp_path / f"q{q}_{h}x{w}.jpg"
        path.write_bytes(write_jpeg(img, sampling, mode == "progressive",
                                    tables == "optimised", restart == "restart", q))
        theirs = jax_fu.read_image(str(path))
        ours = jpeg.read_jpeg(path)
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, (q, h, w)
        assert np.array_equal(ours, theirs), (q, h, w, np.abs(ours.astype(int) - theirs).max())
        rgb = np.tile(ours, (1, 1, 3 // ours.shape[2]))
        assert np.array_equal(frame_utils.read_image(path), rgb)
        assert jpeg.jpeg_info(path) == (w, h, ours.shape[2], mode == "progressive")


def test_gray_jpeg_is_one_channel_in_tcs_tpu(tmp_path):
    """``tcs_tpu``'s native path returns a gray JPEG as (H, W, 1), against
    its docstring (tiled to 3 channels); the port's ``read_image`` tiles it
    (ROADMAP Queue 3)."""
    path = tmp_path / "g.jpg"
    path.write_bytes(write_jpeg(picture(9, 11, 0, gray=True), "gray", False, False, False, 90))
    assert jax_fu.read_image(str(path)).shape == (9, 11, 1)
    assert frame_utils.read_image(path).shape == (9, 11, 3)


FIXTURE_NAMES = sorted(n for n in os.listdir(FIXTURES) if n.endswith(".jpg"))


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixture_digests_are_tcs_tpus_decode(name):
    """``digests.json`` (which ``chip_smoke.py`` phase 12 holds the card's
    host to) is ``tcs_tpu``'s decode, and the port's."""
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        want = json.load(f)["decode"][name]
    path = os.path.join(FIXTURES, name)
    for img in (jax_fu.read_image(path), jpeg.read_jpeg(path)):
        assert {"shape": list(img.shape),
                "sha256": hashlib.sha256(img.tobytes()).hexdigest()} == want
    assert os.path.getsize(path) < 8192


def test_encoder_fixture_digest_is_pils():
    """The encoder's entry of ``digests.json`` (which ``chip_smoke.py``
    phase 12 holds the card's host to) is the SHA-256 of PIL's JPEG of the
    committed image at its quality, 4:2:0, and of the port's."""
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        cases = json.load(f)["encode"]
    assert list(cases) == ["encode_420.ppm"]
    for name, want in cases.items():
        path = os.path.join(FIXTURES, name)
        img = frame_utils.read_image(path)
        assert img.shape == (37, 53, 3) and np.array_equal(img, np.asarray(Image.open(path)))
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=want["quality"], subsampling=2)
        for data in (buf.getvalue(), jpeg.encode_jpeg(img, want["quality"])):
            assert hashlib.sha256(data).hexdigest() == want["sha256"]


def _sof_patched(data: bytes, marker: int = None, precision: int = None) -> bytes:
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    if marker is not None:
        out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


def _baseline() -> bytes:
    return write_jpeg(picture(16, 24, 5), "420", False, False, False, 90)


def _cut_in_scan() -> bytes:
    """A file cut halfway through its entropy-coded data."""
    data = _baseline()
    sos = data.index(b"\xff\xda")
    return data[:sos + (len(data) - sos) // 2]


def _unrefined_progressive() -> bytes:
    """A progressive file cut after its first two scans (the DC scan and the
    first AC band), then ended: its low coefficients are never refined."""
    data = write_jpeg(picture(16, 24, 6), "420", True, False, False, 90)
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    return data[:sos[2]] + b"\xff\xd9"


REFUSED = {
    "arithmetic": (lambda: _sof_patched(_baseline(), marker=0xC9), jpeg.UnsupportedJPEG,
                   "arithmetic-coded"),
    "12-bit": (lambda: _sof_patched(_baseline(), precision=12), jpeg.UnsupportedJPEG, "12-bit"),
    "lossless": (lambda: _sof_patched(_baseline(), marker=0xC3), jpeg.UnsupportedJPEG,
                 "lossless"),
    "hierarchical": (lambda: _sof_patched(_baseline(), marker=0xC5), jpeg.UnsupportedJPEG,
                     "hierarchical"),
    "cmyk": (lambda: _pil_bytes(Image.fromarray(picture(16, 24, 7)).convert("CMYK")),
             jpeg.UnsupportedJPEG, "CMYK"),
    "unrefined_progressive": (_unrefined_progressive, jpeg.UnsupportedJPEG, "block-smooths"),
    "truncated": (_cut_in_scan, jpeg.CorruptJPEG, "truncated"),
    "truncated_header": (lambda: _baseline()[:200], jpeg.CorruptJPEG, "truncated"),
    "no_end_marker": (lambda: _baseline()[:-2], jpeg.CorruptJPEG, "end-of-image"),
    "extraneous_bytes": (lambda: _baseline()[:-2] + b"\x12\x34\xff\xd9", jpeg.CorruptJPEG,
                         "extraneous"),
}


def _pil_bytes(im) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "JPEG", quality=90)
    return buf.getvalue()


@pytest.mark.parametrize("case", list(REFUSED))
def test_refusals_name_the_format(tmp_path, case):
    make, error, words = REFUSED[case]
    path = tmp_path / f"{case}.jpg"
    path.write_bytes(make())
    with pytest.raises(error, match=f"{case}.jpg: .*{words}"):
        jpeg.read_jpeg(path)
    assert issubclass(error, NotImplementedError if error is jpeg.UnsupportedJPEG else IOError)


def test_truncated_file_is_an_image_to_tcs_tpu(tmp_path):
    """libjpeg warns on a truncated stream, pads it with zeros and returns
    an image, so ``tcs_tpu``'s reader hands the padding on as pixels; the
    port raises (ROADMAP Queue 3)."""
    path = tmp_path / "cut.jpg"
    path.write_bytes(_cut_in_scan())
    assert jax_fu.read_image(str(path)).shape == (16, 24, 3)
    with pytest.raises(IOError, match="truncated"):
        frame_utils.read_image(path)


def psnr(a, b) -> float:
    return float(10 * np.log10(255.0 ** 2 / np.mean((a.astype(np.float64) - b) ** 2)))


@pytest.mark.parametrize("quality", QUALITIES)
def test_encoder_is_libjpegs(quality):
    """The port's baseline 4:2:0 file is the one PIL writes at the same
    quality, byte for byte; PIL and the port decode it to the same bits; its
    PSNR against the input is within 0.5 dB of PIL's encoder's."""
    for k, (h, w) in enumerate(SIZES + ((540, 960),)):
        img = picture(h, w, seed=10 + k)
        ours = jpeg.encode_jpeg(img, quality)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=quality, subsampling=2)
        decoded = jpeg.read_jpeg(ours)
        assert np.array_equal(decoded, np.asarray(Image.open(io.BytesIO(ours))))
        assert psnr(decoded, img) >= psnr(np.asarray(Image.open(buf)), img) - 0.5
        assert ours == buf.getvalue(), (h, w)


def test_encoder_refuses_what_it_does_not_write():
    with pytest.raises(ValueError, match="RGB"):
        jpeg.encode_jpeg(np.zeros((4, 5), np.uint8))
    with pytest.raises(ValueError, match="quality"):
        jpeg.encode_jpeg(np.zeros((4, 5, 3), np.uint8), quality=0)


PNM = [("P5", 255), ("P5", 65535), ("P5", 1000), ("P5", 77), ("P6", 255), ("P6", 65535),
       ("P6", 100), ("P6", 300)]


@pytest.mark.parametrize("magic,maxval", PNM, ids=[f"{m}-{v}" for m, v in PNM])
def test_ppm_is_tcs_tpus(tmp_path, magic, maxval):
    """Binary PGM / PPM at 8 and 16 bits as ``tcs_tpu``'s PIL path reads
    them: dtype (int32 for a 16-bit PGM), shape and values."""
    shape = (5, 7, 3) if magic == "P6" else (5, 7)
    values = np.random.default_rng(maxval).integers(0, maxval + 1, shape)
    data = values.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    path = tmp_path / ("t.ppm" if magic == "P6" else "t.pgm")
    path.write_bytes(f"{magic}\n# a comment\n{shape[1]} {shape[0]}\n{maxval}\n".encode() + data)
    theirs = np.asarray(Image.open(path))
    ppm = tmp_path / "t.ppm"  # tcs_tpu's read_gen dispatches .ppm only
    ppm.write_bytes(path.read_bytes())
    for ours, want in ((frame_utils.read_ppm(path), theirs),
                       (frame_utils.read_image(ppm), jax_fu.read_image(str(ppm)))):
        assert ours.dtype == want.dtype and ours.shape == want.shape
        assert np.array_equal(ours, want)
