"""Sequence-consistent data augmentation on the host (the port's copy of
``tcs_tpu/data/augmentor.py``; reference ``core/utils/augmentor.py``).

The four augmentor classes of the reference: single-pair (``FlowAugmentor``
:29, ``SparseFlowAugmentor`` :153) and temporal (``TemporalFlowAugmentor``
:288, ``TemporalSparseFlowAugmentor`` :533), as ``tcs_tpu`` keeps them:

- photometric: torchvision-style ColorJitter (brightness 0.4, contrast 0.4,
  a saturation range, hue ±0.5/3.14 rad) and gamma over the frame-stacked
  sequence, asymmetric between left and right with probability 0.2 (0 for
  sparse);
- eraser: 1-2 mean-colour rectangles on the right images, shared across the
  sequence, probability 0.5;
- spatial: a 2^U(min, max) scale with ±0.2 stretch (probability 0.8),
  clipped so that the crop fits, then a random crop, with the intrinsics K
  scaled by (sx, sy) and shifted by the crop's origin;
- yjitter: the right image's crop row jittered by ±2 px;
- ``do_flip`` ('h' stereo swap, 'hf' h-flip, 'v' v-flip) for single pairs
  only: the temporal classes refuse it, since a flip would invalidate the
  camera poses of a temporal sample (the reference accepts the flag there
  and never flips);
- the sparse temporal variant resizes flow and valid densely and keeps the
  pixels whose resized valid is exactly 1.0; the single-pair sparse variant
  scatters valid pixels (:func:`resize_sparse_flow_map`).

Every draw comes from the caller's ``np.random.Generator``, in ``tcs_tpu``'s
order (ColorJitter draws its factors in permutation order), so one seed
gives the same crop, factors and eraser boxes in both packages.

The data path runs the two heavy operations in the host core
(``csrc/host_io.c``, called without the GIL): :data:`resize_bilinear` and
:data:`color_jitter`. Their numpy versions, :func:`resize_bilinear_plain` and
:func:`color_jitter_plain`, are ``tcs_tpu``'s numpy path; the tests put them
in place of the core to hold the port to ``tcs_tpu`` exactly, and hold the
core to them.
"""

from __future__ import annotations


import numpy as np

from tcs_tpu_torch.data import _host


# ---------------------------------------------------------------------------
# Photometric ops (torchvision-equivalent, uint8 numpy)
# ---------------------------------------------------------------------------


def _blend(a: np.ndarray, b: np.ndarray, factor: float) -> np.ndarray:
    out = factor * a.astype(np.float32) + (1.0 - factor) * b
    return np.clip(out, 0, 255)


def _grayscale(img: np.ndarray) -> np.ndarray:
    # ITU-R 601-2 luma (PIL convert('L') weights)
    return (
        0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    )[..., None]


def adjust_brightness(img, factor):
    return _blend(img, np.zeros_like(img, np.float32), factor)


def adjust_contrast(img, factor):
    mean = _grayscale(img).mean()
    return _blend(img, np.full_like(img, mean, np.float32), factor)


def adjust_saturation(img, factor):
    return _blend(img, np.broadcast_to(_grayscale(img), img.shape), factor)


def _rgb_to_hsv(img):
    img = img.astype(np.float32) / 255.0
    maxc = img.max(-1)
    minc = img.min(-1)
    v = maxc
    deltac = maxc - minc
    s = np.where(maxc > 0, deltac / np.maximum(maxc, 1e-12), 0.0)
    dc = np.where(deltac == 0, 1.0, deltac)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    rc = (maxc - r) / dc
    gc = (maxc - g) / dc
    bc = (maxc - b) / dc
    h = np.where(r == maxc, bc - gc, np.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = np.where(deltac == 0, 0.0, h)
    return h, s, v


def _hsv_to_rgb(h, s, v):
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    conds = [i == k for k in range(6)]
    r = np.select(conds, [v, q, p, p, t, v])
    g = np.select(conds, [t, v, v, q, p, p])
    b = np.select(conds, [p, p, t, v, v, q])
    return np.stack([r, g, b], axis=-1) * 255.0


def adjust_hue(img, hue_shift):
    """hue_shift in turns (torchvision: hue factor in [−0.5, 0.5])."""
    h, s, v = _rgb_to_hsv(img)
    h = (h + hue_shift) % 1.0
    return _hsv_to_rgb(h, s, v)


def adjust_gamma(img, gamma, gain=1.0):
    out = 255.0 * gain * np.power(img.astype(np.float32) / 255.0, gamma)
    return np.clip(out, 0, 255)


class ColorJitter:
    """torchvision ColorJitter + AdjustGamma in numpy (uint8 in/out)."""

    def __init__(self, brightness=0.4, contrast=0.4,
                 saturation=(0.6, 1.4), hue=0.5 / 3.14,
                 gamma=(1.0, 1.0, 1.0, 1.0)):
        self.brightness = (max(0.0, 1 - brightness), 1 + brightness)
        self.contrast = (max(0.0, 1 - contrast), 1 + contrast)
        self.saturation = tuple(saturation)
        self.hue = (-hue, hue)
        self.gamma = gamma  # (gamma_min, gamma_max, gain_min, gain_max)

    def __call__(self, img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        # Factors are drawn in permutation order, one uniform per op as it
        # runs, as tcs_tpu draws them: every later draw of the sample's
        # augmentation depends on this stream.
        ranges = [self.brightness, self.contrast, self.saturation, self.hue]
        order = rng.permutation(4)
        factors = [0.0] * 4
        for i in order:
            factors[i] = rng.uniform(*ranges[i])
        g_min, g_max = self.gamma[0], self.gamma[1]
        gain_min = self.gamma[2] if len(self.gamma) > 2 else 1.0
        gain_max = self.gamma[3] if len(self.gamma) > 3 else 1.0
        gamma = rng.uniform(g_min, g_max)
        gain = rng.uniform(gain_min, gain_max)

        return color_jitter(img, order, factors, gamma, gain)


def color_jitter_plain(img: np.ndarray, order, factors, gamma: float,
                       gain: float) -> np.ndarray:
    """The numpy version of :data:`color_jitter` (``tcs_tpu``'s numpy path)."""
    ops = [
        lambda x: adjust_brightness(x, factors[0]),
        lambda x: adjust_contrast(x, factors[1]),
        lambda x: adjust_saturation(x, factors[2]),
        lambda x: adjust_hue(x, factors[3]),
    ]
    out = img.astype(np.float32)
    for i in order:
        out = ops[i](out)
    out = adjust_gamma(out, gamma, gain)
    return np.round(out).astype(np.uint8)


# ---------------------------------------------------------------------------
# Spatial helpers
# ---------------------------------------------------------------------------


def resize_bilinear_plain(img: np.ndarray, out_h: int, out_w: int,
                          window=None) -> np.ndarray:
    """Bilinear resize, half-pixel centres (cv2.INTER_LINEAR), in float64,
    then the ``window`` (y, x, h, w) of it where one is given: the numpy
    version of :data:`resize_bilinear`."""
    H, W = img.shape[:2]
    ys = (np.arange(out_h) + 0.5) * (H / out_h) - 0.5
    xs = (np.arange(out_w) + 0.5) * (W / out_w) - 0.5
    y0 = np.clip(np.floor(ys), 0, H - 1).astype(np.int64)
    x0 = np.clip(np.floor(xs), 0, W - 1).astype(np.int64)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    img = img.astype(np.float32)
    if img.ndim == 2:
        img = img[..., None]
        squeeze = True
    else:
        squeeze = False
    top = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    bot = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    out = top * (1 - fy) + bot * fy
    if window is not None:
        y, x, h, w = window
        out = out[y:y + h, x:x + w]
    return out[..., 0] if squeeze else out


# The data path's two heavy operations, in the host core. Module attributes,
# looked up at each call, so that a test can put the plain versions in place.
resize_bilinear = _host.resize_bilinear
color_jitter = _host.color_jitter


def resize_sparse_flow_map(flow: np.ndarray, valid: np.ndarray,
                           fx: float = 1.0, fy: float = 1.0):
    """Scatter-based resize of a SPARSE flow field (reference
    ``core/utils/augmentor.py:192-224``).

    A bilinear resize of sparse GT smears defined values into undefined
    pixels; the reference instead scatters each valid pixel to its scaled
    (rounded) location and rebuilds the validity mask. Quirks preserved:
    the in-bounds test is strictly ``> 0`` (drops row/col 0), and colliding
    pixels resolve last-writer-wins in flattened raster order.

    Args: flow (H,W,1) x-flow, valid (H,W,1) in {0,1}.
    Returns (flow', valid') with shape (round(H*fy), round(W*fx), 1).
    """
    ht, wd = flow.shape[:2]
    xs, ys = np.meshgrid(np.arange(wd), np.arange(ht))
    m = valid.reshape(ht, wd) >= 1
    coords_x = xs[m].astype(np.float32) * fx
    coords_y = ys[m].astype(np.float32) * fy
    flow0 = flow.reshape(ht, wd)[m].astype(np.float32) * fx

    ht1 = int(round(ht * fy))
    wd1 = int(round(wd * fx))
    xx = np.round(coords_x).astype(np.int32)
    yy = np.round(coords_y).astype(np.int32)
    v = (xx > 0) & (xx < wd1) & (yy > 0) & (yy < ht1)

    flow_img = np.zeros([ht1, wd1], dtype=np.float32)
    valid_img = np.zeros([ht1, wd1], dtype=np.float32)
    flow_img[yy[v], xx[v]] = flow0[v]
    valid_img[yy[v], xx[v]] = 1.0
    return flow_img[..., None], valid_img[..., None]


# ---------------------------------------------------------------------------
# Temporal augmentors
# ---------------------------------------------------------------------------


class TemporalFlowAugmentor:
    """Sequence-consistent augmentation with dense GT (SceneFlow/TartanAir).

    __call__(seq1, seq2, flow_seq, K, rng) →
      (left (T,h,w,3) f32, right (T,h,w,3), flow (T,h,w,1), valid (T,h,w,1),
       K (3,3)).
    Input flow is signed x-flow (−disp), (T,H,W,1).
    """

    # Single-pair subclasses flip (reference augmentor.py:106-124); temporal
    # sequences carry camera poses that a flip would invalidate, so the
    # temporal classes refuse do_flip instead of silently ignoring it the way
    # the reference's temporal augmentors do.
    _allow_flip = False

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5,
                 do_flip=False, yjitter=False, saturation_range=(0.6, 1.4),
                 gamma=(1, 1, 1, 1)):
        if do_flip and not self._allow_flip:
            raise ValueError(
                f"{type(self).__name__} does not support do_flip={do_flip!r}: "
                "flips invalidate the camera poses of temporal samples (the "
                "reference's temporal augmentors accept the flag but never "
                "flip). Use FlowAugmentor/SparseFlowAugmentor for flips."
            )
        if do_flip not in (False, None, "h", "hf", "v"):
            raise ValueError(f"do_flip must be one of 'h'/'hf'/'v', got "
                             f"{do_flip!r}")
        self.crop_size = tuple(crop_size)
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 1.0
        self.stretch_prob = 0.8
        self.max_stretch = 0.2
        self.yjitter = yjitter
        self.do_flip = do_flip
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1
        self.photo = ColorJitter(0.4, 0.4, saturation_range, 0.5 / 3.14, gamma)
        self.asymmetric_color_aug_prob = 0.2
        self.eraser_aug_prob = 0.5
        self.sparse = False
        # True sparse GT (single-pair SparseFlowAugmentor) scatters valid
        # pixels on resize; semi-dense pseudo-labels (temporal sparse) resize
        # densely with a ==1 test (the reference's own distinction,
        # augmentor.py:192-224 vs :662-666).
        self.scatter_resize = False

    # -- photometric -------------------------------------------------------
    def color_transform(self, seq1, seq2, rng):
        T = seq1.shape[0]
        s1 = seq1.reshape(-1, *seq1.shape[2:])  # (T*H, W, 3)
        s2 = seq2.reshape(-1, *seq2.shape[2:])
        if rng.random() < self.asymmetric_color_aug_prob:
            s1 = self.photo(s1, rng)
            s2 = self.photo(s2, rng)
        else:
            stack = np.concatenate([s1, s2], axis=0)
            stack = self.photo(stack, rng)
            s1, s2 = np.split(stack, 2, axis=0)
        return s1.reshape(seq1.shape), s2.reshape(seq2.shape)

    # -- occlusion eraser --------------------------------------------------
    def eraser_transform(self, seq2, rng, bounds=(50, 100)):
        T, H, W, _ = seq2.shape
        seq2 = seq2.copy()
        if rng.random() < self.eraser_aug_prob:
            mean_color = seq2.reshape(-1, 3).mean(axis=0)
            for _ in range(rng.integers(1, 3)):
                x0 = rng.integers(0, W)
                y0 = rng.integers(0, H)
                dx = rng.integers(bounds[0], bounds[1])
                dy = rng.integers(bounds[0], bounds[1])
                seq2[:, y0 : y0 + dy, x0 : x0 + dx, :] = mean_color
        return seq2

    # -- scale/stretch/crop with K update ----------------------------------
    def _sample_scales(self, H, W, rng):
        min_scale = max((self.crop_size[0] + 8) / H, (self.crop_size[1] + 8) / W)
        scale = 2 ** rng.uniform(self.min_scale, self.max_scale)
        sx = sy = scale
        if rng.random() < self.stretch_prob:
            sx *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
            sy *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
        return max(sx, min_scale), max(sy, min_scale)

    # -- flips (single-pair classes only; reference :106-124,:244-258) ------
    def _draw_flips(self, rng):
        """Which flips apply: 'hf' h-flips both images and the flow (negated);
        'h' swaps the stereo pair, each image h-flipped, the flow untouched,
        as in the reference; 'v' v-flips everything (the y-flow negation is
        vacuous for a 1-channel x-flow). The sparse variant's ``valid``
        follows the flow (the reference forgets it). Intrinsics are not
        adjusted: the reference's single-pair augmentors carry no K. Draws
        three uniforms whenever ``do_flip`` is set, as tcs_tpu's
        ``flip_transform`` does."""
        if not self.do_flip:
            return False, False, False
        hf = rng.random() < self.h_flip_prob and self.do_flip == "hf"
        h = rng.random() < self.h_flip_prob and self.do_flip == "h"
        v = rng.random() < self.v_flip_prob and self.do_flip == "v"
        return hf, h, v

    def spatial_transform(self, seq1, seq2, flow, valid, K, rng):
        """Scale (with K), flip and crop, as tcs_tpu does them in turn, with
        the same draws; but every array is cut to its crop window before it
        is resized (the window of the whole resize, computed alone), so that
        the pixels the crop drops are never interpolated."""
        T, H, W, _ = seq1.shape
        sx, sy = self._sample_scales(H, W, rng)
        resized = rng.random() < self.spatial_aug_prob
        Hs, Ws = (int(round(H * sy)), int(round(W * sx))) if resized else (H, W)
        scatter = resized and self.sparse and self.scatter_resize
        if resized:
            K = K * np.array([sx, sy, 1.0]).reshape(3, 1)
        if scatter:
            # true sparse GT: scatter valid pixels (reference :242,192)
            pairs = [resize_sparse_flow_map(f, v, fx=sx, fy=sy)
                     for f, v in zip(flow, valid)]
            flow = np.stack([p[0] for p in pairs])
            valid = np.stack([p[1] for p in pairs])
        hflip, swap, vflip = self._draw_flips(rng)

        ch, cw = self.crop_size
        if self.yjitter and Hs >= ch + 5 and Ws >= cw + 5:
            # Simulated imperfect rectification (reference :417-431): the
            # right-image crop row is jittered ±2 px against the left/flow
            # crop; margins of 2 keep the jittered window in bounds.
            y0 = int(rng.integers(2, Hs - ch - 2))
            x0 = int(rng.integers(2, Ws - cw - 2))
            y1 = y0 + int(rng.integers(-2, 3))
        else:
            y0 = int(rng.integers(0, Hs - ch)) if Hs > ch else 0
            x0 = int(rng.integers(0, Ws - cw)) if Ws > cw else 0
            y1 = y0
        w = min(cw, Ws - x0)

        def window(arr, y, mirror_x, scale):
            """Rows y.. and columns x0.. (the crop) of ``arr`` resized to
            Hs x Ws (where ``scale``), then flipped: the flips' mirror
            images of the window are cut from the unflipped array."""
            h = min(ch, Hs - y)
            ys = Hs - y - h if vflip else y
            xs = Ws - x0 - w if mirror_x else x0
            if scale:
                out = np.stack([resize_bilinear(f, Hs, Ws, (ys, xs, h, w)) for f in arr])
            else:
                out = arr[:, ys:ys + h, xs:xs + w]
            if mirror_x:
                out = out[:, :, ::-1]
            return out[:, ::-1] if vflip else out

        left, right = (seq2, seq1) if swap else (seq1, seq2)
        seq1 = window(left, y0, hflip or swap, resized)
        seq2 = window(right, y1, hflip or swap, resized)
        flow = window(flow, y0, hflip, resized and not scatter)
        if resized and not scatter:
            flow = flow * sx  # x-flow only
        if hflip:
            flow = flow * -1.0
        if self.sparse:
            valid = window(valid, y0, hflip, resized and not scatter)
            if resized and not scatter:
                valid = (valid == 1.0).astype(np.float32)
        shift = np.zeros((3, 3))
        shift[0, 2] = x0
        shift[1, 2] = y0
        K = K - shift
        return seq1, seq2, flow, valid, K

    def __call__(self, seq1, seq2, flow_seq, valid_seq, K,
                 rng: np.random.Generator):
        seq1, seq2 = self.color_transform(seq1, seq2, rng)
        seq2 = self.eraser_transform(seq2, rng)
        seq1, seq2, flow_seq, valid_seq, K = self.spatial_transform(
            seq1.astype(np.float32), seq2.astype(np.float32),
            flow_seq.astype(np.float32), valid_seq, K.copy(), rng,
        )
        if not self.sparse:
            valid_seq = (np.abs(flow_seq) < 512).astype(np.float32)
        return (
            seq1.astype(np.float32), seq2.astype(np.float32),
            flow_seq.astype(np.float32), valid_seq.astype(np.float32),
            K.astype(np.float32),
        )


class TemporalSparseFlowAugmentor(TemporalFlowAugmentor):
    """Semi-dense pseudo-labels (KITTI_raw): spatial prob 0.8, no asymmetric
    jitter, contrast/brightness 0.3, valid resized densely with ==1 test
    (reference :533-685)."""

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5,
                 do_flip=False, yjitter=False, saturation_range=(0.7, 1.3),
                 gamma=(1, 1, 1, 1)):
        super().__init__(crop_size, min_scale, max_scale, do_flip, yjitter,
                         saturation_range, gamma)
        self.spatial_aug_prob = 0.8
        self.asymmetric_color_aug_prob = 0.0
        self.photo = ColorJitter(0.3, 0.3, saturation_range, 0.5 / 3.14, gamma)
        self.sparse = True


# Single-pair augmentors (reference FlowAugmentor:29 / SparseFlowAugmentor:153)
# are the T=1 specialisation; provided for the non-temporal datasets.


class FlowAugmentor(TemporalFlowAugmentor):
    _allow_flip = True

    def augment_pair(self, img1, img2, flow, K=None, rng=None):
        K = np.eye(3) if K is None else K
        s1, s2, f, v, K = self(
            img1[None], img2[None], flow[None], np.ones_like(flow[None]), K,
            rng,
        )
        return s1[0], s2[0], f[0], v[0], K


class SparseFlowAugmentor(TemporalSparseFlowAugmentor):
    """Single-pair TRUE-sparse GT (KITTI 2015/2012 labels — reference
    ``SparseFlowAugmentor``, augmentor.py:153-287): flow/valid resized by
    scattering valid pixels, no stretch (the reference's sparse
    spatial_transform uses scale_x == scale_y, :235-239)."""

    _allow_flip = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.scatter_resize = True

    def _sample_scales(self, H, W, rng):
        # reference :229-235: isotropic scale, min so the crop(+1) fits
        min_scale = max((self.crop_size[0] + 1) / H, (self.crop_size[1] + 1) / W)
        scale = 2 ** rng.uniform(self.min_scale, self.max_scale)
        s = max(scale, min_scale)
        return s, s

    def augment_pair(self, img1, img2, flow, valid, K=None, rng=None):
        K = np.eye(3) if K is None else K
        s1, s2, f, v, K = self(
            img1[None], img2[None], flow[None], valid[None], K, rng
        )
        return s1[0], s2[0], f[0], v[0], K
