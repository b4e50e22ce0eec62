"""Temporal evaluation (port of ``tcs_tpu/evaluate.py``; reference
``evaluate_stereo.py``).

:class:`TemporalEvaluator` carries the :class:`TemporalState` across the
frames of one sequence stream (or a batch of streams) on one device. Frames
are padded to /32 with the K-tracking :class:`InputPadder`. The evaluators:

- :func:`validate_tartanair`: EPE / D1 (>1 px) / D3 (>3 px) and the
  temporal-consistency metrics over the 20 held-out TartanAir sequences
  (reference :120-223);
- :func:`validate_temporal_things`: FlyingThings TEST, temporal
  (reference :265-345);
- :func:`submit_kitti`: the KITTI 2015 sequence submission, frame 10 as a
  uint16 PNG ×256, or pseudo-colour frames (reference :28-116).

They take the port's ``TCStereo`` with its weights and a ``device`` that
defaults to the GPU. The aggregation is ``tcs_tpu``'s: D1/D3 weighted by the
valid rate, temporal pairs only between frames ``j - 1`` and ``j``.

With ``sharded=True`` under a process group (``parallel.mesh``), rank r
streams the sequences r, r + W, ... one at a time at batch 1, and every rank
gathers the frames' rows and aggregates them in the serial order: the
results equal the single-process run's bit for bit. ``tcs_tpu``'s mesh path
(``tcs_tpu/evaluate.py:183-227``) stacks one stream per device into one
batch and pads a short chunk with its last sequence, so under
``context_norm="batch"`` its batch norm mixes the streams and the padding,
against its own promise of the serial path's metrics; the port does not copy
that.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from tcs_tpu_torch import device as device_lib
from tcs_tpu_torch.config import ModelConfig
from tcs_tpu_torch.data import frame_utils
from tcs_tpu_torch.data.datasets import (
    KITTI,
    SceneFlowDatasets,
    TartanAir,
    tartanair_test_keywords,
)
from tcs_tpu_torch.models.tc_stereo import CameraParams, TCStereo, TemporalState
from tcs_tpu_torch.parallel import mesh
from tcs_tpu_torch.utils import profiling
from tcs_tpu_torch.utils.padder import InputPadder
from tcs_tpu_torch.utils.video import MJPGWriter
from tcs_tpu_torch.utils.visualization import pseudo_color_map

logger = logging.getLogger(__name__)

SCENEFLOW_TEST_K = np.array(
    [[1050.0, 0.0, 479.5], [0.0, 1050.0, 269.5], [0.0, 0.0, 1.0]], np.float32
)
TARTANAIR_TEST_K = np.array(
    [[320.0, 0.0, 320.0], [0.0, 320.0, 240.0], [0.0, 0.0, 1.0]], np.float32
)


def make_eval_fn(model: TCStereo, iters: int):
    """step(image1, image2, state, cam, T) → (flow, new_state)."""

    def step(image1, image2, state, cam, T):
        out = model(image1, image2, state, cam, T, iters=iters, test_mode=True)
        return out.flow, out.new_state

    return step


class TemporalEvaluator:
    """Carries state and the step across the frames of a sequence stream.

    Frames go to the device in the dtype they come in and are cast to fp32
    there: uint8 frames, as decoders give them, move a quarter of the bytes
    of fp32 ones and are not converted on the host. The cast is exact for
    integer frames and rounds as the host's would for float64 ones, so the
    results are those of fp32 frames.

    A call's input conversion, its copies to the device and the padding are
    the span ``eval.inputs`` (:func:`profiling.span`); the unpadding and the
    copy back to the host, where the host waits for the device,
    ``eval.output``."""

    def __init__(self, model: TCStereo, cfg: ModelConfig, iters: int, device=None):
        self.device = device_lib.resolve(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.iters = iters
        self._step = make_eval_fn(self.model, iters)
        self.state = None

    def reset(self):
        self.state = None

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def _device_images(self, image1: np.ndarray, image2: np.ndarray):
        """(D, H, W, 3) frames → their fp32 tensors on the device."""
        # torch gathers a frame of any layout on its threads; numpy took 50-70
        # ms to make such a frame contiguous on the card's host (PERF.md).
        # Only negative strides, which torch refuses, are copied by numpy.
        return tuple(torch.from_numpy(x if min(x.strides) >= 0 else x.copy())
                     .to(self.device).float()
                     for x in (np.asarray(image1), np.asarray(image2)))

    def __call__(self, image1: np.ndarray, image2: np.ndarray,
                 K: np.ndarray, baseline, T: np.ndarray) -> np.ndarray:
        """image1/2: (H, W, 3) → disparity (H, W) numpy ≥ 0; or batched
        (D, H, W, 3) with K (D,3,3), baseline (D,), T (D,4,4) → (D, H, W)."""
        with profiling.span("eval.inputs"):
            batched = np.ndim(image1) == 4
            if not batched:
                image1, image2 = image1[None], image2[None]
                K, T = np.asarray(K)[None], np.asarray(T)[None]
                baseline = np.full((1,), baseline, np.float32)
            D, H, W = image1.shape[:3]
            padder = InputPadder((D, H, W, 3), divis_by=32)
            (i1, i2), Kp = padder.pad(*self._device_images(image1, image2),
                                      K=self._tensor(K))
            cam = CameraParams(K=Kp, baseline=self._tensor(baseline).reshape(D))
            T = self._tensor(T)
            if self.state is None:
                self.state = TemporalState.zeros(D, i1.shape[1], i1.shape[2], self.cfg,
                                                 device=self.device)
        flow, self.state = self._step(i1, i2, self.state, cam, T)
        with profiling.span("eval.output"):
            out = (-padder.unpad(flow)[..., 0]).cpu().numpy()
        return out if batched else out[0]


def _epe_metrics(disp_pr, disp_gt, max_disp=192.0):
    epe = np.abs(disp_pr - disp_gt)
    val = np.abs(disp_gt) < max_disp
    if not val.any():
        return None
    rate = float(val.mean())
    return {
        "epe": float(epe[val].mean()),
        "d1_weighted": float((epe > 1.0)[val].mean()) * rate,
        "d3_weighted": float((epe > 3.0)[val].mean()) * rate,
        "rate": rate,
    }


def temporal_consistency_metrics(prev_disp, disp, prev_gt, gt,
                                 max_disp: float = 192.0) -> Optional[Dict]:
    """|Δd|>3px: the predicted frame-to-frame disparity change deviates from
    the ground truth's change by more than 3 px; Relu(Δe)>3px: the
    per-pixel error grew by more than 3 px since the previous frame. Pixel
    aligned (no reprojection); both frames' ground truth must be valid."""
    val = (np.abs(gt) < max_disp) & (np.abs(prev_gt) < max_disp)
    if not val.any():
        return None
    dd = (disp - prev_disp) - (gt - prev_gt)
    de = np.abs(disp - gt) - np.abs(prev_disp - prev_gt)
    return {
        "tc_dd3": float((np.abs(dd) > 3.0)[val].mean()),
        "tc_de3": float((np.maximum(de, 0.0) > 3.0)[val].mean()),
    }


def _aggregate(rows: List[Dict], prefix: str) -> Dict[str, float]:
    epe = float(np.mean([r["epe"] for r in rows]))
    rate = np.mean([r["rate"] for r in rows])
    d1 = 100.0 * np.mean([r["d1_weighted"] for r in rows]) / rate
    d3 = 100.0 * np.mean([r["d3_weighted"] for r in rows]) / rate
    return {f"{prefix}-epe": epe, f"{prefix}-d1": float(d1), f"{prefix}-d3": float(d3)}


def metric_bounds(frames, tol: float, prefix: str, temporal: bool = True,
                  max_disp: float = 192.0) -> Dict[str, float]:
    """How far each metric of a run can move when every disparity moves by at
    most ``tol`` px, for comparing two runs: EPE by ``tol``; D1 and D3 by the
    share of valid pixels whose error lies within ``tol`` of 1 or 3 px
    (weighted as :func:`_aggregate` weights them); with ``temporal`` the
    ``tc-*`` metrics by the mean share of valid pixels whose |Δd| or Relu(Δe),
    each a difference of two frames, lies within ``2·tol`` of 3 px.

    frames: per sequence the list of (disp, gt) in frame order, of one run.
    """
    rates, near1, near3, tc = [], [], [], []
    for seq in frames:
        for j, (disp, gt) in enumerate(seq):
            val = np.abs(gt) < max_disp
            if not val.any():
                continue
            err = np.abs(disp - gt)
            rates.append(val.mean())
            near1.append((np.abs(err - 1.0) <= tol)[val].sum() / val.size)
            near3.append((np.abs(err - 3.0) <= tol)[val].sum() / val.size)
            if not temporal or j == 0:
                continue
            prev_disp, prev_gt = seq[j - 1]
            both = val & (np.abs(prev_gt) < max_disp)
            if both.any():
                dd = (disp - prev_disp) - (gt - prev_gt)
                de = err - np.abs(prev_disp - prev_gt)
                tc.append(((np.abs(np.abs(dd) - 3.0) <= 2 * tol)[both].mean(),
                           (np.abs(de - 3.0) <= 2 * tol)[both].mean()))
    rate = np.mean(rates)
    out = {f"{prefix}-epe": tol, f"{prefix}-d1": 100.0 * float(np.mean(near1) / rate),
           f"{prefix}-d3": 100.0 * float(np.mean(near3) / rate)}
    if tc:
        out[f"{prefix}-tc-dd3"] = 100.0 * float(np.mean([t[0] for t in tc]))
        out[f"{prefix}-tc-de3"] = 100.0 * float(np.mean([t[1] for t in tc]))
    return out


def _shard(n: int, sharded: bool) -> range:
    """The indices of ``n`` sequences that this rank streams."""
    return range(mesh.rank(), n, mesh.world_size()) if sharded else range(n)


def _gathered(items: list, sharded: bool) -> list:
    """Every rank's ``items``, in rank order, on every rank."""
    if not sharded or mesh.world_size() == 1:
        return items
    parts = [None] * mesh.world_size()
    torch.distributed.all_gather_object(parts, items)
    return [x for part in parts for x in part]


def _evaluate_sequences(ev: TemporalEvaluator, seqs: List[Dict],
                        max_frames: Optional[int], on_frame, sharded: bool = False) -> list:
    """Drive each sequence through the evaluator frame by frame, the state
    reset at its start; returns what ``on_frame`` returned for each frame,
    in the serial order (sequence, then frame).

    seqs: dicts with img1s/img2s/disps/poses lists + K (3,3), baseline
    (float) and read_gt(path) -> np.ndarray.
    on_frame(seq_index, frame_index, disp, disp_gt) gives the frame's rows,
    a picklable value. With ``sharded`` each rank streams its share of the
    sequences (module docstring) and the rows of every rank come back.
    """
    rows = []
    for si in _shard(len(seqs), sharded):
        s = seqs[si]
        n = min(len(s["img1s"]), max_frames if max_frames else 10**9)
        ev.reset()
        for j in range(n):
            disp = ev(frame_utils.read_image(s["img1s"][j]),
                      frame_utils.read_image(s["img2s"][j]),
                      s["K"], s["baseline"], np.asarray(s["poses"][j], np.float32))
            rows.append(((si, j), on_frame(si, j, disp, s["read_gt"](s["disps"][j]))))
    return [r for _, r in sorted(_gathered(rows, sharded), key=lambda x: x[0])]


def validate_tartanair(model: TCStereo, cfg: ModelConfig, iters: int = 5,
                       root: str = "datasets", max_sequences: Optional[int] = None,
                       max_frames: Optional[int] = None, metrics_logger=None,
                       log_images: int = 0, device=None,
                       sharded: bool = False) -> Dict[str, float]:
    """Reference ``validate_tartanair`` (:120): 20 held-out sequences.

    With ``metrics_logger`` and ``log_images`` > 0, the first frame of the
    first ``log_images`` sequences emits a coloured error map (the
    reference's ``logErrorMap``, core/utils/visualization.py:147-179), on
    the rank that streams it. ``sharded``: the sequences shared over the
    process group's ranks (module docstring)."""
    ds = TartanAir(None, root=root, scene_list=[],
                   test_keywords=tartanair_test_keywords(), is_test=True,
                   mode="temporal", load_flow=False)
    ev = TemporalEvaluator(model, cfg, iters, device=device)
    n_seq = len(ds) if max_sequences is None else min(len(ds), max_sequences)

    def read_gt(path):
        return frame_utils.readDispTartanAir(path)[0]

    seqs = []
    for s in range(n_seq):
        img1s, img2s, disps, poses = ds.test_sequence(s)
        seqs.append(dict(img1s=img1s, img2s=img2s, disps=disps, poses=poses,
                         K=TARTANAIR_TEST_K, baseline=0.25, read_gt=read_gt))

    prev = {}  # seq index -> (prev_disp, prev_gt, frame index)

    def on_frame(si, j, disp, disp_gt):
        if metrics_logger is not None and j == 0 and si < log_images:
            metrics_logger.log_error_map(
                f"val/tartanair_error_seq{si}", disp, disp_gt)
        tc = None
        if si in prev and prev[si][2] == j - 1:
            tc = temporal_consistency_metrics(prev[si][0], disp,
                                              prev[si][1], disp_gt)
        prev[si] = (disp, disp_gt, j)
        return _epe_metrics(disp, disp_gt), tc

    frames = _evaluate_sequences(ev, seqs, max_frames, on_frame, sharded)
    rows = [m for m, _ in frames if m]
    tc_rows = [tc for _, tc in frames if tc]
    results = _aggregate(rows, "TartanAir")
    if tc_rows:
        results["TartanAir-tc-dd3"] = 100.0 * float(
            np.mean([r["tc_dd3"] for r in tc_rows]))
        results["TartanAir-tc-de3"] = 100.0 * float(
            np.mean([r["tc_de3"] for r in tc_rows]))
    logger.info("Validation TartanAir: %s", results)
    return results


def validate_temporal_things(model: TCStereo, cfg: ModelConfig, iters: int = 5,
                             root: str = "datasets",
                             max_sequences: Optional[int] = None,
                             metrics_logger=None, log_images: int = 0,
                             device=None, sharded: bool = False) -> Dict[str, float]:
    """Reference ``validate_temporal_things`` (:265): FlyingThings TEST;
    ``metrics_logger``/``log_images`` and ``sharded`` as in
    :func:`validate_tartanair`."""
    ds = SceneFlowDatasets(None, root=root, dstype="frames_cleanpass",
                           things_test=True, mode="temporal")
    ev = TemporalEvaluator(model, cfg, iters, device=device)
    n_seq = len(ds) if max_sequences is None else min(len(ds), max_sequences)

    def read_gt(path):
        return np.asarray(frame_utils.read_gen(path), np.float32)

    seqs = []
    for s in range(n_seq):
        img1s, img2s, disps, poses = ds.test_sequence(s)
        seqs.append(dict(img1s=img1s, img2s=img2s, disps=disps, poses=poses,
                         K=SCENEFLOW_TEST_K, baseline=1.0, read_gt=read_gt))

    def on_frame(si, j, disp, gt):
        if metrics_logger is not None and j == 0 and si < log_images:
            metrics_logger.log_error_map(
                f"val/things_error_seq{si}", disp, gt)
        return _epe_metrics(disp, gt)

    rows = [r for r in _evaluate_sequences(ev, seqs, None, on_frame, sharded) if r]
    results = _aggregate(rows, "things")
    logger.info("Validation FlyingThings: %s", results)
    return results


def submit_kitti(model: TCStereo, cfg: ModelConfig, iters: int = 5,
                 root: str = "datasets/KITTI",
                 image_set: str = "kitti_seq/kitti2015_testings",
                 out_dir: str = "./kitti_15_seq_out", submission: bool = True,
                 num_frames: int = 11, device=None, sharded: bool = False
                 ) -> Dict[str, float]:
    """Reference ``submit_kitti`` (:28): per-scene intrinsics, fixed baseline
    0.54, FPS timing (scenes after the 51st, frames after the 7th), frame 10
    as a uint16 PNG ×256, or with ``submission=False`` the pseudo-colour
    frames as one Motion-JPEG ``video/<scene>.avi`` a scene at 2 fps (the
    reference's ``cv2.VideoWriter``, written by :class:`MJPGWriter`).
    ``sharded``: each rank of the process group streams its share of the
    scenes and writes their files, and the FPS is over every rank's timed
    frames."""
    ds = KITTI(None, root=root, is_test=True, mode="temporal",
               image_set=image_set, index_by_scene=True,
               num_frames=num_frames if submission else 21)
    ev = TemporalEvaluator(model, cfg, iters, device=device)
    elapsed = []
    for val_id in _shard(len(ds), sharded):
        img1s, img2s, scene_path, poses = ds.test_sequence(val_id)
        scene = os.path.basename(scene_path)
        calib = frame_utils.read_calib_file(os.path.join(scene_path, scene + ".txt"))
        K = frame_utils.intrinsics_from_p_rect(calib["P_rect_02"])
        ev.reset()
        video = None
        try:
            for frame_ind, (p1, p2, T) in enumerate(zip(img1s, img2s, poses)):
                i1 = frame_utils.read_image(p1)
                i2 = frame_utils.read_image(p2)
                t0 = time.time()
                disp = ev(i1, i2, K, 0.54, T)  # numpy: the device has finished
                dt = time.time() - t0
                if val_id > 50 and frame_ind > 6:
                    elapsed.append(dt)
                if submission and frame_ind == 10:
                    sub_dir = os.path.join(out_dir, "disp_0")
                    os.makedirs(sub_dir, exist_ok=True)
                    frame_utils.write_uint16_png(os.path.join(sub_dir, scene + "_10.png"),
                                                 (disp * 256.0).astype(np.uint16))
                elif not submission:
                    rgb = pseudo_color_map(disp, vmin=0, vmax=96, kitti_style=True)
                    if video is None:
                        vid_dir = os.path.join(out_dir, "video")
                        os.makedirs(vid_dir, exist_ok=True)
                        video = MJPGWriter(os.path.join(vid_dir, scene + ".avi"), 2,
                                           (rgb.shape[1], rgb.shape[0]))
                    video.write(rgb)
        finally:
            if video is not None:
                video.release()
    elapsed = _gathered(elapsed, sharded)
    fps = 1.0 / (np.mean(elapsed) + 1e-5) if elapsed else 0.0
    logger.info("Submission KITTI: %.2f FPS", fps)
    return {"kitti-fps": float(fps)}
