"""Dataset indexers and sample loading (the port's copy of
``tcs_tpu/data/datasets.py``; reference ``core/stereo_datasets.py``).

Indexing (glob, slice, oversample, split) follows the reference, as
``tcs_tpu`` does; loading returns plain numpy NHWC arrays, the fields of
``train.SequenceBatch`` for one clip: images float32 in [0, 255], flow
(T, H, W, 1) = -disparity, valid (T, H, W, 1), poses (T, 4, 4), K (3, 3) and
a scalar baseline. The loader's workers call :meth:`load_sample`; the
trainer copies the batches to the card.

Datasets (reference class, file:line):
- SceneFlowDatasets (FlyingThings3D, Monkaa, Driving; :231): temporal
  training windows and single pairs, and the FlyingThings TEST scenes;
- TartanAir (:451): temporal and single-pair, keyword split, per-video
  oversampling len // 300;
- KITTI (:535): the temporal test sequences of the submission, and the
  2015 + 2012 single pairs;
- KITTIraw (:581): temporal training on LEAStereo pseudo-labels, with the
  ``pose.txt`` files of :mod:`tcs_tpu_torch.data.kitti_raw_pose`;
- ETH3D, SintelStereo, FallingThings, Middlebury (:405, :420, :434, :635):
  single pairs;
- fetch_dataset (:659): the recipes' mixtures (SceneFlow clean x4 + final
  x4, TartanAir x100) and the single-pair mixtures.
"""

from __future__ import annotations

import copy
import logging
import os
import os.path as osp
from glob import glob
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from tcs_tpu_torch.data import frame_utils
from tcs_tpu_torch.data.augmentor import (
    FlowAugmentor,
    SparseFlowAugmentor,
    TemporalFlowAugmentor,
    TemporalSparseFlowAugmentor,
)

logger = logging.getLogger(__name__)


class StereoSequenceDataset:
    """Base dataset: an index of stereo sequences (or single pairs) plus a
    loader that reads, augments and packs one sample as numpy arrays."""

    def __init__(self, aug_params=None, sparse=False, reader=None,
                 temporal=False, frame_sample_length=4, is_test=False,
                 load_flow=False, index_by_scene=False):
        self.sparse = sparse
        self.temporal = temporal
        self.is_test = is_test
        self.load_flow = load_flow
        self.index_by_scene = index_by_scene
        self.frame_sample_length = frame_sample_length
        self.disparity_reader = reader or default_disp_reader
        self.augmentor = None
        if aug_params is not None and "crop_size" in aug_params:
            # Temporal datasets get the sequence-consistent augmentors;
            # single-pair datasets the flip-capable single-pair ones, with
            # true-sparse scatter resize in the sparse case (reference
            # StereoDataset.__init__ makes the same 4-way selection,
            # stereo_datasets.py:23-29).
            if temporal:
                cls = (TemporalSparseFlowAugmentor if sparse
                       else TemporalFlowAugmentor)
            else:
                cls = SparseFlowAugmentor if sparse else FlowAugmentor
            self.augmentor = cls(**aug_params)

        self.image_list: List = []  # [(left paths, right paths)] or [[l, r]]
        self.disparity_list: List = []
        self.pose_list: List = []
        self.flow_list: List = []
        self.extra_info: List = []
        self.intrinsic_K = None  # np (3,3) or list of (3,3)
        self.baseline: Optional[float] = None

    # ------------------------------------------------------------------
    def __len__(self):
        return len(self.image_list)

    def __mul__(self, v: int):
        out = copy.deepcopy(self)
        out.image_list = v * out.image_list
        out.disparity_list = v * out.disparity_list
        out.pose_list = v * out.pose_list
        out.flow_list = v * out.flow_list
        out.extra_info = v * out.extra_info
        if isinstance(out.intrinsic_K, list):
            out.intrinsic_K = v * out.intrinsic_K
        return out

    def __add__(self, other: "StereoSequenceDataset"):
        out = copy.deepcopy(self)
        out.image_list += other.image_list
        out.disparity_list += other.disparity_list
        out.pose_list += other.pose_list
        out.flow_list += other.flow_list
        out.extra_info += other.extra_info
        k1 = out.intrinsic_K if isinstance(out.intrinsic_K, list) else \
            [out.intrinsic_K] * len(self.image_list)

        k2 = other.intrinsic_K if isinstance(other.intrinsic_K, list) else \
            [other.intrinsic_K] * len(other.image_list)
        out.intrinsic_K = k1 + k2
        return out

    # ------------------------------------------------------------------
    def sample_K(self, index) -> np.ndarray:
        if isinstance(self.intrinsic_K, list):
            return np.asarray(self.intrinsic_K[index], np.float64).copy()
        return np.asarray(self.intrinsic_K, np.float64).copy()

    def test_sequence(self, index):
        """Index-by-scene test access: path lists for streaming evaluation
        (reference temporal test branch, :75-81)."""
        img1, img2 = self.image_list[index]
        disp = self.disparity_list[index]
        pose = self.pose_list[index]
        if self.load_flow:
            return img1, img2, disp, pose, self.flow_list[index]
        return img1, img2, disp, pose

    def load_pair(self, index, rng: np.random.Generator):
        """Single-pair loading path (non-temporal datasets: ETH3D, Sintel,
        Middlebury, FallingThings, single-frame SceneFlow/TartanAir/KITTI —
        reference ``stereo_datasets.py:164-214``).

        Returns dict with image1/image2 (H,W,3) f32, flow (H,W,1), valid
        (H,W,1).
        """
        index = index % len(self.image_list)
        disp = self.disparity_reader(self.disparity_list[index])
        if isinstance(disp, tuple):
            disp, valid = disp
        else:
            valid = disp < 512
        img1 = frame_utils.read_image(self.image_list[index][0])
        img2 = frame_utils.read_image(self.image_list[index][1])
        disp = np.asarray(disp, np.float32)
        flow = -disp[..., None]
        valid = np.asarray(valid, np.float32)[..., None]

        if self.augmentor is not None:
            # The pair's K is dropped, so none is read: tcs_tpu reads
            # sample_K here, and single-frame SceneFlow, whose K list is
            # empty, raises IndexError there (datasets.py:149).
            s1, s2, f, v, _ = self.augmentor(
                img1[None], img2[None], flow[None], valid[None], np.eye(3), rng
            )
            img1, img2, flow, valid = s1[0], s2[0], f[0], v[0]
        return {
            "image1": np.asarray(img1, np.float32),
            "image2": np.asarray(img2, np.float32),
            "flow": np.asarray(flow, np.float32),
            "valid": np.asarray(valid, np.float32),
        }

    def load_sample(self, index, rng: np.random.Generator):
        """Load + augment one training sample.

        Temporal: returns dict with left/right (T,H,W,3) f32, flow (T,H,W,1),
        valid (T,H,W,1), T (T,4,4), K (3,3), baseline ().
        """
        assert self.temporal, "use load_pair for single-pair datasets"
        index = index % len(self.image_list)
        img1_paths, img2_paths = self.image_list[index]
        pose_list = self.pose_list[index]
        disp_paths = self.disparity_list[index]

        if self.index_by_scene:
            n = len(img1_paths)
            low = int(rng.integers(0, max(n - self.frame_sample_length, 1)))
            high = low + self.frame_sample_length
            img1_paths = img1_paths[low:high]
            img2_paths = img2_paths[low:high]
            disp_paths = disp_paths[low:high]
            pose_list = pose_list[low:high]
        T_seq = np.stack(pose_list, axis=0).astype(np.float32)

        lefts, rights, flows, valids = [], [], [], []
        for p1, p2, pd in zip(img1_paths, img2_paths, disp_paths):
            disp = self.disparity_reader(pd)
            if isinstance(disp, tuple):
                disp, valid = disp
            else:
                valid = disp < 512
            lefts.append(frame_utils.read_image(p1))
            rights.append(frame_utils.read_image(p2))
            disp = np.asarray(disp, np.float32)
            flows.append(-disp[..., None])
            valids.append(np.asarray(valid, np.float32)[..., None])

        seq1 = np.stack(lefts)
        seq2 = np.stack(rights)
        flow = np.stack(flows)
        valid = np.stack(valids)
        K = self.sample_K(index)

        if self.augmentor is not None:
            seq1, seq2, flow, valid, K = self.augmentor(
                seq1, seq2, flow, valid, K, rng
            )
        return {
            "image1": seq1.astype(np.float32),
            "image2": seq2.astype(np.float32),
            "flow": flow.astype(np.float32),
            "valid": valid.astype(np.float32),
            "T": T_seq,
            "K": K.astype(np.float32),
            "baseline": np.float32(self.baseline),
        }


def default_disp_reader(path):
    d = frame_utils.read_gen(path)
    return np.asarray(d, np.float32)


# ---------------------------------------------------------------------------
# SceneFlow
# ---------------------------------------------------------------------------

SCENEFLOW_K = np.array(
    [[1050.0, 0.0, 479.5], [0.0, 1050.0, 269.5], [0.0, 0.0, 1.0]]
)
SCENEFLOW_K_15MM = np.array(
    [[450.0, 0.0, 479.5], [0.0, 450.0, 269.5], [0.0, 0.0, 1.0]]
)


class SceneFlowDatasets(StereoSequenceDataset):
    """FlyingThings3D (+Monkaa+Driving for train). Reference :231-402."""

    def __init__(self, aug_params=None, root="datasets",
                 dstype="frames_cleanpass", things_test=False,
                 mode="single_frame", frame_sample_length=4):
        super().__init__(
            aug_params, temporal=(mode == "temporal"),
            frame_sample_length=frame_sample_length, is_test=things_test,
            index_by_scene=things_test,
        )
        self.root = root
        self.dstype = dstype
        self.intrinsic_K = []
        self.baseline = 1.0
        if things_test:
            self._add_things("TEST", mode == "temporal", frame_sample_length)
        else:
            self._add_things("TRAIN", mode == "temporal", frame_sample_length)
            self._add_monkaa(mode == "temporal", frame_sample_length)
            self._add_driving(mode == "temporal", frame_sample_length)

    def _windows(self, items, L):
        return [items[i : i + L] for i in range(len(items) - L + 1)]

    def _add_scene_windows(self, poses, scene, split_train, L, K_of):
        left = sorted(glob(osp.join(scene, "left/*.png")))
        right = [p.replace("left", "right") for p in left]
        disp = [p.replace(self.dstype, "disparity").replace(".png", ".pfm")
                for p in left]
        if len(left) - len(poses) == 1:  # trailing frame without pose
            left, right, disp = left[:-1], right[:-1], disp[:-1]
        if len(left) != len(poses):
            raise ValueError(f"{scene}: {len(left)} imgs vs {len(poses)} poses")
        if split_train:
            quads = zip(self._windows(left, L), self._windows(right, L),
                        self._windows(disp, L), self._windows(poses, L))
        else:
            quads = [(left, right, disp, poses)]
        for l, r, d, p in quads:
            self.image_list.append([l, r])
            self.disparity_list.append(d)
            self.pose_list.append(p)
            self.intrinsic_K.append(K_of(l))

    def _add_things(self, split, temporal, L):
        root = osp.join(self.root, "FlyingThings3D")
        if not temporal:
            n0 = len(self.disparity_list)
            left = sorted(glob(osp.join(root, self.dstype, split, "*/*/left/*.png")))
            right = [p.replace("left", "right") for p in left]
            disp = [p.replace(self.dstype, "disparity").replace(".png", ".pfm")
                    for p in left]
            # reference's fixed 400-image validation subset (:257-259)
            state = np.random.get_state()
            np.random.seed(1000)
            val_idxs = set(np.random.permutation(len(left))[:400])
            np.random.set_state(state)
            for idx, (l, r, d) in enumerate(zip(left, right, disp)):
                if (split == "TEST" and idx in val_idxs) or split == "TRAIN":
                    self.image_list.append([l, r])
                    self.disparity_list.append(d)
            logger.info("Added %d from FlyingThings %s",
                        len(self.disparity_list) - n0, self.dstype)
            return
        pose_ps = sorted(glob(osp.join(root, "pose", split, "*/*/camera_data.txt")))
        scenes = sorted(glob(osp.join(root, self.dstype, split, "*", "*")))
        for pose_p, scene in zip(pose_ps, scenes):
            poses = frame_utils.readsceneflow_pose(pose_p)
            self._add_scene_windows(poses, scene, split == "TRAIN", L,
                                    lambda l: SCENEFLOW_K.copy())

    def _add_monkaa(self, temporal, L):
        root = osp.join(self.root, "Monkaa")
        if not temporal:
            left = sorted(glob(osp.join(root, self.dstype, "*/left/*.png")))
            for l in left:
                r = l.replace("left", "right")
                d = l.replace(self.dstype, "disparity").replace(".png", ".pfm")
                self.image_list.append([l, r])
                self.disparity_list.append(d)
            return
        pose_ps = sorted(glob(osp.join(root, "pose", "*/camera_data.txt")))
        scenes = sorted(glob(osp.join(root, self.dstype, "*")))
        for pose_p, scene in zip(pose_ps, scenes):
            poses = frame_utils.readsceneflow_pose(pose_p)
            self._add_scene_windows(poses, scene, True, L,
                                    lambda l: SCENEFLOW_K.copy())

    def _add_driving(self, temporal, L):
        root = osp.join(self.root, "Driving")
        if not temporal:
            left = sorted(glob(osp.join(root, self.dstype, "*/*/*/left/*.png")))
            for l in left:
                r = l.replace("left", "right")
                d = l.replace(self.dstype, "disparity").replace(".png", ".pfm")
                self.image_list.append([l, r])
                self.disparity_list.append(d)
            return
        pose_ps = sorted(glob(osp.join(root, "pose", "*/*/*/camera_data.txt")))
        scenes = sorted(glob(osp.join(root, self.dstype, "*/*/*")))
        for pose_p, scene in zip(pose_ps, scenes):
            poses = frame_utils.readsceneflow_pose(pose_p)
            self._add_scene_windows(
                poses, scene, True, L,
                lambda l: (SCENEFLOW_K_15MM.copy()
                           if "15mm_focallength" in l[0] else SCENEFLOW_K.copy()),
            )


# ---------------------------------------------------------------------------
# TartanAir
# ---------------------------------------------------------------------------

TARTANAIR_K = np.array([[320.0, 0, 320.0], [0, 320.0, 240.0], [0, 0, 1]])
TARTANAIR_BASELINE = 0.25


class TartanAir(StereoSequenceDataset):
    """Reference :451-532. Temporal mode indexes whole P* videos with
    per-video oversampling len//300."""

    def __init__(self, aug_params=None, root="datasets", scene_list=(),
                 test_keywords=(), is_test=False, mode="single_frame",
                 frame_sample_length=4, load_flow=False):
        # ``scene_list`` is accepted-and-unused for signature parity with the
        # reference ctor (stereo_datasets.py:452), which likewise ignores it —
        # the train/valid split is driven solely by ``test_keywords``.
        super().__init__(
            aug_params, reader=frame_utils.readDispTartanAir,
            temporal=(mode == "temporal"),
            frame_sample_length=frame_sample_length, is_test=is_test,
            load_flow=load_flow, index_by_scene=True,
        )
        assert mode in ("single_frame", "temporal")
        self.baseline = TARTANAIR_BASELINE
        self.intrinsic_K = TARTANAIR_K
        if mode == "single_frame":
            i1 = sorted(glob(osp.join(root, "TartanAir/*/*/*/*/image_left/*_left.png")))
            i2 = sorted(glob(osp.join(root, "TartanAir/*/*/*/*/image_right/*_right.png")))
            dl = sorted(glob(osp.join(root, "TartanAir/*/*/*/*/depth_left/*_left_depth.npy")))
            i1 = self._pick(i1, test_keywords, is_test)
            i2 = self._pick(i2, test_keywords, is_test)
            dl = self._pick(dl, test_keywords, is_test)
            for a, b, d in zip(i1, i2, dl):
                self.image_list.append([a, b])
                self.disparity_list.append(d)
        else:
            videos = sorted(glob(osp.join(root, "TartanAir/*/*/*/P*")))
            videos = self._pick(videos, test_keywords, is_test)
            for v in videos:
                disp_frames = sorted(glob(osp.join(v, "depth_left/*_left_depth.npy")))
                left_frames = sorted(glob(osp.join(v, "image_left/*_left.png")))
                right_frames = sorted(glob(osp.join(v, "image_right/*_right.png")))
                pose_frames = frame_utils.read_tartanair_extrinsic(
                    osp.join(v, "pose_left.txt"), "left"
                )
                flow_frames = None
                if load_flow:
                    flow_frames = sorted(glob(osp.join(
                        v.replace("TartanAir", "TartanAir_flow"),
                        "flow/*_*_flow.npy")))
                    flow_frames.append(flow_frames[-1])
                # oversample long videos for uniform per-frame sampling (:503)
                rate = 1 if is_test else max(len(disp_frames) // 300, 1)
                for _ in range(rate):
                    self.image_list.append([left_frames, right_frames])
                    self.disparity_list.append(disp_frames)
                    self.pose_list.append(pose_frames)
                    if load_flow:
                        self.flow_list.append(flow_frames)

    @staticmethod
    def _pick(paths, keywords, want_test):
        """Split by keyword blacklist (reference split_train_valid :526)."""
        train = paths
        for kw in keywords:
            train = [p for p in train if kw not in p]
        if not want_test:
            return sorted(train)
        return sorted(set(paths) - set(train))


# TartanAir validation split used by the reference's evaluator
# (evaluate_stereo.py:126-133) and training split (stereo_datasets.py:703-710).
TARTANAIR_VAL_SCENES = [
    "abandonedfactory", "amusement", "carwelding", "endofworld", "gascola",
    "hospital", "office", "office2", "oldtown", "soulcity",
]
TARTANAIR_VAL_PARTS = [
    "P002", "P007", "P003", "P006", "P001", "P042", "P006", "P004", "P006",
    "P008",
]


def tartanair_test_keywords():
    kws = []
    for s, p in zip(TARTANAIR_VAL_SCENES, TARTANAIR_VAL_PARTS):
        kws.append(osp.join(s, "Easy", p))
        kws.append(osp.join(s, "Hard", p))
    return kws


# ---------------------------------------------------------------------------
# KITTI
# ---------------------------------------------------------------------------


class KITTI(StereoSequenceDataset):
    """KITTI 2015/2012. Temporal test sequences for submission
    (reference :535-578)."""

    def __init__(self, aug_params=None, root="datasets/KITTI", is_test=False,
                 mode="single_frame", frame_sample_length=4,
                 image_set="training", index_by_scene=False, num_frames=11):
        super().__init__(
            aug_params, sparse=True, reader=frame_utils.readDispKITTI,
            temporal=(mode == "temporal"),
            frame_sample_length=frame_sample_length, is_test=is_test,
            index_by_scene=index_by_scene,
        )
        self.baseline = 0.54
        if is_test:
            if mode != "temporal":
                raise NotImplementedError
            scene_list = sorted(glob(osp.join(root, image_set, "sequences", "*")))
            for scene in scene_list:
                i1 = sorted(glob(osp.join(scene, "image_2", "*.png")))[:num_frames]
                i2 = sorted(glob(osp.join(scene, "image_3", "*.png")))[:num_frames]
                poses = frame_utils.read_kitti_extrinsic(
                    osp.join(scene, "orbslam3_pose.txt")
                )[:num_frames]
                self.image_list.append([i1, i2])
                self.disparity_list.append(scene)  # scene path (no GT)
                self.pose_list.append(poses)
        else:
            if mode != "single_frame":
                raise NotImplementedError
            i1 = sorted(glob(osp.join(root, "Kitti15", image_set, "image_2/*_10.png")))
            i2 = sorted(glob(osp.join(root, "Kitti15", image_set, "image_3/*_10.png")))
            dl = sorted(glob(osp.join(root, "Kitti15", "training", "disp_occ_0/*_10.png")))
            i1 += sorted(glob(osp.join(root, "Kitti12", image_set, "image_0/*_10.png")))
            i2 += sorted(glob(osp.join(root, "Kitti12", image_set, "image_1/*_10.png")))
            dl += sorted(glob(osp.join(root, "Kitti12", "training", "disp_occ/*_10.png")))
            for a, b, d in zip(i1, i2, dl):
                self.image_list.append([a, b])
                self.disparity_list.append(d)


class KITTIraw(StereoSequenceDataset):
    """KITTI raw with LEAStereo pseudo-labels and OXTS-derived poses
    (reference :581-632)."""

    def __init__(self, aug_params=None, root="datasets/kitti_raw",
                 is_test=False, mode="single_frame", frame_sample_length=4):
        super().__init__(
            aug_params, sparse=True, reader=frame_utils.readDispKITTI,
            temporal=(mode == "temporal"),
            frame_sample_length=frame_sample_length, is_test=is_test,
        )
        self.baseline = 0.54
        self.intrinsic_K = []
        L = frame_sample_length
        single = mode == "single_frame"
        scenes = sorted(glob(osp.join(root, "*")))
        for scene in scenes:  # date dirs
            calib_path = osp.join(scene, "calib_cam_to_cam.txt")
            for seq in sorted(glob(osp.join(scene, "*_sync"))):
                i1 = sorted(glob(osp.join(seq, "image_02/data/*.png")))
                i2 = sorted(glob(osp.join(seq, "image_03/data/*.png")))
                dl = sorted(glob(osp.join(seq, "leastereo/data/*.png")))
                poses = frame_utils.read_kitti_extrinsic(osp.join(seq, "pose.txt"))
                if not (len(i1) == len(i2) == len(dl) == len(poses)):
                    logger.warning("%s: mismatched sequence lengths", seq)
                    continue
                K = frame_utils.intrinsics_from_p_rect(
                    frame_utils.read_calib_file(calib_path)["P_rect_02"]
                )
                if single:
                    # flat pairs (the reference's single_frame KITTIraw keeps
                    # the windowed lists and would crash in its single-pair
                    # __getitem__ — fixed here by indexing frames flat)
                    for a, b, d in zip(i1, i2, dl):
                        self.image_list.append([a, b])
                        self.disparity_list.append(d)
                        self.intrinsic_K.append(K)
                    continue
                for k in range(len(i1) - L + 1):
                    self.image_list.append([i1[k : k + L], i2[k : k + L]])
                    self.disparity_list.append(dl[k : k + L])
                    self.pose_list.append(poses[k : k + L])
                    self.intrinsic_K.append(K)


# ---------------------------------------------------------------------------
# Extra single-pair datasets
# ---------------------------------------------------------------------------


class ETH3D(StereoSequenceDataset):
    def __init__(self, aug_params=None, root="datasets/ETH3D", split="training"):
        super().__init__(aug_params, sparse=True)
        i1 = sorted(glob(osp.join(root, f"two_view_{split}/*/im0.png")))
        i2 = sorted(glob(osp.join(root, f"two_view_{split}/*/im1.png")))
        disp = sorted(glob(osp.join(root, "two_view_training_gt/*/disp0GT.pfm")))
        for a, b, d in zip(i1, i2, disp):
            self.image_list.append([a, b])
            self.disparity_list.append(d)


class SintelStereo(StereoSequenceDataset):
    def __init__(self, aug_params=None, root="datasets/SintelStereo"):
        super().__init__(aug_params, sparse=True,
                         reader=frame_utils.readDispSintelStereo)
        i1 = sorted(glob(osp.join(root, "training/*_left/*/frame_*.png")))
        i2 = sorted(glob(osp.join(root, "training/*_right/*/frame_*.png")))
        disp = sorted(glob(osp.join(root, "training/disparities/*/frame_*.png"))) * 2
        for a, b, d in zip(i1, i2, disp):
            self.image_list.append([a, b])
            self.disparity_list.append(d)


class FallingThings(StereoSequenceDataset):
    def __init__(self, aug_params=None, root="datasets/FallingThings"):
        super().__init__(aug_params, reader=frame_utils.readDispFallingThings)
        with open(osp.join(root, "filenames.txt")) as f:
            names = sorted(f.read().splitlines())
        for e in names:
            self.image_list.append([
                osp.join(root, e),
                osp.join(root, e.replace("left.jpg", "right.jpg")),
            ])
            self.disparity_list.append(
                osp.join(root, e.replace("left.jpg", "left.depth.png"))
            )


class Middlebury(StereoSequenceDataset):
    def __init__(self, aug_params=None, root="datasets/Middlebury", split="F"):
        super().__init__(aug_params, sparse=True,
                         reader=frame_utils.readDispMiddlebury)
        assert split in ("F", "H", "Q", "2014")
        if split == "2014":
            for scene in (Path(root) / "2014").glob("*"):
                for s in ("E", "L", ""):
                    self.image_list.append(
                        [str(scene / "im0.png"), str(scene / f"im1{s}.png")]
                    )
                    self.disparity_list.append(str(scene / "disp0.pfm"))
        else:
            names = list(map(osp.basename,
                             glob(osp.join(root, "MiddEval3/trainingF/*"))))
            official = Path(osp.join(root, "MiddEval3/official_train.txt"))
            if official.exists():
                keep = set(official.read_text().splitlines())
                names = [n for n in names if n in keep]
            for name in sorted(names):
                base = osp.join(root, "MiddEval3", f"training{split}", name)
                self.image_list.append(
                    [osp.join(base, "im0.png"), osp.join(base, "im1.png")]
                )
                self.disparity_list.append(osp.join(base, "disp0GT.pfm"))


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


class SinglePairAsSequence:
    """Adapter: a single-pair dataset served as T=1 temporal sequences.

    The temporal model's first-frame path IS single-frame stereo (cost-volume
    argmax bootstrap, no pose warp), so single-pair datasets (Sintel,
    FallingThings, Middlebury, ETH3D — reference fetch_dataloader's
    single-frame mixtures, stereo_datasets.py:666-702) train through the
    same frame-window training step with ``frame_length=1``. Pose is identity
    and K/baseline are nominal: neither is consumed on the first frame.

    Unlike the base class's ``__add__`` (which merges file lists under ONE
    reader — fine for same-class mixes like SceneFlow clean+final), this
    adapter concatenates whole datasets, so each keeps its own disparity
    reader and sparse/dense augmentor (torch ConcatDataset semantics).
    """

    def __init__(self, *datasets: StereoSequenceDataset,
                 baseline: float = 1.0):
        self.parts = list(datasets)
        self.baseline = baseline

    def __len__(self):
        return sum(len(p) for p in self.parts)

    def __mul__(self, v: int):
        return SinglePairAsSequence(*(self.parts * v),
                                    baseline=self.baseline)

    def __add__(self, other: "SinglePairAsSequence"):
        return SinglePairAsSequence(*self.parts, *other.parts,
                                    baseline=self.baseline)

    def load_sample(self, index, rng):
        for p in self.parts:
            if index < len(p):
                break
            index -= len(p)
        s = p.load_pair(index, rng)
        H, W = s["image1"].shape[:2]
        K = np.array([[1000.0, 0.0, W / 2], [0.0, 1000.0, H / 2],
                      [0.0, 0.0, 1.0]], np.float32)
        return {
            "image1": s["image1"][None],
            "image2": s["image2"][None],
            "flow": s["flow"][None],
            "valid": s["valid"][None],
            "T": np.eye(4, dtype=np.float32)[None],
            "K": K,
            "baseline": np.float32(self.baseline),
        }


def fetch_dataset(cfg) -> StereoSequenceDataset:
    """Build the training dataset mixture for a TrainConfig
    (reference ``fetch_dataloader``, stereo_datasets.py:659-736).

    Temporal recipes: 'sceneflow' (clean×4 + final×4), 'TartanAir' (×100),
    'kitti_raw'. Single-pair mixtures (reference single-frame branch) are
    available with frame_length=1 via '+'-separated names:
    'sintel_stereo' (×140), 'falling_things' (×5), 'middlebury_<split>',
    'eth3d' — e.g. train_dataset='sintel_stereo+falling_things'."""
    aug_params = {
        "crop_size": cfg.image_size,
        "min_scale": cfg.spatial_scale[0],
        "max_scale": cfg.spatial_scale[1],
        "do_flip": cfg.do_flip or False,
        "yjitter": cfg.yjitter,
    }
    if cfg.saturation_range is not None:
        aug_params["saturation_range"] = cfg.saturation_range
    if cfg.img_gamma is not None:
        aug_params["gamma"] = cfg.img_gamma

    name = cfg.train_dataset
    root = cfg.data_root
    temporal = getattr(cfg, "temporal", True)
    mode = "temporal" if temporal else "single_frame"
    if not temporal and cfg.frame_length != 1:
        raise ValueError(
            f"temporal=False (single-frame training) requires frame_length=1 "
            f"(got {cfg.frame_length}); single pairs carry no poses to warp "
            "across frames")
    if name == "sceneflow":
        clean = SceneFlowDatasets(dict(aug_params), root=root,
                                  dstype="frames_cleanpass", mode=mode,
                                  frame_sample_length=cfg.frame_length)
        final = SceneFlowDatasets(dict(aug_params), root=root,
                                  dstype="frames_finalpass", mode=mode,
                                  frame_sample_length=cfg.frame_length)
        if temporal:
            ds = (clean * 4) + (final * 4)
        else:
            ds = SinglePairAsSequence(clean * 4, final * 4, baseline=1.0)
    elif name == "TartanAir":
        # temporal oversamples ×100; single-frame ×1 (reference :713-716)
        ta = TartanAir(aug_params, root=root,
                       scene_list=TARTANAIR_VAL_SCENES,
                       test_keywords=tartanair_test_keywords(),
                       mode=mode,
                       frame_sample_length=cfg.frame_length)
        ds = ta * 100 if temporal else SinglePairAsSequence(
            ta, baseline=TARTANAIR_BASELINE)
    elif name == "kitti_raw":
        kr = KITTIraw(aug_params, root=osp.join(root, "kitti_raw"),
                      mode=mode, frame_sample_length=cfg.frame_length)
        ds = kr if temporal else SinglePairAsSequence(kr, baseline=0.54)
    elif "kitti" in name:
        # KITTI 2015+2012 GT fine-tune (reference stereo_datasets.py:691-696;
        # its temporal KITTI train branch raises NotImplementedError, so this
        # config is single-frame only).
        if temporal:
            raise NotImplementedError(
                "KITTI 2015/2012 GT training is single-frame only "
                "(set temporal=False, frame_length=1); temporal KITTI exists "
                "only as test sequences for submission")
        ds = SinglePairAsSequence(
            KITTI(dict(aug_params), root=osp.join(root, "KITTI"),
                  mode="single_frame"),
            baseline=0.54)
    else:
        # Single-pair mixture (reference single-frame branch,
        # stereo_datasets.py:666-702): '+'-separated names, frame_length 1.
        parts = name.split("+")
        builders = {
            "sintel_stereo": lambda: SinglePairAsSequence(
                SintelStereo(dict(aug_params),
                             root=osp.join(root, "SintelStereo")) * 140),
            "falling_things": lambda: SinglePairAsSequence(
                FallingThings(dict(aug_params),
                              root=osp.join(root, "FallingThings")) * 5),
            "eth3d": lambda: SinglePairAsSequence(
                ETH3D(dict(aug_params), root=osp.join(root, "ETH3D"))),
        }

        def build(part):
            if part in builders:
                return builders[part]()
            if part.startswith("middlebury_"):
                return SinglePairAsSequence(
                    Middlebury(dict(aug_params),
                               root=osp.join(root, "Middlebury"),
                               split=part.replace("middlebury_", "")))
            raise NotImplementedError(f"dataset {part}")

        if cfg.frame_length != 1:
            raise ValueError(
                f"single-pair dataset mixture {name!r} requires "
                f"frame_length=1 (got {cfg.frame_length}); the pairs carry "
                "no poses to warp across frames")
        ds = build(parts[0])
        for part in parts[1:]:
            ds = ds + build(part)
    logger.info("Training with %d sequence samples", len(ds))
    return ds
