"""Dataset indexers for the temporal evaluators (the port's copy of the test
side of ``tcs_tpu/data/datasets.py``; reference ``core/stereo_datasets.py``).

Each dataset indexes whole test sequences: per sequence the left and right
frame paths, the ground-truth paths (for KITTI the scene directory) and the
world→camera poses; ``test_sequence(i)`` hands one to an evaluator. The
constructors keep ``tcs_tpu``'s signatures; the arguments that only sampling
and augmentation read are accepted and unused. The training side
(augmentation, ``load_sample``, the training splits, KITTI raw and the
single-pair datasets) comes with ROADMAP Queue 1, item 4, and every use of it
raises ``NotImplementedError`` here.

- ``SceneFlowDatasets(things_test=True, mode="temporal")``: FlyingThings3D
  TEST scenes (reference :231, ``tcs_tpu`` :234-305);
- ``TartanAir(is_test=True, mode="temporal")`` with
  :func:`tartanair_test_keywords` (reference :451, ``tcs_tpu`` :352-441);
- ``KITTI(is_test=True, mode="temporal")``: the sequences of the KITTI 2015
  submission (reference :535, ``tcs_tpu`` :442-482).
"""

from __future__ import annotations

import os.path as osp
from glob import glob
from typing import List, Optional

import numpy as np

from tcs_tpu_torch.data import frame_utils


def _training_side(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: the port's datasets index test sequences only; the training"
        " side of the data comes with ROADMAP Queue 1, item 4")


class StereoSequenceDataset:
    """An index of stereo test sequences (``tcs_tpu`` :46-127)."""

    def __init__(self, aug_params=None, load_flow=False):
        if aug_params is not None:
            raise _training_side("aug_params")
        self.load_flow = load_flow
        self.image_list: List = []  # [(left paths, right paths)]
        self.disparity_list: List = []
        self.pose_list: List = []
        self.flow_list: List = []
        self.intrinsic_K = None  # np (3,3) or list of (3,3)
        self.baseline: Optional[float] = None

    def __len__(self):
        return len(self.image_list)

    def sample_K(self, index) -> np.ndarray:
        if isinstance(self.intrinsic_K, list):
            return np.asarray(self.intrinsic_K[index], np.float64).copy()
        return np.asarray(self.intrinsic_K, np.float64).copy()

    def test_sequence(self, index):
        """Path lists of one sequence for streaming evaluation (reference
        temporal test branch, :75-81)."""
        img1, img2 = self.image_list[index]
        disp = self.disparity_list[index]
        pose = self.pose_list[index]
        if self.load_flow:
            return img1, img2, disp, pose, self.flow_list[index]
        return img1, img2, disp, pose

    def load_pair(self, index, rng=None):
        raise _training_side("load_pair")

    def load_sample(self, index, rng=None):
        raise _training_side("load_sample")


# ---------------------------------------------------------------------------
# SceneFlow
# ---------------------------------------------------------------------------

SCENEFLOW_K = np.array(
    [[1050.0, 0.0, 479.5], [0.0, 1050.0, 269.5], [0.0, 0.0, 1.0]]
)


class SceneFlowDatasets(StereoSequenceDataset):
    """FlyingThings3D TEST, one whole scene per sequence (reference
    :231-402)."""

    def __init__(self, aug_params=None, root="datasets",
                 dstype="frames_cleanpass", things_test=False,
                 mode="single_frame", frame_sample_length=4):
        if not (things_test and mode == "temporal"):
            raise _training_side(f"SceneFlowDatasets(things_test={things_test},"
                                 f" mode={mode!r})")
        super().__init__(aug_params)
        self.root = root
        self.dstype = dstype
        self.intrinsic_K = []
        self.baseline = 1.0
        self._add_things("TEST")

    def _add_scene(self, poses, scene):
        left = sorted(glob(osp.join(scene, "left/*.png")))
        right = [p.replace("left", "right") for p in left]
        disp = [p.replace(self.dstype, "disparity").replace(".png", ".pfm")
                for p in left]
        if len(left) - len(poses) == 1:  # trailing frame without pose
            left, right, disp = left[:-1], right[:-1], disp[:-1]
        if len(left) != len(poses):
            raise ValueError(f"{scene}: {len(left)} imgs vs {len(poses)} poses")
        self.image_list.append([left, right])
        self.disparity_list.append(disp)
        self.pose_list.append(poses)
        self.intrinsic_K.append(SCENEFLOW_K.copy())

    def _add_things(self, split):
        root = osp.join(self.root, "FlyingThings3D")
        pose_ps = sorted(glob(osp.join(root, "pose", split, "*/*/camera_data.txt")))
        scenes = sorted(glob(osp.join(root, self.dstype, split, "*", "*")))
        for pose_p, scene in zip(pose_ps, scenes):
            self._add_scene(frame_utils.readsceneflow_pose(pose_p), scene)


# ---------------------------------------------------------------------------
# TartanAir
# ---------------------------------------------------------------------------

TARTANAIR_K = np.array([[320.0, 0, 320.0], [0, 320.0, 240.0], [0, 0, 1]])
TARTANAIR_BASELINE = 0.25


class TartanAir(StereoSequenceDataset):
    """The held-out TartanAir videos, one P* video per sequence (reference
    :451-532)."""

    def __init__(self, aug_params=None, root="datasets", scene_list=(),
                 test_keywords=(), is_test=False, mode="single_frame",
                 frame_sample_length=4, load_flow=False):
        # ``scene_list`` is accepted and unused, as in the reference
        # (stereo_datasets.py:452): the split follows ``test_keywords``.
        if not (is_test and mode == "temporal"):
            raise _training_side(f"TartanAir(is_test={is_test}, mode={mode!r})")
        super().__init__(aug_params, load_flow=load_flow)
        self.baseline = TARTANAIR_BASELINE
        self.intrinsic_K = TARTANAIR_K
        videos = sorted(glob(osp.join(root, "TartanAir/*/*/*/P*")))
        for v in self._pick(videos, test_keywords):
            self.image_list.append([sorted(glob(osp.join(v, "image_left/*_left.png"))),
                                    sorted(glob(osp.join(v, "image_right/*_right.png")))])
            self.disparity_list.append(
                sorted(glob(osp.join(v, "depth_left/*_left_depth.npy"))))
            self.pose_list.append(frame_utils.read_tartanair_extrinsic(
                osp.join(v, "pose_left.txt"), "left"))
            if load_flow:
                flow_frames = sorted(glob(osp.join(
                    v.replace("TartanAir", "TartanAir_flow"), "flow/*_*_flow.npy")))
                flow_frames.append(flow_frames[-1])
                self.flow_list.append(flow_frames)

    @staticmethod
    def _pick(paths, keywords):
        """The videos that some keyword names (reference split_train_valid
        :526, its validation side)."""
        train = paths
        for kw in keywords:
            train = [p for p in train if kw not in p]
        return sorted(set(paths) - set(train))


# TartanAir validation split used by the reference's evaluator
# (evaluate_stereo.py:126-133).
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
    """The KITTI 2015 submission's temporal test sequences (reference
    :535-578): the first ``num_frames`` frames of each scene."""

    def __init__(self, aug_params=None, root="datasets/KITTI", is_test=False,
                 mode="single_frame", frame_sample_length=4,
                 image_set="training", index_by_scene=False, num_frames=11):
        if not (is_test and mode == "temporal"):
            raise _training_side(f"KITTI(is_test={is_test}, mode={mode!r})")
        super().__init__(aug_params)
        self.baseline = 0.54
        for scene in sorted(glob(osp.join(root, image_set, "sequences", "*"))):
            i1 = sorted(glob(osp.join(scene, "image_2", "*.png")))[:num_frames]
            i2 = sorted(glob(osp.join(scene, "image_3", "*.png")))[:num_frames]
            poses = frame_utils.read_kitti_extrinsic(
                osp.join(scene, "orbslam3_pose.txt"))[:num_frames]
            self.image_list.append([i1, i2])
            self.disparity_list.append(scene)  # scene path (no GT)
            self.pose_list.append(poses)
