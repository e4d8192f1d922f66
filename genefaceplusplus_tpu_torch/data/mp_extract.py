"""Mediapipe feature extractors: 478-point face landmarks and multiclass
selfie segmentation (port of `genefaceplusplus_tpu/data/mp_extract.py`).

  * `MediapipeLandmarker` (face_landmarker.py:44-126): every frame is
    landmarked in IMAGE mode (temporally independent: sharp mouth and eye
    articulation) and in VIDEO mode (temporally smoothed: a stable head
    pose), and `fuse_img_vid_lm478` takes the mouth and eyes from the first
    and the rest from the second.
  * `MediapipeSegmenter` (mp_segmenter.py:156-228): the 6-class selfie
    segmentation, IMAGE or VIDEO running mode.

mediapipe is optional and imported only when an extractor is made; without
it the extractors raise the JAX package's actionable RuntimeError, and
`data/process.py`'s steps fall back to precomputed `lms_2d.npy` and
`segmaps/*.png`. The model files are read locally (default
`data/mp_models/`); nothing is downloaded.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from genefaceplusplus_tpu_torch.data.landmarks import (
    INDEX_EYE_FROM_LM478,
    INDEX_INNERLIP_FROM_LM478,
    INDEX_OUTERLIP_FROM_LM478,
)
from genefaceplusplus_tpu_torch.data.segmenter import NUM_CLASSES, onehot_from_categories

LANDMARKER_MODEL = "face_landmarker.task"
SEGMENTER_MODEL = "selfie_multiclass_256x256.tflite"

# mouth region for the image-mode override: inner + outer lips + the ring of
# within-mouth points (face_landmarker.py:19-21)
INDEX_WITHINMOUTH_FROM_LM478 = (
    [76, 62]
    + [184, 183, 74, 72, 73, 41, 72, 38, 11, 12, 302, 268, 303, 271, 304, 272, 408, 407]
    + [292, 306]
    + [325, 307, 319, 320, 403, 404, 316, 315, 15, 16, 86, 85, 179, 180, 89, 90, 96, 77]
)
INDEX_MOUTH_FROM_LM478 = (
    INDEX_INNERLIP_FROM_LM478 + INDEX_OUTERLIP_FROM_LM478 + INDEX_WITHINMOUTH_FROM_LM478
)


def _require_mediapipe():
    try:
        import mediapipe as mp
        from mediapipe.tasks import python as mp_python
        from mediapipe.tasks.python import vision
    except ImportError as e:
        raise RuntimeError(
            "mediapipe is not installed in this environment. Either install "
            "it, or provide precomputed artifacts (lms_2d.npy for landmarks, "
            "segmaps/*.png for segmentation) and skip these steps."
        ) from e
    return mp, mp_python, vision


def _resolve_model(model_path: Optional[str], default_name: str) -> str:
    path = model_path or os.path.join("data", "mp_models", default_name)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"mediapipe model not found at {path}; download {default_name} "
            "from the mediapipe model zoo and place it there (this "
            "environment has no network egress)."
        )
    return path


def fuse_img_vid_lm478(img_lm478: np.ndarray, vid_lm478: np.ndarray) -> np.ndarray:
    """Per-region fusion: articulate regions (mouth, eyes) from the
    temporally-independent image mode; everything else from the smoothed
    video mode (face_landmarker.py:118-126)."""
    out = vid_lm478.copy()
    out[:, INDEX_MOUTH_FROM_LM478] = img_lm478[:, INDEX_MOUTH_FROM_LM478]
    out[:, INDEX_EYE_FROM_LM478] = img_lm478[:, INDEX_EYE_FROM_LM478]
    return out


class MediapipeLandmarker:
    """478-pt face landmarks with dual IMAGE+VIDEO mode detection."""

    def __init__(self, model_path: Optional[str] = None):
        mp, mp_python, vision = _require_mediapipe()
        self._mp, self._vision = mp, vision
        base = mp_python.BaseOptions(model_asset_path=_resolve_model(model_path, LANDMARKER_MODEL))
        self.image_options = vision.FaceLandmarkerOptions(
            base_options=base, running_mode=vision.RunningMode.IMAGE, num_faces=1
        )
        self.video_options = vision.FaceLandmarkerOptions(
            base_options=base, running_mode=vision.RunningMode.VIDEO, num_faces=1
        )

    def _landmarks_or_none(self, result) -> Optional[np.ndarray]:
        if not result.face_landmarks:
            return None
        return np.asarray([[l.x, l.y] for l in result.face_landmarks[0]], np.float32)

    def extract_lm478_from_frames(
        self, frames: Sequence[np.ndarray], fps: int = 25, anti_smooth_factor: int = 20
    ) -> Tuple[np.ndarray, np.ndarray]:
        """frames: RGB uint8 [H, W, 3] each. Returns (img_lm478, vid_lm478)
        in PIXEL coords [T, 478, 2].

        anti_smooth_factor stretches the video-mode timestamps so its
        temporal smoothing is weakened (1 = native video smoothing; large =
        approaches image mode)."""
        mp, vision = self._mp, self._vision
        img_det = vision.FaceLandmarker.create_from_options(self.image_options)
        vid_det = vision.FaceLandmarker.create_from_options(self.video_options)
        img_out: List[np.ndarray] = []
        vid_out: List[np.ndarray] = []
        last_img = last_vid = None
        H, W = np.asarray(frames[0]).shape[:2]
        for i, frame in enumerate(frames):
            image = mp.Image(image_format=mp.ImageFormat.SRGB, data=np.asarray(frame, np.uint8))
            ts = int((1000.0 / fps) * anti_smooth_factor * i)
            lm_i = self._landmarks_or_none(img_det.detect(image))
            lm_v = self._landmarks_or_none(vid_det.detect_for_video(image, ts))
            if lm_i is None or lm_v is None:
                # detection dropout: hold the previous frame's landmarks
                print(f"| WARNING: no face detected at frame {i}; reusing previous")
                lm_i = lm_i if lm_i is not None else last_img
                lm_v = lm_v if lm_v is not None else last_vid
                if lm_i is None or lm_v is None:
                    raise RuntimeError(f"no face detected in the first frame(s) (i={i})")
            last_img, last_vid = lm_i, lm_v
            img_out.append(lm_i)
            vid_out.append(lm_v)
        scale = np.asarray([W, H], np.float32)
        return np.stack(img_out) * scale, np.stack(vid_out) * scale

    def extract_fused_lm478(self, frames: Sequence[np.ndarray], fps: int = 25) -> np.ndarray:
        img478, vid478 = self.extract_lm478_from_frames(frames, fps=fps)
        return fuse_img_vid_lm478(img478, vid478)


class MediapipeSegmenter:
    """Multiclass selfie segmentation -> [6, H, W] one-hot segmaps."""

    def __init__(self, model_path: Optional[str] = None):
        mp, mp_python, vision = _require_mediapipe()
        self._mp, self._vision = mp, vision
        base = mp_python.BaseOptions(model_asset_path=_resolve_model(model_path, SEGMENTER_MODEL))
        self.image_options = vision.ImageSegmenterOptions(
            base_options=base, running_mode=vision.RunningMode.IMAGE, output_category_mask=True
        )
        self.video_options = vision.ImageSegmenterOptions(
            base_options=base, running_mode=vision.RunningMode.VIDEO, output_category_mask=True
        )

    def segment_image(self, img: np.ndarray, segmenter=None) -> np.ndarray:
        """img: RGB uint8 [H, W, 3] -> [6, H, W] one-hot uint8."""
        mp, vision = self._mp, self._vision
        seg = segmenter or vision.ImageSegmenter.create_from_options(self.image_options)
        image = mp.Image(image_format=mp.ImageFormat.SRGB, data=np.asarray(img, np.uint8))
        cat = seg.segment(image).category_mask.numpy_view().copy()
        return onehot_from_categories(cat.astype(np.int64), NUM_CLASSES)

    def segment_video(self, frames: Sequence[np.ndarray], fps: int = 25) -> List[np.ndarray]:
        mp, vision = self._mp, self._vision
        seg = vision.ImageSegmenter.create_from_options(self.video_options)
        out = []
        for i, frame in enumerate(frames):
            image = mp.Image(image_format=mp.ImageFormat.SRGB, data=np.asarray(frame, np.uint8))
            cat = seg.segment_for_video(image, int(1000.0 / fps) * i).category_mask.numpy_view().copy()
            out.append(onehot_from_categories(cat.astype(np.int64), NUM_CLASSES))
        return out
