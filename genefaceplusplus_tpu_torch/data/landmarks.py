"""Landmark index tables, eye-area measures and blink editing (numpy copy
of `genefaceplusplus_tpu/data/landmarks.py`).

The tables are the standard MediaPipe FaceMesh topology: the 478 -> 68,
131 and 141-point subsets, and the eye, lip and unmatched-boundary sets the
3DMM fit weights (`data/fit_3dmm.py`); blink injection follows the
reference's inference (genefacepp_infer.py:81-114).
"""

from __future__ import annotations

import numpy as np

# fmt: off
INDEX_LM68_FROM_LM478 = [
    127, 234, 93, 132, 58, 136, 150, 176, 152, 400, 379, 365, 288, 361, 323, 454, 356,
    70, 63, 105, 66, 107, 336, 296, 334, 293, 300, 168, 197, 5, 4, 75, 97, 2, 326, 305,
    33, 160, 158, 133, 153, 144, 362, 385, 387, 263, 373, 380, 61, 40, 37, 0, 267, 270,
    291, 321, 314, 17, 84, 91, 78, 81, 13, 311, 308, 402, 14, 178,
]
INDEX_LM131_FROM_LM478 = (
    [70, 63, 105, 66, 107, 55, 65, 52, 53, 46]
    + [300, 293, 334, 296, 336, 285, 295, 282, 283, 276]
    + [33, 246, 161, 160, 159, 158, 157, 173, 133, 155, 154, 153, 145, 144, 163, 7]
    + [263, 466, 388, 387, 386, 385, 384, 398, 362, 382, 381, 380, 374, 373, 390, 249]
    + [78, 191, 80, 81, 82, 13, 312, 311, 310, 415, 308, 324, 318, 402, 317, 14, 87, 178, 88, 95]
    + [61, 185, 40, 39, 37, 0, 267, 269, 270, 409, 291, 375, 321, 405, 314, 17, 84, 181, 91, 146]
    + [10, 338, 297, 332, 284, 251, 389, 356, 454, 323, 361, 288, 397, 365, 379, 378, 400, 377,
       152, 148, 176, 149, 150, 136, 172, 58, 132, 93, 234, 127, 162, 21, 54, 103, 67, 109]
    + [64, 4, 294]
)
INDEX_LM141_FROM_LM478 = (
    INDEX_LM131_FROM_LM478[:-3]
    + [468, 469, 470, 471, 472] + [473, 474, 475, 476, 477] + [64, 4, 294]
)
INDEX_EYE_FROM_LM478 = (
    [33, 246, 161, 160, 159, 158, 157, 173, 133, 155, 154, 153, 145, 144, 163, 7]
    + [263, 466, 388, 387, 386, 385, 384, 398, 362, 382, 381, 380, 374, 373, 390, 249]
)
INDEX_INNERLIP_FROM_LM478 = [78, 191, 80, 81, 82, 13, 312, 311, 310, 415, 308, 324, 318, 402, 317, 14, 87, 178, 88, 95]
INDEX_OUTERLIP_FROM_LM478 = [61, 185, 40, 39, 37, 0, 267, 269, 270, 409, 291, 375, 321, 405, 314, 17, 84, 181, 91, 146]
UNMATCH_MASK_FROM_LM478 = [93, 127, 132, 234, 323, 356, 361, 454]
# fmt: on

INDEX_YAW_FROM_LM68 = list(range(0, 17))
INDEX_BROW_FROM_LM68 = list(range(17, 27))
INDEX_NOSE_FROM_LM68 = list(range(27, 36))
INDEX_EYE_FROM_LM68 = list(range(36, 48))
INDEX_MOUTH_FROM_LM68 = list(range(48, 68))


def polygon_area(xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """Shoelace area; xs/ys [..., K]."""
    x1 = np.roll(xs, -1, axis=-1)
    y1 = np.roll(ys, -1, axis=-1)
    return 0.5 * np.abs((xs * y1 - x1 * ys).sum(-1))


def get_eye_area_percent(lm68: np.ndarray) -> np.ndarray:
    """Eye openness proxy: polygon area of the 12 eye landmarks relative to
    a face-scale box (extract_blink.py semantics, adapted to lm68 domain)."""
    eye = lm68[..., INDEX_EYE_FROM_LM68, :2]
    area = polygon_area(eye[..., :6, 0], eye[..., :6, 1]) + polygon_area(eye[..., 6:, 0], eye[..., 6:, 1])
    face_w = lm68[..., 16, 0] - lm68[..., 0, 0]
    face_h = lm68[..., 8, 1] - lm68[..., 27, 1]
    denom = np.abs(face_w * face_h) + 1e-8
    return (area / denom) * 100.0


def inject_blink_to_lm68(
    lm68: np.ndarray,
    opened_eye_area_percent: float = 0.6,
    closed_eye_area_percent: float = 0.15,
    period: int = 100,
):
    """Periodic blink editing of canonical lm68 (genefacepp_infer.py:81-114).

    lm68: [T, 68, 3] canonical landmarks (modified copy returned).
    Returns (lm68, eye_area_percent [T, 1]).
    """
    lm68 = np.array(lm68, copy=True)
    T = len(lm68)
    eye_area_percent = np.full((T, 1), opened_eye_area_percent, lm68.dtype)

    # widen the eyes slightly, then derive the closed-eye pose from the eye corners
    lm68[:, [37, 38, 43, 44], 1] += 0.03
    lm68[:, [41, 40, 47, 46], 1] -= 0.03
    closed = lm68.copy()
    closed[:, 37] = closed[:, 41] = closed[:, 36] * 0.67 + closed[:, 39] * 0.33
    closed[:, 38] = closed[:, 40] = closed[:, 36] * 0.33 + closed[:, 39] * 0.67
    closed[:, 43] = closed[:, 47] = closed[:, 42] * 0.67 + closed[:, 45] * 0.33
    closed[:, 44] = closed[:, 46] = closed[:, 42] * 0.33 + closed[:, 45] * 0.67

    blink_curve = np.array([0.1, 0.5, 0.7, 1.0, 0.7, 0.5, 0.1])
    for i in range(T):
        if (i + 25) % period == 0:
            for j, f in enumerate(blink_curve):
                idx = i + j
                if idx > T - 1:
                    break
                lm68[idx, 36:48] = lm68[idx, 36:48] * (1 - f) + closed[idx, 36:48] * f
                eye_area_percent[idx] = opened_eye_area_percent * (1 - f) + closed_eye_area_percent * f
    return lm68, eye_area_percent


def recompose_lm68_regions(normalized: np.ndarray) -> np.ndarray:
    """Freeze the first frame's landmarks except brow/eye/nose/mouth/yaw,
    which track the prediction (genefacepp_infer.py:411-418)."""
    out = np.tile(normalized[0:1], (len(normalized), 1, 1))
    for region in (INDEX_BROW_FROM_LM68, INDEX_EYE_FROM_LM68, INDEX_NOSE_FROM_LM68,
                   INDEX_MOUTH_FROM_LM68, INDEX_YAW_FROM_LM68):
        out[:, region] = normalized[:, region]
    return out
