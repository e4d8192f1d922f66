"""Debug visualisation: landmark overlays, the 3DMM fit's check video and the
camera-trajectory panel (port of `genefaceplusplus_tpu/data/visualization.py`,
which draws with cv2).

The drawing is OpenCV's own integer rasterisation, in numpy, pixel for pixel
(`tests/test_torch_debug_panels.py`):
  * `circle_filled`: cv2.circle(..., thickness=-1) with LINE_8, OpenCV's
    midpoint circle filled by horizontal spans;
  * `line`: cv2.line with LINE_8, OpenCV's Bresenham (LineIterator) at
    thickness 1, and at thickness > 1 its ThickLine: a convex polygon in
    16.16 fixed point (edges by OpenCV's Line2, spans by FillConvexPoly)
    with round caps of radius thickness / 2. Lines are drawn as OpenCV
    draws them where both ends lie inside the image; a line that leaves it
    is cut pixel by pixel here, where OpenCV clips it first (the panels draw
    none such);
  * `rectangle`: cv2.rectangle's four thin lines.

`put_text` is not cv2.putText: OpenCV's Hershey glyphs are compiled into
the library, so labels are drawn with the port's own 3x5 bitmap font inside
the box cv2.getTextSize gives the same text (ROADMAP.md queue C).
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np

_S = 16  # OpenCV's XY_SHIFT
_ONE = 1 << _S


def _put(img: np.ndarray, x: int, y: int, color) -> None:
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = color


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color) -> None:
    if 0 <= y < img.shape[0]:
        x1, x2 = max(x1, 0), min(x2, img.shape[1] - 1)
        if x1 <= x2:
            img[y, x1:x2 + 1] = color


def circle_filled(img: np.ndarray, center, radius: int, color) -> None:
    """cv2.circle(img, center, radius, color, -1) (LINE_8), in place."""
    cx, cy = int(center[0]), int(center[1])
    err, dx, dy, plus, minus = 0, int(radius), 0, 1, (int(radius) << 1) - 1
    while dx >= dy:
        _hline(img, cy - dy, cx - dx, cx + dx, color)
        _hline(img, cy + dy, cx - dx, cx + dx, color)
        _hline(img, cy - dx, cx - dy, cx + dy, color)
        _hline(img, cy + dx, cx - dy, cx + dy, color)
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2


def _line_thin(img: np.ndarray, p1, p2, color) -> None:
    """OpenCV's 8-connected LineIterator from p1 to p2 (left to right)."""
    (x1, y1), (x2, y2) = (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1]))
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy, sy = x2 - x1, y2 - y1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err, x, y = dx - 2 * dy, x1, y1
    for _ in range(dx + 1):
        _put(img, x, y, color)
        if err < 0:
            err += 2 * dx
            if vert:
                x += 1
            else:
                y += sy
        err -= 2 * dy
        if vert:
            y += sy
        else:
            x += 1


def _cdiv(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _line_fixed(img: np.ndarray, p1, p2, color) -> None:
    """OpenCV's Line2: a 16.16 fixed-point line, both ends drawn."""
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            x1, y1, x2, y2, dy = x2, y2, x1, y1, -dy
        step = _cdiv(dy * _ONE, ax | 1)
        count = (x2 - x1) >> _S
    else:
        if dy < 0:
            x1, y1, x2, y2, dx = x2, y2, x1, y1, -dx
        step = _cdiv(dx * _ONE, ay | 1)
        count = (y2 - y1) >> _S
    x1 += _ONE >> 1
    y1 += _ONE >> 1
    _put(img, (x2 + (_ONE >> 1)) >> _S, (y2 + (_ONE >> 1)) >> _S, color)
    if ax > ay:
        x1 >>= _S
        for _ in range(count + 1):
            _put(img, x1, y1 >> _S, color)
            x1 += 1
            y1 += step
    else:
        y1 >>= _S
        for _ in range(count + 1):
            _put(img, x1 >> _S, y1, color)
            x1 += step
            y1 += 1


def _fill_convex(img: np.ndarray, v, color) -> None:
    """OpenCV's FillConvexPoly for 16.16 fixed-point vertices (LINE_8)."""
    H, W = img.shape[:2]
    n, half = len(v), _ONE >> 1
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin, p0 = 0, v[-1]
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax, xmax, xmin = max(ymax, p[1]), max(xmax, p[0]), min(xmin, p[0])
        _line_fixed(img, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + half) >> _S, (xmax + half) >> _S
    ymin, ymax = (ymin + half) >> _S, (ymax + half) >> _S
    if xmax < 0 or ymax < 0 or xmin >= W or ymin >= H:
        return
    ymax = min(ymax, H - 1)
    edges = [{"idx": imin, "di": 1, "x": -_ONE, "dx": 0, "ye": ymin},
             {"idx": imin, "di": n - 1, "x": -_ONE, "dx": 0, "ye": ymin}]
    y, left = ymin, n
    while True:
        for e in edges:
            if y < e["ye"]:
                continue
            idx0 = e["idx"]
            idx = (idx0 + e["di"]) % n
            while True:
                left -= 1
                if left < 0:
                    break
                ty = (v[idx][1] + half) >> _S
                if ty > y:
                    xs, xe = v[idx0][0], v[idx][0]
                    e.update(ye=ty, x=xs, idx=idx, dx=_cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y)))
                    break
                idx0, idx = idx, (idx + e["di"]) % n
        if left < 0:
            break
        if y >= 0:
            lo, hi = sorted((edges[0]["x"], edges[1]["x"]))
            _hline(img, y, (lo + half) >> _S, (hi + half) >> _S, color)
        edges[0]["x"] += edges[0]["dx"]
        edges[1]["x"] += edges[1]["dx"]
        y += 1
        if y > ymax:
            break


def line(img: np.ndarray, p1, p2, color, thickness: int = 1) -> None:
    """cv2.line(img, p1, p2, color, thickness) (LINE_8), in place."""
    if thickness <= 1:
        _line_thin(img, p1, p2, color)
        return
    q0 = (int(p1[0]) << _S, int(p1[1]) << _S)
    q1 = (int(p2[0]) << _S, int(p2[1]) << _S)
    dx, dy = (q0[0] - q1[0]) / _ONE, (q1[1] - q0[1]) / _ONE
    r = dx * dx + dy * dy
    half_width = thickness << (_S - 1)
    if r > 2.220446049250313e-16:
        r = (half_width + (thickness & 1) * _ONE * 0.5) / math.sqrt(r)
        ex, ey = int(round(dy * r)), int(round(dx * r))  # cvRound: both rounds are half-even
        _fill_convex(img, [(q0[0] + ex, q0[1] + ey), (q0[0] - ex, q0[1] - ey),
                           (q1[0] - ex, q1[1] - ey), (q1[0] + ex, q1[1] + ey)], color)
    for q in (q0, q1):  # round caps
        circle_filled(img, ((q[0] + (_ONE >> 1)) >> _S, (q[1] + (_ONE >> 1)) >> _S),
                      (half_width + (_ONE >> 1)) >> _S, color)


def rectangle(img: np.ndarray, p1, p2, color) -> None:
    """cv2.rectangle(img, p1, p2, color, 1), in place."""
    (x1, y1), (x2, y2) = p1, p2
    for a, b in (((x1, y1), (x2, y1)), ((x2, y1), (x2, y2)), ((x2, y2), (x1, y2)), ((x1, y2), (x1, y1))):
        _line_thin(img, a, b, color)


# 3x5 glyphs, one string of 15 cells a character (rows top to bottom)
_FONT = {
    "A": "010101111101101", "B": "110101110101110", "C": "011100100100011", "D": "110101101101110",
    "E": "111100110100111", "F": "111100110100100", "G": "011100101101011", "H": "101101111101101",
    "I": "111010010010111", "J": "001001001101010", "K": "101101110101101", "L": "100100100100111",
    "M": "101111111101101", "N": "110101101101101", "O": "010101101101010", "P": "110101110100100",
    "Q": "010101101110011", "R": "110101110101101", "S": "011100010001110", "T": "111010010010010",
    "U": "101101101101111", "V": "101101101101010", "W": "101101111111101", "X": "101101010101101",
    "Y": "101101010010010", "Z": "111001010100111", "0": "111101101101111", "1": "010110010010111",
    "2": "110001010100111", "3": "110001010001110", "4": "101101111001001", "5": "111100110001110",
    "6": "011100111101111", "7": "111001010010010", "8": "111101111101111", "9": "111101111001110",
    "(": "001010010010001", ")": "100010010010100", "-": "000000111000000", "/": "001001010100100",
    ".": "000000000000010", ":": "000010000010000", "_": "000000000000111", " ": "0" * 15,
}
_GLYPH_W, _GLYPH_H, _ADVANCE = 3, 5, 4


def text_box(text: str, org) -> tuple:
    """(x0, y0, x1, y1), inclusive, of the pixels `put_text` may touch."""
    x, y = int(org[0]), int(org[1])
    return x, y - _GLYPH_H + 1, x + _ADVANCE * len(text) - 1, y


def put_text(img: np.ndarray, text: str, org, color) -> None:
    """Draw `text` with its baseline's left end at `org` (as cv2.putText
    places text), in the port's 3x5 font; letters are drawn as capitals."""
    x0, y0, _, _ = text_box(text, org)
    for n, ch in enumerate(text.upper()):
        cells = _FONT.get(ch, "1" * 15)
        for k, c in enumerate(cells):
            if c == "1":
                _put(img, x0 + _ADVANCE * n + k % _GLYPH_W, y0 + k // _GLYPH_W, color)


# ---------------------------------------------------------------------------
# Panels
# ---------------------------------------------------------------------------

def draw_landmarks(img: np.ndarray, lm2d: np.ndarray, color=(0, 255, 0), radius: int = 1) -> np.ndarray:
    """A copy of the RGB uint8 image with the 2D landmarks (pixels, or [0, 1]
    when none exceeds 1.5) drawn as filled circles."""
    out = np.ascontiguousarray(img.copy())
    H, W = out.shape[:2]
    pts = np.asarray(lm2d, np.float32)
    if pts.max() <= 1.5:
        pts = pts * np.asarray([W, H], np.float32)
    for x, y in pts:
        circle_filled(out, (int(round(x)), int(round(y))), radius, color)
    return out


def landmark_error_px(pred: np.ndarray, gt: np.ndarray, H: int, W: int) -> float:
    """Mean L2 landmark distance in pixels (LMD's numerator)."""
    p = np.asarray(pred, np.float32)
    g = np.asarray(gt, np.float32)
    if p.max() <= 1.5:
        p = p * np.asarray([W, H], np.float32)
    if g.max() <= 1.5:
        g = g * np.asarray([W, H], np.float32)
    return float(np.linalg.norm(p - g, axis=-1).mean())


def side_by_side(*imgs: np.ndarray) -> np.ndarray:
    """A horizontal panel of same-height RGB images."""
    hs = {im.shape[0] for im in imgs}
    assert len(hs) == 1, f"heights differ: {[im.shape for im in imgs]}"
    return np.concatenate([np.asarray(im) for im in imgs], axis=1)


def draw_camera_trajectory(
    poses: np.ndarray,  # [T, 4, 4] c2w
    size: int = 512,
    bound: float = 1.0,
    axis_len: float = 0.25,
    highlight: Optional[int] = None,
) -> np.ndarray:
    """Top-down (x / z) plot of the camera path around the head volume: the
    AABB's square, each frame's camera position and forward (+z) axis, and
    an optional highlighted frame (the camera panel of the reference's fit
    check video, fit_3dmm_landmark.py:397-451). RGB uint8 [size, size, 3]."""
    poses = np.asarray(poses, np.float32).reshape(-1, 4, 4)
    img = np.full((size, size, 3), 24, np.uint8)
    cam_xyz = poses[:, :3, 3]
    lo = min(-bound, float(cam_xyz[:, [0, 2]].min())) - 0.3
    hi = max(bound, float(cam_xyz[:, [0, 2]].max())) + 0.3

    def to_px(x, z):
        u = (x - lo) / (hi - lo) * (size - 1)
        v = (z - lo) / (hi - lo) * (size - 1)
        return int(round(u)), int(round(size - 1 - v))

    p00, p11 = to_px(-bound, -bound), to_px(bound, bound)
    rectangle(img, p00, p11, (90, 90, 200))
    put_text(img, "head AABB", (min(p00[0], p11[0]) + 4, max(p00[1], p11[1]) - 6), (90, 90, 200))

    for i, pose in enumerate(poses):
        o = pose[:3, 3]
        fwd = pose[:3, :3] @ np.asarray([0.0, 0.0, 1.0], np.float32)
        a = to_px(o[0], o[2])
        b = to_px(o[0] + axis_len * fwd[0], o[2] + axis_len * fwd[2])
        is_hl = highlight is not None and i == highlight
        col = (64, 255, 64) if is_hl else (200, 200, 80)
        line(img, a, b, col, 2 if is_hl else 1)
        circle_filled(img, a, 3 if is_hl else 1, col)
    put_text(img, f"{len(poses)} poses (top-down x/z)", (8, 16), (220, 220, 220))
    return img


def debug_fit_video(
    processed_dir: str,
    out_path: Optional[str] = None,
    bfm_dir: str = "deep_3drecon/BFM",
    max_frames: int = 250,
    device=None,
) -> str:
    """The fit's check video: fitted (green) over detected (red) landmarks
    on the gt frames beside the camera-trajectory panel, written as the
    video `data/video.py:video_writer` makes of the name (`debug_fit.mp4`:
    H.264 encoded on `device`; an `.avi` name the uncompressed AVI), and the
    mean landmark error in pixels printed (the reference's
    fit_3dmm_landmark.py --debug video, :373-451). The landmarks are
    reprojected on `device` (the card unless named)."""
    import torch

    from genefaceplusplus_tpu_torch.data.binarizer import deep3d_to_nerf_c2w
    from genefaceplusplus_tpu_torch.data.face3d import Face3DHelper
    from genefaceplusplus_tpu_torch.data.image_io import read_image
    from genefaceplusplus_tpu_torch.data.video import video_path, video_writer
    from genefaceplusplus_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    out_path = video_path(out_path or os.path.join(processed_dir, "debug_fit.mp4"))[0]
    coeff = np.load(os.path.join(processed_dir, "coeff_fit_mp.npy"), allow_pickle=True).tolist()
    lms = np.load(os.path.join(processed_dir, "lms_2d.npy"))
    frame_dir = os.path.join(processed_dir, "gt_imgs")
    names = sorted(os.listdir(frame_dir))[:max_frames]

    keypoint_mode = "mediapipe" if lms.shape[1] in (468, 478) else "lm68"
    helper = Face3DHelper.load(bfm_dir, keypoint_mode=keypoint_mode, device=dev)
    T = min(len(names), len(coeff["exp"]), len(lms))

    def t(k):
        return torch.as_tensor(np.asarray(coeff[k][:T], np.float32), device=dev)

    pred2d = helper.reconstruct_lm2d(t("id"), t("exp"), t("euler"), t("trans")).cpu().numpy()
    c2ws = deep3d_to_nerf_c2w(np.asarray(coeff["euler"][:T]), np.asarray(coeff["trans"][:T]))

    writer = video_writer(out_path, fps=25, device=dev)
    errs = []
    for i in range(T):
        img = read_image(os.path.join(frame_dir, names[i]))[..., :3]
        H, W = img.shape[:2]
        det = lms[i][:, :2]
        img = draw_landmarks(img, det, color=(255, 64, 64))
        img = draw_landmarks(img, pred2d[i], color=(64, 255, 64))
        errs.append(landmark_error_px(pred2d[i], det / np.asarray([W, H]) if det.max() > 1.5 else det, H, W))
        writer.append(side_by_side(img, draw_camera_trajectory(c2ws, size=H, highlight=i)))
    writer.close()
    print(f"| debug fit video: {out_path}; mean lm error {np.mean(errs):.2f} px")
    return out_path
