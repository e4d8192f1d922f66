"""Segmentation-guided data preparation: segmaps -> head / torso / person
crops, the nearest-neighbour background and the torso / neck inpainting
(port of `genefaceplusplus_tpu/data/segmenter.py`, which leans on cv2).

Host numpy and scipy, as JAX runs it. The four cv2 calls JAX makes are
replaced by code that reproduces them:

- `chamfer_distance`: `cv2.distanceTransform(src, DIST_L2, 5)`, which is
  OpenCV's 5x5 chamfer transform (steps 1, 1.4 and 2.1969 pixels), not the
  exact Euclidean distance. OpenCV's x86 builds run it through IPP in
  float32; this is float32 arithmetic too, two raster passes, each pixel
  the minimum of its eight causal neighbours plus their step, swept in
  anti-diagonal waves (every pixel of a wave depends only on earlier
  waves). Equal to cv2 bit for bit on random masks; on long runs of the
  2.1969 step past ~30 px, IPP's sum lands one float32 ulp higher on a few
  pixels in ten thousand (IPP's summation order is not public; ROADMAP.md
  queue C, `tests/test_torch_segmenter.py`).
- `chamfer_labels`: `cv2.distanceTransformWithLabels(..., DIST_LABEL_PIXEL)`,
  OpenCV's own 16.16 fixed-point passes with each pixel's nearest source.
  Ties go where OpenCV's strict comparisons send them: a row's left-to-
  right recurrence is a running minimum whose argmin keeps the later
  column, and right-to-left the nearer one. Distances and sources equal
  cv2's.
- `gaussian_blur_u8`: `cv2.GaussianBlur` on uint8 with a 5-tap kernel:
  OpenCV's bit-exact path (8-bit fixed-point taps, reflect-101 borders,
  one rounding at the end).
- PNG files through `data/image_io.py` (decoded pixels equal cv2's).

The 6 classes follow the mediapipe multiclass-selfie contract:
  0 background | 1 hair | 2 body-skin | 3 face-skin | 4 clothes | 5 others
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from genefaceplusplus_tpu_torch.data.image_io import read_image, write_png

NUM_CLASSES = 6
# png colour coding (interop with the reference's preprocessed segmaps/)
SEGMAP_COLORS = np.asarray(
    [
        (255, 255, 255),  # 0 background
        (255, 255, 0),    # 1 hair
        (255, 0, 255),    # 2 body-skin
        (0, 255, 255),    # 3 face-skin
        (255, 0, 0),      # 4 clothes
        (0, 255, 0),      # 5 others
    ],
    dtype=np.uint8,
)

# per-mode class subsets (mp_segmenter.py:236-251)
MODE_CLASSES = {
    "head": (1, 3, 5),
    "torso": (2, 4),
    "torso_with_bg": (0, 2, 4),
    "person": (1, 2, 3, 4, 5),
    "bg": (0,),
}


def onehot_from_categories(cat: np.ndarray, num_classes: int = NUM_CLASSES) -> np.ndarray:
    """[H, W] int category map -> [C, H, W] uint8 one-hot."""
    return (cat[None] == np.arange(num_classes, dtype=cat.dtype)[:, None, None]).astype(np.uint8)


def encode_segmap_image(segmap: np.ndarray) -> np.ndarray:
    """[C, H, W] one-hot -> [H, W, 3] colour-coded uint8 (lossless png store)."""
    return SEGMAP_COLORS[np.argmax(segmap, axis=0)]


def decode_segmap_image(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] colour-coded -> [C, H, W] uint8 one-hot (a colour outside
    the code is in no class)."""
    def code(rgb):
        rgb = np.asarray(rgb).astype(np.int32)
        return (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]

    return (code(img)[None] == code(SEGMAP_COLORS)[:, None, None]).astype(np.uint8)


def segment_out(img: np.ndarray, segmap: np.ndarray, mode: str) -> Tuple[np.ndarray, np.ndarray]:
    """Zero the pixels outside the mode's classes. Returns (img_out [H, W, 3],
    mask [H, W] bool)."""
    mask = segmap[list(MODE_CLASSES[mode])].sum(axis=0) > 0.5
    out = img.copy()
    out[~mask] = 0
    return out, mask


# ---------------------------------------------------------------------------
# OpenCV's 5x5 chamfer distance
# ---------------------------------------------------------------------------

CHAMFER_STEPS = (np.float32(1.0), np.float32(1.4), np.float32(2.1969))  # OpenCV's DIST_L2 5x5 mask
_FIX = 1 << 16  # OpenCV's DIST_SHIFT
_FIX_STEPS = tuple(int(round(float(s) * _FIX)) for s in CHAMFER_STEPS)  # 65536, 91750, 143976
_FIX_INIT = (2 ** 31 - 1) >> 2  # the fixed-point passes' "far"
# the forward pass's causal neighbours (dy, dx, step index) in OpenCV's order;
# the backward pass mirrors them
_NEIGHBOURS = ((-2, -1, 2), (-2, 1, 2), (-1, -2, 2), (-1, -1, 1), (-1, 0, 0), (-1, 1, 1), (-1, 2, 2))
_PAD = 2


@functools.lru_cache(maxsize=4)
def _waves(H: int, W: int):
    """Flat indices into the [H+4, W+4] padded grid, ordered by the forward
    pass's wave 3y + x, and each wave's bounds: a pixel's causal neighbours
    all lie on earlier waves."""
    y, x = np.mgrid[0:H, 0:W]
    wave = (3 * y + x).ravel()
    order = np.argsort(wave, kind="stable")
    flat = ((y + _PAD) * (W + 2 * _PAD) + (x + _PAD)).ravel()[order]
    bounds = np.searchsorted(wave[order], np.arange(wave.max() + 2))
    return flat, bounds


def chamfer_distance(src: np.ndarray) -> np.ndarray:
    """float32 [H, W]: each pixel's 5x5 chamfer distance to the nearest zero
    of `src`, as `cv2.distanceTransform(src, cv2.DIST_L2, 5)` computes it
    (module docstring). Without a zero every pixel is float32's max."""
    H, W = src.shape
    Wp = W + 2 * _PAD
    big = np.float32(np.finfo(np.float32).max)
    t = np.full((H + 2 * _PAD) * Wp, big, np.float32)
    flat, bounds = _waves(H, W)
    zero_grid = np.zeros((H + 2 * _PAD, Wp), bool)
    zero_grid[_PAD:_PAD + H, _PAD:_PAD + W] = np.asarray(src) == 0
    zero = zero_grid.ravel()
    t[zero] = 0.0
    steps = np.asarray(CHAMFER_STEPS, np.float32)
    fwd = np.asarray([dy * Wp + dx for dy, dx, _ in _NEIGHBOURS] + [-1])
    fwd_w = np.asarray([steps[k] for _, _, k in _NEIGHBOURS] + [steps[0]], np.float32)[:, None]
    keep = ~zero[flat]
    for a, b in zip(bounds[:-1], bounds[1:]):
        idx = flat[a:b][keep[a:b]]
        if idx.size:
            t[idx] = (t[idx[None] + fwd[:, None]] + fwd_w).min(0)
    for a, b in zip(bounds[-2::-1], bounds[:0:-1]):
        idx = flat[a:b][keep[a:b]]
        if idx.size:
            t[idx] = np.minimum(t[idx], (t[idx[None] - fwd[:, None]] + fwd_w).min(0))
    return t.reshape(H + 2 * _PAD, Wp)[_PAD:_PAD + H, _PAD:_PAD + W].copy()


def chamfer_labels(src: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(float32 distance [H, W], int64 source [H, W]): the 5x5 chamfer
    distance to the nearest zero of `src` and that zero's flat index, as
    `cv2.distanceTransformWithLabels(src, DIST_L2, 5,
    labelType=DIST_LABEL_PIXEL)` finds them (its labels number the zeros in
    raster order; here each label is the zero's flat index)."""
    H, W = src.shape
    hv = _FIX_STEPS[0]
    t = np.full((H + 2 * _PAD, W + 2 * _PAD), _FIX_INIT, np.int64)
    lab = np.zeros(t.shape, np.int64)
    zero = np.asarray(src) == 0
    own = np.arange(H * W, dtype=np.int64).reshape(H, W)
    cols = np.arange(W, dtype=np.int64)
    xs = slice(_PAD, _PAD + W)

    def candidates(r, sign, c, lc):
        for dy, dx, k in _NEIGHBOURS:
            rr, cc = r + sign * dy, slice(_PAD + sign * dx, _PAD + sign * dx + W)
            cand = t[rr, cc] + _FIX_STEPS[k]
            m = cand < c  # strict: the earlier neighbour keeps a tie
            c, lc = np.where(m, cand, c), np.where(m, lab[rr, cc], lc)
        return c, lc

    for i in range(H):  # forward: up neighbours, then the left one
        r = i + _PAD
        c, lc = candidates(r, 1, np.full(W, _FIX_INIT, np.int64), np.zeros(W, np.int64))
        c, lc = np.where(zero[i], 0, c), np.where(zero[i], own[i], lc)
        v = c - cols * hv
        m = np.minimum.accumulate(v)
        arg = np.maximum.accumulate(np.where(v == m, cols, -1))  # the left wins only when strictly nearer
        t[r, xs], lab[r, xs] = m + cols * hv, lc[arg]
    for i in range(H - 1, -1, -1):  # backward: down neighbours, then the right one
        r = i + _PAD
        c, lc = candidates(r, -1, t[r, xs].copy(), lab[r, xs].copy())
        v = c + cols * hv
        m = np.minimum.accumulate(v[::-1])[::-1]
        arg = np.minimum.accumulate(np.where(v == m, cols, W)[::-1])[::-1]
        t[r, xs], lab[r, xs] = m - cols * hv, lc[arg]
    dist = t[_PAD:_PAD + H, xs].astype(np.float32) * np.float32(1.0 / _FIX)
    return dist, lab[_PAD:_PAD + H, xs].copy()


# ---------------------------------------------------------------------------
# OpenCV's bit-exact 8-bit Gaussian blur
# ---------------------------------------------------------------------------

# OpenCV's fixed kernels for sigma <= 0 (x 256)
_SMALL_TAPS = {1: (256,), 3: (64, 128, 64), 5: (16, 64, 96, 64, 16), 7: (8, 28, 56, 72, 56, 28, 8)}


def gaussian_taps(ksize: int, sigma: float) -> np.ndarray:
    """OpenCV's fixed-point Gaussian taps (8 fractional bits, summing to
    256) for an odd `ksize`: the outer taps rounded with the error carried
    inward, the centre the remainder; sigma <= 0 takes OpenCV's default."""
    if sigma <= 0 and ksize in _SMALL_TAPS:
        return np.asarray(_SMALL_TAPS[ksize], np.int64)
    if sigma <= 0:
        sigma = ((ksize - 1) * 0.5 - 1) * 0.3 + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    g /= g.sum()
    taps = np.zeros(ksize, np.int64)
    err = 0.0
    for i in range(ksize // 2):
        v = g[i] * 256 + err
        taps[i] = taps[ksize - 1 - i] = int(np.round(v))
        err = v - taps[i]
    taps[ksize // 2] = 256 - 2 * taps[:ksize // 2].sum()
    return taps


def gaussian_blur_u8(img: np.ndarray, ksize: int = 5, sigma: float = 0.0) -> np.ndarray:
    """uint8 [H, W(, C)] -> uint8: `cv2.GaussianBlur(img, (ksize, ksize),
    sigma)` bit for bit (reflect-101 borders; rows, then columns, in
    integers; one rounding)."""
    k = gaussian_taps(ksize, sigma)
    r = ksize // 2
    a = np.asarray(img).astype(np.int64)
    pad = [(0, 0)] * a.ndim
    pad[1] = (r, r)
    p = np.pad(a, pad, mode="reflect")  # numpy's reflect is OpenCV's reflect-101
    h = sum(k[i] * p[:, i:i + a.shape[1]] for i in range(ksize))
    pad[1], pad[0] = (0, 0), (r, r)
    p = np.pad(h, pad, mode="reflect")
    v = sum(k[i] * p[i:i + a.shape[0]] for i in range(ksize))
    return ((v + (1 << 15)) >> 16).astype(np.uint8)


# ---------------------------------------------------------------------------
# Nearest-neighbour background reconstruction (extract_segment_imgs.py:63-147)
# ---------------------------------------------------------------------------

def _dist_to_foreground(bg_mask: np.ndarray) -> np.ndarray:
    """Each pixel's chamfer distance to the nearest foreground pixel."""
    if not (~bg_mask).any():
        return np.full(bg_mask.shape, 1e9, np.float32)
    return chamfer_distance(bg_mask.astype(np.uint8))


def extract_background(
    frames: Sequence[np.ndarray],
    segmaps: Sequence[np.ndarray],
    dist_thresh: float = 10.0,
    select_interval: Optional[int] = None,
) -> np.ndarray:
    """The static background from sampled frames: each pixel from the frame
    where it lies farthest from the foreground; pixels never farther than
    `dist_thresh` take the colour of the nearest pixel that is.

    frames: [H, W, 3] uint8 RGB each; segmaps: [C, H, W] one-hot each."""
    assert len(frames) == len(segmaps) and len(frames) > 0
    n = len(frames)
    if select_interval is None:  # extract_segment_imgs.py:92-98
        select_interval = 5 if n <= 100 else (20 if n < 10000 else n // 500)
    sel = list(range(0, n, select_interval)) if n > select_interval else [0]

    dists = np.stack([_dist_to_foreground(segmaps[i][0].astype(bool)) for i in sel])  # [B, H, W]
    best = dists.argmax(axis=0)
    max_dist = dists.max(axis=0)
    imgs = np.stack([np.asarray(frames[i]) for i in sel])  # [B, H, W, 3]
    bg = np.take_along_axis(imgs, best[None, ..., None], axis=0)[0]

    solid = max_dist > dist_thresh
    if solid.any() and (~solid).any():
        _, source = chamfer_labels((~solid).astype(np.uint8))
        hole = ~solid
        bg[hole] = bg.reshape(-1, 3)[source[hole]]
    return bg


# ---------------------------------------------------------------------------
# Torso / neck vertical inpainting (extract_segment_imgs.py:148-240)
# ---------------------------------------------------------------------------

def _top_pixels_under_head(part: np.ndarray, head: np.ndarray):
    """For each image column, the topmost `part` pixel whose upper
    neighbour is head. Returns [m, 2] (row, col) and per-column counts [m]."""
    rows, cols = np.nonzero(part)
    if len(rows) == 0:
        return np.zeros((0, 2), np.int64), np.zeros((0,), np.int64)
    order = np.lexsort((rows, cols))  # by column, then by row
    rows, cols = rows[order], cols[order]
    ucols, first, counts = np.unique(cols, return_index=True, return_counts=True)
    top = np.stack([rows[first], ucols], axis=-1)
    up = np.clip(top[:, 0] - 1, 0, part.shape[0] - 1)
    keep = head[up, top[:, 1]]
    return top[keep], counts[keep]


def _paint_up(img: np.ndarray, coords: np.ndarray, colors: np.ndarray, L: int,
              darken: float = 0.98) -> np.ndarray:
    """Stamp `colors` upward from each coord for L rows, darkening
    geometrically; returns the painted mask."""
    H = img.shape[0]
    mask = np.zeros(img.shape[:2], bool)
    if len(coords) == 0:
        return mask
    steps = np.arange(L)
    rr = coords[:, 0][None] - steps[:, None]  # [L, m]
    cc = np.broadcast_to(coords[:, 1][None], rr.shape)
    scale = (darken ** steps)[:, None, None]
    shades = np.clip(colors[None].astype(np.float32) * scale, 0, 255).astype(img.dtype)
    ok = (rr >= 0) & (rr < H)
    img[rr[ok], cc[ok]] = shades[ok]
    mask[rr[ok], cc[ok]] = True
    return mask


# JAX calls cv2.GaussianBlur(img, (5, 5), cv2.BORDER_DEFAULT): the border
# constant (4) lands in sigmaX's place, so the blur's sigma is 4
NECK_BLUR_SIGMA = 4.0


def inpaint_torso(gt_img: np.ndarray, segmap: np.ndarray):
    """Head removal and vertical torso / neck inpainting. Returns (torso_img
    [H, W, 3], torso_mask [H, W] bool): the torso crop the torso NeRF
    trains against (alpha = torso_mask)."""
    from scipy.ndimage import binary_dilation

    head = (segmap[1] + segmap[3] + segmap[5]).astype(bool)
    neck = segmap[2].astype(bool)
    torso = segmap[4].astype(bool)

    img = gt_img.copy()
    img[head] = 0

    # torso: continue the clothes upward under the removed head (L=9)
    top_t, _ = _top_pixels_under_head(torso, head)
    torso_colors = gt_img[top_t[:, 0], top_t[:, 1]] if len(top_t) else np.zeros((0, 3))
    inpaint_t_mask = _paint_up(img, top_t, torso_colors, L=9)

    # neck: dilate vertically, take the source a few rows down for a softer
    # transition, then paint a taller column (L=53)
    push_down = 4
    vert = np.zeros((3, 3), bool)
    vert[:, 1] = True
    neck_d = binary_dilation(neck, structure=vert, iterations=3)
    top_n, counts_n = _top_pixels_under_head(neck_d, head)
    if len(top_n):
        down = np.minimum(counts_n - 1, push_down)
        top_n = top_n + np.stack([down, np.zeros_like(down)], axis=-1)
    neck_colors = gt_img[top_n[:, 0], top_n[:, 1]] if len(top_n) else np.zeros((0, 3))
    inpaint_n_mask = _paint_up(img, top_n, neck_colors, L=48 + push_down + 1)

    # blur the neck's paint to hide vertical streaks
    if inpaint_n_mask.any():
        blurred = gaussian_blur_u8(img, 5, NECK_BLUR_SIGMA)
        img[inpaint_n_mask] = blurred[inpaint_n_mask]

    torso_mask = neck_d | torso | inpaint_n_mask | inpaint_t_mask
    out = img.copy()
    out[~torso_mask] = 0
    return out, torso_mask


# ---------------------------------------------------------------------------
# Per-frame segment images (extract_segment_imgs.py:258-277)
# ---------------------------------------------------------------------------

def generate_segment_images(
    out_dir: str,
    frame_name: str,
    img: np.ndarray,
    segmap: np.ndarray,
    modes: Tuple[str, ...] = ("head", "torso", "person"),
) -> None:
    """Write segmaps/<f>.png (colour-coded), the per-mode RGBA crops
    <mode>_imgs/<f>.png and inpaint_torso_imgs/<f>.png for one frame."""
    stem = os.path.splitext(frame_name)[0]

    def write_rgba(subdir: str, rgb: np.ndarray, mask: np.ndarray):
        d = os.path.join(out_dir, subdir)
        os.makedirs(d, exist_ok=True)
        alpha = (mask.astype(np.uint8) * 255)[..., None]
        write_png(os.path.join(d, stem + ".png"), np.concatenate([rgb, alpha], axis=-1))

    d = os.path.join(out_dir, "segmaps")
    os.makedirs(d, exist_ok=True)
    write_png(os.path.join(d, stem + ".png"), encode_segmap_image(segmap))
    for mode in modes:
        rgb, mask = segment_out(img, segmap, mode)
        write_rgba(f"{mode}_imgs", rgb, mask)
    torso_rgb, torso_mask = inpaint_torso(img, segmap)
    write_rgba("inpaint_torso_imgs", torso_rgb, torso_mask)


def load_segmap(path: str) -> np.ndarray:
    """A colour-coded segmap png -> [C, H, W] one-hot."""
    return decode_segmap_image(read_image(path)[..., :3])
