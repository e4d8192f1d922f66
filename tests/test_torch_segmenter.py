"""The port's segmentation tools (`genefaceplusplus_tpu_torch/data/segmenter.py`)
against cv2 and against JAX's `genefaceplusplus_tpu/data/segmenter.py`.

- The 5x5 chamfer distance equals `cv2.distanceTransform(src, DIST_L2, 5)`
  bit for bit on random masks; on a large smooth mask (long runs of the
  2.1969 step) IPP, which cv2's x86 build runs it through, lands one float32
  ulp higher on a few pixels: at most 1 ulp, on at most 5e-3 of the pixels
  (measured: 3e-4 to 1.1e-3 of 256^2; ROADMAP.md queue C).
- The labelled transform equals `cv2.distanceTransformWithLabels(...,
  DIST_LABEL_PIXEL)`: distances bit for bit and each pixel's source (cv2's
  labels number the zeros in raster order).
- The 8-bit Gaussian blur equals `cv2.GaussianBlur` bit for bit.
- `extract_background`, `inpaint_torso` and `generate_segment_images` equal
  JAX's exactly (decoded files pixel for pixel).
"""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from genefaceplusplus_tpu.data import segmenter as J  # noqa: E402
from genefaceplusplus_tpu_torch.data import segmenter as P  # noqa: E402
from genefaceplusplus_tpu_torch.data.image_io import read_image  # noqa: E402


def _mask(H, W, p, seed):
    return (np.random.RandomState(seed).rand(H, W) > p).astype(np.uint8)


def _blobs(H, W, seed, n=3):
    """uint8 mask: zeros inside n random discs, ones elsewhere."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    out = np.ones((H, W), np.uint8)
    for _ in range(n):
        cy, cx, r = rs.rand() * H, rs.rand() * W, (0.05 + 0.2 * rs.rand()) * min(H, W)
        out[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = 0
    return out


CASES = [(37, 53, 0.5, 0), (64, 64, 0.9, 1), (100, 41, 0.98, 2), (8, 5, 0.3, 3), (48, 120, 0.995, 4)]


@pytest.mark.parametrize("H,W,p,seed", CASES)
def test_chamfer_distance_equals_cv2(H, W, p, seed):
    src = _mask(H, W, p, seed)
    np.testing.assert_array_equal(P.chamfer_distance(src), cv2.distanceTransform(src, cv2.DIST_L2, 5))


@pytest.mark.parametrize("seed", [0, 1])
def test_chamfer_distance_on_smooth_masks_within_an_ulp(seed):
    src = _blobs(256, 256, seed)
    got, ref = P.chamfer_distance(src), cv2.distanceTransform(src, cv2.DIST_L2, 5)
    off = got != ref
    assert off.mean() <= 5e-3
    ulps = np.abs(got.view(np.int32).astype(np.int64) - ref.view(np.int32))
    assert ulps.max() <= 1


@pytest.mark.parametrize("H,W,p,seed", CASES + [(128, 96, 0.0, 5)])
def test_chamfer_labels_equal_cv2(H, W, p, seed):
    src = _mask(H, W, p, seed) if p else _blobs(H, W, seed)
    dist, source = P.chamfer_labels(src)
    ref_d, ref_l = cv2.distanceTransformWithLabels(src, cv2.DIST_L2, 5, labelType=cv2.DIST_LABEL_PIXEL)
    np.testing.assert_array_equal(dist, ref_d)
    zero = (src == 0).ravel()
    rank = np.zeros(H * W, np.int64)
    rank[np.flatnonzero(zero)] = np.arange(1, zero.sum() + 1)
    np.testing.assert_array_equal(rank[source], ref_l)


@pytest.mark.parametrize("ksize,sigma", [(5, 4.0), (5, 0.0), (5, 1.3), (3, 0.0), (3, 0.7)])
def test_gaussian_blur_equals_cv2(ksize, sigma):
    img = np.random.RandomState(ksize).randint(0, 256, (29, 41, 3)).astype(np.uint8)
    np.testing.assert_array_equal(P.gaussian_blur_u8(img, ksize, sigma), cv2.GaussianBlur(img, (ksize, ksize), sigma))


def _person(H, W, t, seed=0):
    """A frame and its one-hot segmap: hair, face, neck and clothes moving
    sideways over a textured background."""
    rs = np.random.RandomState(seed + t)
    col = W // 4 + int(W // 4 * np.sin(t / 3))
    cat = np.zeros((H, W), np.int64)
    cat[H // 8:H // 6, col:col + W // 3] = 1
    cat[H // 6:H // 2, col:col + W // 3] = 3
    cat[H // 2:H // 2 + H // 10, col + W // 12:col + W // 4] = 2
    cat[H // 2 + H // 10:, max(col - W // 16, 0):col + W // 3 + W // 16] = 4
    img = (rs.rand(H, W, 3) * 60 + np.linspace(40, 200, W)[None, :, None]).astype(np.uint8)
    for c, color in ((1, (40, 30, 20)), (3, (200, 160, 140)), (2, (180, 140, 120)), (4, (40, 40, 160))):
        img[cat == c] = np.clip(np.asarray(color) + rs.randint(-10, 10, (int((cat == c).sum()), 3)), 0, 255)
    return img, P.onehot_from_categories(cat)


@pytest.mark.parametrize("n", [7, 12])
def test_extract_background_matches_jax(n):
    frames, segmaps = zip(*[_person(96, 80, t) for t in range(n)])
    np.testing.assert_array_equal(P.extract_background(frames, segmaps), J.extract_background(frames, segmaps))
    np.testing.assert_array_equal(P.extract_background(frames, segmaps, select_interval=1),
                                  J.extract_background(frames, segmaps, select_interval=1))


@pytest.mark.parametrize("t", [0, 4])
def test_inpaint_torso_matches_jax(t):
    img, segmap = _person(96, 80, t, seed=3)
    got, ref = P.inpaint_torso(img, segmap), J.inpaint_torso(img, segmap)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


def test_generate_segment_images_matches_jax(tmp_path):
    img, segmap = _person(64, 48, 2, seed=5)
    P.generate_segment_images(str(tmp_path / "port"), "00000002.jpg", img, segmap)
    J.generate_segment_images(str(tmp_path / "jax"), "00000002.jpg", img, segmap)
    subdirs = sorted(os.listdir(tmp_path / "jax"))
    assert subdirs == sorted(os.listdir(tmp_path / "port"))
    assert subdirs == ["head_imgs", "inpaint_torso_imgs", "person_imgs", "segmaps", "torso_imgs"]
    for d in subdirs:
        a = read_image(str(tmp_path / "port" / d / "00000002.png"))
        b = read_image(str(tmp_path / "jax" / d / "00000002.png"))
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(P.load_segmap(str(tmp_path / "port" / "segmaps" / "00000002.png")), segmap)
    np.testing.assert_array_equal(P.load_segmap(str(tmp_path / "jax" / "segmaps" / "00000002.png")),
                                  J.load_segmap(str(tmp_path / "jax" / "segmaps" / "00000002.png")))


def test_segmap_codes_and_modes_match_jax():
    _, segmap = _person(40, 40, 1)
    np.testing.assert_array_equal(P.encode_segmap_image(segmap), J.encode_segmap_image(segmap))
    np.testing.assert_array_equal(P.decode_segmap_image(P.encode_segmap_image(segmap)), segmap)
    img = np.random.RandomState(0).randint(0, 256, (40, 40, 3)).astype(np.uint8)
    for mode in J.MODE_CLASSES:
        for a, b in zip(P.segment_out(img, segmap, mode), J.segment_out(img, segmap, mode)):
            np.testing.assert_array_equal(a, b)
