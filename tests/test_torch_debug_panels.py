"""The debug panels: the port's `data/{bfm_render,secc,visualization}.py` and
`GeneFaceInfer`'s `--debug` against JAX's and cv2's.

- The rasteriser (its windows cut to each face's extent, degenerate and
  small faces included), normals, SH colour and texture: exact.
- `SECCRenderer`: the posed vertices within 1e-5 (the rotation is torch's
  float32 where JAX's is jnp's); the rendered maps equal on all but 0.5 % of
  the pixels (an edge pixel whose barycentric test sits at float32 rounding).
- The key-point splat (`render_secc_from_coeffs`): equal.
- Drawing: filled circles of radius 0-5 and 8-connected lines of thickness
  1, equal to cv2 pixel for pixel wherever they are drawn; thickness-2 lines
  and rectangles inside the image equal to cv2; `draw_landmarks` equal to
  JAX's.
- The camera-trajectory panel and `debug_fit_video`'s frames equal JAX's
  outside the text boxes (cv2.putText's Hershey glyphs are not the port's;
  the port's labels stay inside cv2's boxes).
- `infer_once` with `debug`: frame | SECC | lm68, the first panel the plain
  frame bit for bit, the other two equal to JAX's functions on the same
  request's batch.
"""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

from genefaceplusplus_tpu.data import bfm_render as JR  # noqa: E402
from genefaceplusplus_tpu.data import secc as JSECC  # noqa: E402
from genefaceplusplus_tpu.data import visualization as JV  # noqa: E402
from genefaceplusplus_tpu.data.face3d import Face3DHelper as JHelper  # noqa: E402
from genefaceplusplus_tpu_torch.data import bfm_render as PR  # noqa: E402
from genefaceplusplus_tpu_torch.data import secc as PSECC  # noqa: E402
from genefaceplusplus_tpu_torch.data import visualization as PV  # noqa: E402
from genefaceplusplus_tpu_torch.data.face3d import Face3DHelper as PHelper  # noqa: E402


def _mesh(seed=0, n=300, f=500):
    rs = np.random.RandomState(seed)
    v = (rs.randn(n, 3) * [0.5, 0.6, 0.3]).astype(np.float32)
    faces = np.stack([rs.choice(n, 3, replace=False) for _ in range(f)]).astype(np.int64)
    return rs, v, faces


def test_rasteriser_and_shading_match_jax():
    rs, v, faces = _mesh()
    attrs = rs.rand(len(v), 3).astype(np.float32)
    pts = (rs.rand(len(v), 2) * 40 + 4).astype(np.float32)
    z = (rs.rand(len(v)) * 2 + 1).astype(np.float32)
    for a, b in zip(PR.rasterize_projected(pts, z, faces, attrs, 48, 52, patch=16),
                    JR.rasterize_projected(pts, z, faces, attrs, 48, 52, patch=16)):
        np.testing.assert_array_equal(a, b)
    for t in range(12):  # small and degenerate faces (the bucketed windows), some behind the camera
        n = 240
        pts = (np.repeat(rs.rand(n // 3, 2) * 50, 3, 0) + rs.randn(n, 2) * (t % 4)).astype(np.float32)
        z = (rs.rand(n) * 2 + 0.5).astype(np.float32) * (rs.rand(n) > 0.05)
        tris = np.arange(n).reshape(-1, 3)
        for a, b in zip(PR.rasterize_projected(pts, z, tris, attrs[:n], 48, 52),
                        JR.rasterize_projected(pts, z, tris, attrs[:n], 48, 52)):
            np.testing.assert_array_equal(a, b)
    cam = v + np.asarray([0, 0, 10], np.float32)
    for a, b in zip(PR.rasterize_mesh(cam, faces, attrs, size=64), JR.rasterize_mesh(cam, faces, attrs, size=64)):
        np.testing.assert_array_equal(a, b)
    normals = PR.compute_vertex_normals(v, faces)
    np.testing.assert_array_equal(normals, JR.compute_vertex_normals(v, faces))
    gamma = rs.randn(27).astype(np.float32) * 0.1
    np.testing.assert_array_equal(PR.compute_color(attrs, normals, gamma), JR.compute_color(attrs, normals, gamma))
    base, mean = rs.randn(len(v) * 3, 80).astype(np.float32), rs.rand(len(v) * 3).astype(np.float32) * 255
    coeff = rs.randn(80).astype(np.float32)
    np.testing.assert_array_equal(PR.compute_texture(base, mean, coeff), JR.compute_texture(base, mean, coeff))


def test_secc_renderer_matches_jax():
    rs, v, faces = _mesh(1, n=400, f=700)
    idb, exb = (rs.randn(v.size, k).astype(np.float32) * 0.01 for k in (80, 64))
    args = dict(size=96)
    pr, jr = PR.SECCRenderer(v, idb, exb, faces, **args), JR.SECCRenderer(v, idb, exb, faces, **args)
    coeffs = (rs.randn(80).astype(np.float32), rs.randn(64).astype(np.float32),
              (rs.randn(3) * 0.2).astype(np.float32), (rs.randn(3) * 0.1).astype(np.float32))
    np.testing.assert_allclose(pr.vertices(*coeffs), jr.vertices(*coeffs), rtol=0, atol=1e-5)
    (pm, ps), (jm, js) = pr.render(*coeffs), jr.render(*coeffs)
    assert pm.sum() > 100
    assert (pm != jm).mean() <= 5e-3 and (np.abs(ps - js) > 1e-5).any(-1).mean() <= 5e-3


@pytest.mark.parametrize("mode", ["lm68", "mediapipe"])
def test_secc_splat_matches_jax(mode):
    rs = np.random.RandomState(2)
    c = (rs.randn(1, 80) * 0.3, rs.randn(1, 64) * 0.3, rs.randn(1, 3) * 0.1, rs.randn(1, 3) * 0.1)
    c = [x.astype(np.float32) for x in c]
    got = PSECC.render_secc_from_coeffs(PHelper.synthetic(mode), *c)
    ref = JSECC.render_secc_from_coeffs(JHelper.synthetic(mode), *c)
    assert got.shape == (224, 224, 3) and got.max() > 0
    np.testing.assert_array_equal(got, ref)
    verts = (rs.randn(50, 3) * 0.5 + [0, 0, 10]).astype(np.float32)
    np.testing.assert_array_equal(PSECC.render_secc(verts, size=64), JSECC.render_secc(verts, size=64))


def test_circles_and_thin_lines_equal_cv2():
    rs = np.random.RandomState(3)
    for _ in range(300):
        a, b = np.zeros((40, 50, 3), np.uint8), np.zeros((40, 50, 3), np.uint8)
        r, c = int(rs.randint(0, 6)), (int(rs.randint(-4, 54)), int(rs.randint(-4, 44)))
        cv2.circle(a, c, r, (255, 1, 2), -1)
        PV.circle_filled(b, c, r, (255, 1, 2))
        np.testing.assert_array_equal(a, b)
        p1, p2 = (int(rs.randint(0, 50)), int(rs.randint(0, 40))), (int(rs.randint(0, 50)), int(rs.randint(0, 40)))
        a, b = np.zeros((40, 50, 3), np.uint8), np.zeros((40, 50, 3), np.uint8)
        cv2.line(a, p1, p2, (9, 8, 7), 1)
        PV.line(b, p1, p2, (9, 8, 7), 1)
        np.testing.assert_array_equal(a, b)


def test_thick_lines_and_rectangles_inside_equal_cv2():
    rs = np.random.RandomState(4)
    n = 0
    while n < 300:
        p1 = (int(rs.randint(2, 48)), int(rs.randint(2, 38)))
        p2 = (int(p1[0] + rs.randint(-12, 13)), int(p1[1] + rs.randint(-12, 13)))
        if not (2 <= p2[0] < 48 and 2 <= p2[1] < 38):
            continue
        n += 1
        a, b = np.zeros((40, 50, 3), np.uint8), np.zeros((40, 50, 3), np.uint8)
        cv2.line(a, p1, p2, (9, 8, 7), 2)
        PV.line(b, p1, p2, (9, 8, 7), 2)
        np.testing.assert_array_equal(a, b)
        a, b = np.zeros((40, 50, 3), np.uint8), np.zeros((40, 50, 3), np.uint8)
        cv2.rectangle(a, p1, p2, (5, 6, 7), 1)
        PV.rectangle(b, p1, p2, (5, 6, 7))
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("radius", [1, 2, 3, 4])
def test_draw_landmarks_match_jax(radius):
    rs = np.random.RandomState(radius)
    img = rs.randint(0, 256, (64, 80, 3)).astype(np.uint8)
    for lm in ((rs.rand(68, 2) * 1.2 - 0.1).astype(np.float32), (rs.rand(68, 2) * 90 - 5).astype(np.float32)):
        np.testing.assert_array_equal(PV.draw_landmarks(img, lm, (64, 255, 64), radius),
                                      JV.draw_landmarks(img, lm, (64, 255, 64), radius))
    a, b = rs.rand(68, 2).astype(np.float32), (rs.rand(68, 2) * 64).astype(np.float32)
    assert PV.landmark_error_px(a, b, 64, 80) == JV.landmark_error_px(a, b, 64, 80)
    np.testing.assert_array_equal(PV.side_by_side(img, img[:, :7]), JV.side_by_side(img, img[:, :7]))


def _text_mask(shape, labels) -> np.ndarray:
    """Where either package's labels may draw: cv2.getTextSize's box (from
    the baseline's bottom to the text's top) and the port's `text_box`."""
    m = np.zeros(shape[:2], bool)
    for text, org, scale in labels:
        (w, h), base = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, scale, 1)
        m[max(org[1] - h - 1, 0):org[1] + base + 1, max(org[0] - 1, 0):org[0] + w + 1] = True
        x0, y0, x1, y1 = PV.text_box(text, org)
        m[y0:y1 + 1, x0:x1 + 1] = True
    return m


def _trajectory_labels(poses, size, bound=1.0):
    cam = np.asarray(poses, np.float32).reshape(-1, 4, 4)[:, :3, 3]
    lo = min(-bound, float(cam[:, [0, 2]].min())) - 0.3
    hi = max(bound, float(cam[:, [0, 2]].max())) + 0.3

    def to_px(x, z):
        return (int(round((x - lo) / (hi - lo) * (size - 1))),
                int(round(size - 1 - (z - lo) / (hi - lo) * (size - 1))))

    p00, p11 = to_px(-bound, -bound), to_px(bound, bound)
    return [("head AABB", (min(p00[0], p11[0]) + 4, max(p00[1], p11[1]) - 6), 0.35),
            (f"{len(poses)} poses (top-down x/z)", (8, 16), 0.4)]


def _poses(T, seed):
    from genefaceplusplus_tpu_torch.data.binarizer import deep3d_to_nerf_c2w

    rs = np.random.RandomState(seed)
    euler = (rs.randn(T, 3) * 0.15).astype(np.float32)
    trans = (rs.randn(T, 3) * [0.3, 0.3, 1.0]).astype(np.float32)
    return deep3d_to_nerf_c2w(euler, trans)


@pytest.mark.parametrize("size,highlight", [(256, 3), (512, None), (200, 0)])
def test_camera_trajectory_matches_jax_outside_the_labels(size, highlight):
    poses = _poses(12, size)
    got = PV.draw_camera_trajectory(poses, size=size, highlight=highlight)
    ref = JV.draw_camera_trajectory(poses, size=size, highlight=highlight)
    text = _text_mask(got.shape, _trajectory_labels(poses, size))
    assert text.mean() < 0.1  # the two labels, not the panel
    np.testing.assert_array_equal(got[~text], ref[~text])
    assert (got[text] != 24).any()  # the labels are drawn


def test_debug_fit_video_matches_jax_outside_the_labels(tmp_path):
    from genefaceplusplus_tpu_torch.data.image_io import write_jpeg
    from genefaceplusplus_tpu_torch.data.video import read_avi

    T, S = 5, 96
    rs = np.random.RandomState(6)
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "gt_imgs"))
    for i in range(T):
        write_jpeg(os.path.join(d, "gt_imgs", f"{i:08d}.jpg"), rs.randint(0, 256, (S, S, 3)).astype(np.uint8))
    coeff = {"id": np.zeros((T, 80), np.float32), "exp": (rs.randn(T, 64) * 0.2).astype(np.float32),
             "euler": (rs.randn(T, 3) * 0.1).astype(np.float32), "trans": (rs.randn(T, 3) * 0.1).astype(np.float32)}
    np.save(os.path.join(d, "coeff_fit_mp.npy"), coeff, allow_pickle=True)
    lms = (rs.rand(T, 68, 2) * S).astype(np.float32)
    np.save(os.path.join(d, "lms_2d.npy"), lms)
    path = PV.debug_fit_video(d, out_path=os.path.join(d, "debug_fit.avi"), bfm_dir="unused", device="cpu")
    assert path == os.path.join(d, "debug_fit.avi")
    frames, _ = read_avi(path)
    assert frames.shape == (T, S, 2 * S, 3)
    helper = JHelper.synthetic("lm68")
    pred = np.asarray(helper.reconstruct_lm2d(*(jnp.asarray(coeff[k]) for k in ("id", "exp", "euler", "trans"))))
    from genefaceplusplus_tpu.data.binarizer import deep3d_to_nerf_c2w

    poses = np.asarray(deep3d_to_nerf_c2w(coeff["euler"], coeff["trans"]))
    text = _text_mask((S, S), _trajectory_labels(poses, S))
    for i in range(T):
        img = cv2.cvtColor(cv2.imread(os.path.join(d, "gt_imgs", f"{i:08d}.jpg")), cv2.COLOR_BGR2RGB)
        img = JV.draw_landmarks(JV.draw_landmarks(img, lms[i], color=(255, 64, 64)), pred[i], color=(64, 255, 64))
        panel = JV.draw_camera_trajectory(poses, size=S, highlight=i)
        np.testing.assert_array_equal(frames[i][:, :S], img)
        np.testing.assert_array_equal(frames[i][:, S:][~text], panel[~text])


def test_infer_once_debug_panels(tmp_path):
    from genefaceplusplus_tpu_torch.data.video import read_avi
    from genefaceplusplus_tpu_torch.inference.pipeline import default_inp
    from genefaceplusplus_tpu_torch.testing import tiny_infer

    infer = tiny_infer()
    rs = np.random.RandomState(5)
    T50 = 16
    wav = (rs.randn(T50 * 320 + 700) * 0.2).astype(np.float32)
    np.save(str(tmp_path / "f.npy"), {"hubert": rs.randn(T50, 64).astype(np.float32),
                                      "f0": (np.abs(rs.randn(T50)) * 100 + 80).astype(np.float32), "wav16k": wav},
            allow_pickle=True)
    inp = default_inp(drv_aud_features=str(tmp_path / "f.npy"), temperature=0.0)
    out = {}
    for debug in (False, True):
        infer.generator.manual_seed(42)
        out[debug] = read_avi(infer.infer_once(dict(inp, debug=debug, out_name=str(tmp_path / f"{debug}.avi"))))[0]
    T, S = T50 // 2, 16
    assert out[False].shape == (T, S, S, 3) and out[True].shape == (T, S, 3 * S, 3)
    np.testing.assert_array_equal(out[True][:, :, :S], out[False])

    infer.generator.manual_seed(42)
    batch = infer.forward_audio2secc(infer.prepare_batch_from_inp(default_inp(**inp)), default_inp(**inp))
    jh = JHelper.synthetic("mediapipe")
    for i in range(T):
        lm3d = np.asarray(jh.reconstruct_key_lm3d(*(jnp.asarray(batch[k][i][None]) for k in
                                                  ("id_coeff", "exp", "eulers", "transs"))))[0]
        secc = JSECC.render_secc(lm3d, JSECC.ncc_colors(np.asarray(jh.key_mean_shape)), size=S, splat=2)
        np.testing.assert_array_equal(out[True][i, :, S:2 * S], secc)
        lm = JV.draw_landmarks(np.zeros((S, S, 3), np.uint8), batch["lm68"][i], color=(64, 255, 64), radius=1)
        np.testing.assert_array_equal(out[True][i, :, 2 * S:], lm)
