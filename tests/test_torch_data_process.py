"""Data preparation without JAX: the port's `data/{process,binarizer,
mp_extract,synthetic_face}.py` against JAX's on the same inputs.

- `synthetic_face` equals JAX's at 64^2, 3 frames, array for array.
- JAX's 12-frame 64^2 fixture (`tests/test_pipeline_integration.py`) through
  `step_segment` -> `step_fit` -> `binarize` in both packages:
  * every image the segment step writes decodes equal, bg.jpg byte for byte;
  * the fit: both losses within 1e-4 relative (measured 2.4e-5), and the
    reprojected landmarks within 4x JAX's own distance from a float64 run of
    the port (the fixture's landmarks sit at 1/8 of the basis's scale, as
    JAX's 512 divisor leaves them: a flat loss, measured 0.84 px at 512^2
    port vs JAX);
  * the record, key by key: from JAX's coefficients every float key within
    1e-4 of its largest entry (measured <= 6e-8), every other key equal;
    from the port's own fit the keys the fit does not feed equal.
- `step_frames` on the port's AVI against JAX's cv2 reader on the same
  frames: the JPEGs byte for byte at the frame's size; on a CABAC B mp4
  (tools/h264_streams.py) of another size than the target: the same frame
  count, the decoded frames within the RGB tolerance of cv2's, the JPEGs
  within STEP_FRAMES_JPEG_MAX / _MEAN.
- `step_audio`'s mel and f0 equal JAX's; mediapipe's absence raises JAX's
  message, and the steps fall back to precomputed files as JAX's do.
- `process.main` runs every step on the CPU (`--device cpu`) and both
  packages' datasets read the record.
"""

import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

from genefaceplusplus_tpu.data import binarizer as JB  # noqa: E402
from genefaceplusplus_tpu.data import process as JP  # noqa: E402
from genefaceplusplus_tpu.data import segmenter as JS  # noqa: E402
from genefaceplusplus_tpu.data.face3d import Face3DHelper as JHelper  # noqa: E402
from genefaceplusplus_tpu_torch.data import binarizer as PB  # noqa: E402
from genefaceplusplus_tpu_torch.data import process as PP  # noqa: E402
from genefaceplusplus_tpu_torch.data.face3d import Face3DHelper as PHelper  # noqa: E402
from genefaceplusplus_tpu_torch.data.image_io import read_image  # noqa: E402

KEYS = ("id", "exp", "euler", "trans")


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def test_synthetic_face_matches_jax():
    from genefaceplusplus_tpu.data.synthetic_face import synthetic_face as jax_face
    from genefaceplusplus_tpu_torch.data.synthetic_face import synthetic_face

    ref = jax_face(num_frames=3, size=64, seed=0)
    assert _equal(synthetic_face(num_frames=3, size=64, seed=0), ref)
    masked = synthetic_face(num_frames=3, size=64, seed=0, head_masks=True)
    masks = [s.pop("head_mask") for s in masked["train_samples"] + masked["val_samples"]]
    assert _equal(masked, ref)
    assert all(m.dtype == bool and m.shape == (64, 64) and m.any() for m in masks)


@pytest.fixture()
def processed(tmp_path):
    """JAX's tests/test_pipeline_integration.py fixture (12 frames of 64^2,
    segmaps, landmarks of the stand-in basis, audio features): one copy for
    each package."""
    d = str(tmp_path / "jax")
    os.makedirs(os.path.join(d, "gt_imgs"))
    os.makedirs(os.path.join(d, "segmaps"))
    helper = JHelper.synthetic(keypoint_mode="lm68")
    rng = np.random.RandomState(0)
    T, H, W = 12, 64, 64
    lm2d = np.asarray(helper.reconstruct_lm2d(
        jnp.zeros((T, 80)), jnp.asarray(rng.randn(T, 64) * 0.05, jnp.float32),
        jnp.asarray(rng.randn(T, 3) * 0.02, jnp.float32), jnp.asarray(rng.randn(T, 3) * 0.02, jnp.float32)))
    np.save(os.path.join(d, "lms_2d.npy"), (lm2d * W).astype(np.float32))
    for t in range(T):
        col = 16 + int(16 * np.sin(t / 3))
        cat = np.zeros((H, W), np.int64)
        cat[10:28, col:col + 20] = 3
        cat[28:34, col + 4:col + 16] = 2
        cat[34:, col - 4:col + 24] = 4
        img = np.full((H, W, 3), 80, np.uint8)
        img[..., 2] = np.linspace(0, 255, H, dtype=np.uint8)[:, None]
        img[cat == 3] = (200, 160, 140)
        img[cat == 2] = (180, 140, 120)
        img[cat == 4] = (40, 40, 160)
        cv2.imwrite(os.path.join(d, "gt_imgs", f"{t:08d}.jpg"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        seg_png = JS.encode_segmap_image(JS.onehot_from_categories(cat))
        cv2.imwrite(os.path.join(d, "segmaps", f"{t:08d}.png"), cv2.cvtColor(seg_png, cv2.COLOR_RGB2BGR))
    np.save(os.path.join(d, "aud_mel_f0.npy"),
            {"mel": rng.randn(2 * T, 80).astype(np.float32),
             "f0": (np.abs(rng.randn(2 * T)) * 100 + 100).astype(np.float32)}, allow_pickle=True)
    np.save(os.path.join(d, "aud_hubert.npy"), rng.randn(2 * T, 64).astype(np.float32))
    p = str(tmp_path / "port")
    shutil.copytree(d, p)
    return d, p


def _records_equal_but_fit(jr, pr, jdir, pdir, fit_keys):
    """Every key equal, floats within 1e-4 of the key's largest entry where
    `fit_keys` is None; with `fit_keys`, the keys not in it exactly."""
    assert set(jr) == set(pr)
    for k, a in jr.items():
        b = pr[k]
        if fit_keys is not None and k in fit_keys:
            assert np.shape(a) == np.shape(b), k
            continue
        if isinstance(a, list):
            assert len(a) == len(b), k
            for sa, sb in zip(a, b):
                assert set(sa) == set(sb)
                for kk, x in sa.items():
                    y = sb[kk]
                    if isinstance(x, str):
                        assert x.replace(jdir, "") == y.replace(pdir, ""), (k, kk)
                    elif isinstance(x, np.ndarray) and x.dtype.kind == "f":
                        if fit_keys is not None and kk == "c2w":
                            continue
                        assert x.dtype == y.dtype and np.abs(x - y).max() <= 1e-4 * max(np.abs(x).max(), 1.0), (k, kk)
                    else:
                        assert _equal(x, y), (k, kk)
        elif isinstance(a, np.ndarray) and a.dtype.kind == "f":
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert np.abs(a.astype(np.float64) - b).max() <= 1e-4 * max(np.abs(a).max(), 1e-30), k
        else:
            assert _equal(a, b), k


def test_segment_fit_binarize_matches_jax(processed, monkeypatch):
    jdir, pdir = processed
    JP.step_segment(jdir)
    JP.step_fit(jdir, bfm_dir="unused")
    jrec = JB.binarize(jdir, None, bfm_dir="unused")
    PP.step_segment(pdir)
    PP.step_fit(pdir, bfm_dir="unused", device="cpu")
    prec = PB.binarize(pdir, None, bfm_dir="unused", device="cpu")

    # the segment step's images
    for sub in ("com_imgs", "head_imgs", "inpaint_torso_imgs", "person_imgs", "segmaps", "torso_imgs"):
        names = sorted(os.listdir(os.path.join(jdir, sub)))
        assert len(names) == 12 and names == sorted(os.listdir(os.path.join(pdir, sub)))
        for n in names:
            np.testing.assert_array_equal(read_image(os.path.join(pdir, sub, n)), read_image(os.path.join(jdir, sub, n)))
    with open(os.path.join(jdir, "bg.jpg"), "rb") as a, open(os.path.join(pdir, "bg.jpg"), "rb") as b:
        assert a.read() == b.read()

    # the fit
    jc = np.load(os.path.join(jdir, "coeff_fit_mp.npy"), allow_pickle=True).tolist()
    pc = np.load(os.path.join(pdir, "coeff_fit_mp.npy"), allow_pickle=True).tolist()
    for k in ("final_loss", "pose_loss"):
        assert abs(pc[k] - jc[k]) <= 1e-4 * jc[k], k
    lms = np.load(os.path.join(pdir, "lms_2d.npy")) / 512.0
    h64 = PHelper.synthetic("lm68")
    for name in ("key_mean_shape", "key_id_base", "key_exp_base", "persc_proj"):
        setattr(h64, name, getattr(h64, name).double())
    from genefaceplusplus_tpu_torch.data.fit_3dmm import fit_3dmm_for_video

    c64 = fit_3dmm_for_video(lms.astype(np.float32), h64)
    h = PHelper.synthetic("lm68")

    def reproj(c):
        return h.reconstruct_lm2d(*(torch.as_tensor(np.asarray(c[k], np.float32)) for k in KEYS)).numpy()

    d_port = np.abs(reproj(pc) - reproj(jc)).max()
    d_jax = np.abs(reproj(jc) - reproj(c64)).max()
    assert d_port <= 4.0 * d_jax + 1e-6, (d_port, d_jax)

    # the record: from the port's own fit, and from JAX's coefficients
    _records_equal_but_fit(jrec, prec, jdir, pdir, fit_keys={"id", "exp", "euler", "trans", "idexp_lm3d",
                                                             "idexp_lm3d_mean", "idexp_lm3d_std", "eye_area_percent"})
    shutil.copy(os.path.join(jdir, "coeff_fit_mp.npy"), os.path.join(pdir, "coeff_fit_mp.npy"))
    out = os.path.join(pdir, "..", "binary", "trainval_dataset.npy")
    prec = PB.binarize(pdir, out, bfm_dir="unused", device="cpu")
    _records_equal_but_fit(jrec, prec, jdir, pdir, fit_keys=None)
    assert _equal(np.load(out, allow_pickle=True).tolist()["train_samples"][0]["face_rect"],
                  prec["train_samples"][0]["face_rect"])


def test_lip_rect_and_c2w_match_jax():
    rng = np.random.RandomState(2)
    for lm in (rng.rand(68, 2).astype(np.float32), (rng.rand(68, 2) * 300 + 50).astype(np.float32)):
        assert PB.get_lip_rect(lm, 512, 480) == JB.get_lip_rect(lm, 512, 480)
    euler, trans = (rng.randn(9, 3) * 0.3).astype(np.float32), (rng.randn(9, 3)).astype(np.float32)
    np.testing.assert_allclose(PB.deep3d_to_nerf_c2w(euler, trans), JB.deep3d_to_nerf_c2w(euler, trans),
                               rtol=0, atol=1e-6)


# the JPEGs of the mp4 case: the frames' colour conversion differs by swscale's rounding (RGB within 3), the
# resize and the JPEG quantisation spread it over noisy random-syntax content; measured max 13, mean <= 2.14
# (three seeds of the fixture)
STEP_FRAMES_JPEG_MAX, STEP_FRAMES_JPEG_MEAN = 16, 2.5

_CV2_STEP_FRAMES = textwrap.dedent("""
    import sys
    from genefaceplusplus_tpu.data.process import step_frames
    print(step_frames(sys.argv[1], sys.argv[2], size=int(sys.argv[3])))
""")


def _top_down_copy(path: str, out: str, h: int, w: int):
    """The AVI with its rows stored top-down (cv2's FFmpeg reader aborts on
    bottom-up frames: tests/test_torch_video_odml.py)."""
    import struct

    with open(path, "rb") as f:
        data = bytearray(f.read())
    struct.pack_into("<i", data, data.index(b"strf") + 16, -h)
    stride = (w * 3 + 3) // 4 * 4
    at = 0
    while True:
        at = data.find(b"00db" + struct.pack("<I", stride * h), at)
        if at < 0:
            break
        rows = np.frombuffer(bytes(data[at + 8:at + 8 + stride * h]), np.uint8).reshape(h, stride)
        data[at + 8:at + 8 + stride * h] = rows[::-1].tobytes()
        at += 8 + stride * h
    with open(out, "wb") as f:
        f.write(data)


def test_step_frames_matches_jax(tmp_path):
    from genefaceplusplus_tpu_torch.data.video import StreamingVideoWriter

    T, S = 4, 48
    frames = np.random.RandomState(4).randint(0, 256, (T, S, S, 3)).astype(np.uint8)
    avi = str(tmp_path / "v.avi")
    w = StreamingVideoWriter(avi, fps=25)
    for f in frames:
        w.append(f)
    w.close()
    assert PP.step_frames(avi, str(tmp_path / "port"), size=S) == T
    _top_down_copy(avi, str(tmp_path / "top_down.avi"), S, S)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.getcwd()] + sys.path))
    run = subprocess.run([sys.executable, "-c", _CV2_STEP_FRAMES, str(tmp_path / "top_down.avi"),
                          str(tmp_path / "jax"), str(S)], capture_output=True, text=True, timeout=120, env=env)
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stdout.strip().splitlines()[-1] == str(T)
    for i in range(T):
        name = f"{i:08d}.jpg"
        with open(tmp_path / "port" / "gt_imgs" / name, "rb") as a, open(tmp_path / "jax" / "gt_imgs" / name, "rb") as b:
            assert a.read() == b.read(), name
    # an mp4 (CABAC, B-pyramid, implicit weights, an edit list) at 80x64 into S x S JPEGs
    from genefaceplusplus_tpu_torch.data.h264_decode import to_rgb
    from genefaceplusplus_tpu_torch.data.mp4 import read_mp4_frames
    from genefaceplusplus_tpu_torch.tools import h264_streams as hs

    mp4 = hs.write_fixture("cabac_b_spatial", str(tmp_path / "v.mp4"))
    n = PP.step_frames(mp4.path, str(tmp_path / "port_mp4"), size=S)
    run = subprocess.run([sys.executable, "-c", _CV2_STEP_FRAMES, mp4.path, str(tmp_path / "jax_mp4"), str(S)],
                         capture_output=True, text=True, timeout=120, env=env)
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stdout.strip().splitlines()[-1] == str(n) and n == mp4.frames
    ref = hs.ffmpeg_decode(mp4.path)  # the frames JAX's step_frames resizes
    for i, (f, bgr) in enumerate(zip(read_mp4_frames(mp4.path), ref.bgr)):
        d = np.abs(to_rgb(f).astype(np.int32) - bgr[..., ::-1].astype(np.int32))
        assert d.max() <= 3 and d.mean() <= 1.2, (i, d.max(), d.mean())
    for i in range(n):
        name = f"{i:08d}.jpg"
        a = cv2.imread(str(tmp_path / "port_mp4" / "gt_imgs" / name)).astype(np.int32)
        b = cv2.imread(str(tmp_path / "jax_mp4" / "gt_imgs" / name)).astype(np.int32)
        assert a.shape == b.shape == (S, S, 3)
        assert np.abs(a - b).max() <= STEP_FRAMES_JPEG_MAX and np.abs(a - b).mean() <= STEP_FRAMES_JPEG_MEAN, name


def test_step_audio_matches_jax(tmp_path):
    from genefaceplusplus_tpu_torch.data.audio import save_wav_16k

    for d in ("jax", "port"):
        os.makedirs(tmp_path / d)
        t = np.arange(16000) / 16000.0
        save_wav_16k((0.3 * np.sin(2 * np.pi * 180 * t)).astype(np.float32), str(tmp_path / d / "aud.wav"))
    JP.step_audio(str(tmp_path / "jax"))
    PP.step_audio(str(tmp_path / "port"))
    a = np.load(tmp_path / "jax" / "aud_mel_f0.npy", allow_pickle=True).tolist()
    b = np.load(tmp_path / "port" / "aud_mel_f0.npy", allow_pickle=True).tolist()
    np.testing.assert_allclose(b["mel"], a["mel"], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(b["f0"], a["f0"])
    with pytest.raises(FileNotFoundError, match="16 kHz wav"):
        PP.step_audio(str(tmp_path))


def test_mediapipe_absence_and_fallbacks(tmp_path, capsys):
    from genefaceplusplus_tpu.data import mp_extract as JM
    from genefaceplusplus_tpu_torch.data import mp_extract as PM

    for cls in ("MediapipeLandmarker", "MediapipeSegmenter"):
        with pytest.raises(RuntimeError) as pe:
            getattr(PM, cls)()
        with pytest.raises(RuntimeError) as je:
            getattr(JM, cls)()
        assert str(pe.value) == str(je.value) and "lms_2d.npy" in str(pe.value)
    a, b = (np.random.RandomState(s).rand(3, 478, 2).astype(np.float32) for s in (0, 1))
    np.testing.assert_array_equal(PM.fuse_img_vid_lm478(a, b), JM.fuse_img_vid_lm478(a, b))
    assert PM.INDEX_MOUTH_FROM_LM478 == JM.INDEX_MOUTH_FROM_LM478

    d = str(tmp_path)
    os.makedirs(os.path.join(d, "gt_imgs"))
    cv2.imwrite(os.path.join(d, "gt_imgs", "00000000.jpg"), np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(RuntimeError, match="mediapipe is not installed"):
        PP.step_landmarks(d)
    with pytest.raises(RuntimeError, match="mediapipe is not installed"):
        PP.step_segment(d)
    np.save(os.path.join(d, "lms_2d.npy"), np.zeros((1, 68, 2), np.float32))
    PP.step_landmarks(d)
    assert "using existing lms_2d.npy" in capsys.readouterr().out


def test_process_main_runs_every_step(tmp_path):
    """An AVI identity at 64^2 through every step on the CPU; both packages'
    datasets read the record."""
    from genefaceplusplus_tpu.data.dataset import RADNeRFDataset as JDataset
    from genefaceplusplus_tpu_torch.data.audio import save_wav_16k
    from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset
    from genefaceplusplus_tpu_torch.data.image_io import write_png
    from genefaceplusplus_tpu_torch.data.segmenter import encode_segmap_image, onehot_from_categories
    from genefaceplusplus_tpu_torch.data.synthetic_face import synthetic_face
    from genefaceplusplus_tpu_torch.data.mp4 import read_mp4
    from genefaceplusplus_tpu_torch.data.video import StreamingVideoWriter

    T, S, vid = 12, 64, "Tiny"
    ds = synthetic_face(num_frames=T, size=S, seed=3, head_masks=True)
    samples = ds["train_samples"] + ds["val_samples"]
    data = str(tmp_path / "data")
    os.makedirs(os.path.join(data, "raw", "videos"))
    w = StreamingVideoWriter(os.path.join(data, "raw", "videos", f"{vid}.avi"), fps=25)
    for s in samples:
        w.append(s["gt_img"])
    w.close()
    proc = os.path.join(data, "processed", "videos", vid)
    os.makedirs(os.path.join(proc, "segmaps"))
    save_wav_16k(np.sin(np.arange(T * 640) * 0.07).astype(np.float32) * 0.3, os.path.join(proc, "aud.wav"))
    for i, s in enumerate(samples):
        cat = np.where(s["head_mask"], 3, np.where(s["torso_img"][..., 3] > 127, 4, 0))
        write_png(os.path.join(proc, "segmaps", f"{i:08d}.png"), encode_segmap_image(onehot_from_categories(cat)))
    np.save(os.path.join(proc, "lms_2d.npy"), (np.stack([s["lms"] for s in samples]) * 512).astype(np.float32))
    walls = PP.main(["--video_id", vid, "--data_dir", data, "--device", "cpu", "--size", str(S),
                     "--steps", "frames,audio,segment,landmarks,fit,debug_fit,background,binarize"])
    assert list(walls) == ["frames", "audio", "segment", "landmarks", "fit", "debug_fit", "background", "binarize"]
    debug, _ = read_mp4(os.path.join(proc, "debug_fit.mp4"))  # the default name: an H.264 mp4
    assert debug.shape == (T, S, 2 * S, 3)
    rec = os.path.join(data, "binary", "videos", vid, "trainval_dataset.npy")
    for cls in (RADNeRFDataset, JDataset):
        d = cls(rec, split="train", with_sr=False)
        assert len(d) == 10 and d.H == S
    with pytest.raises(ValueError, match="unknown step"):
        PP.main(["--video_id", vid, "--data_dir", data, "--steps", "nope"])
