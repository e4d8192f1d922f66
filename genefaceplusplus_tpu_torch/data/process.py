"""Data preparation: raw video -> processed dir -> binarized dataset (port of
`genefaceplusplus_tpu/data/process.py`).

    python -m genefaceplusplus_tpu_torch.data.process --video_id V \\
        [--data_dir data] [--steps frames,audio,segment,landmarks,fit,binarize] \\
        [--device cpu]

The steps of the reference's run.sh, each resumable: frames, audio, segment
(crops, inpainted torso, background, composited frames), landmarks, fit
(the 3DMM fit on `--device`, the card unless named), debug_fit (the fit's
check video), binarize; `background` is the segmentation-free fallback.
`main` prints and returns each step's wall time.

The video is `raw/videos/<id>.mp4`, as JAX's (the port's own `.avi` is
taken where no mp4 is there): H.264 in mp4 or QuickTime, decoded on the
host (`data/video.py:read_video`), where JAX decodes with cv2. mediapipe
(landmarks, segmentation) is absent: those steps take precomputed
`lms_2d.npy` and `segmaps/*.png` as JAX's do. The audio step
writes `aud_hubert.npy` with the port's HuBERT on `--device` where a local
snapshot is found (`data/audio.py`), and otherwise asks for the file.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict

import numpy as np

from genefaceplusplus_tpu_torch.data.image_io import read_image, write_jpeg


def step_frames(video_path: str, out_dir: str, size: int = 512, fps: int = 25) -> int:
    """Decode, resize to size x size and write gt_imgs/<i>.jpg (cv2.imwrite's
    JPEG), each frame as it is decoded. Returns the frame count."""
    from genefaceplusplus_tpu_torch.data.dataset import resize_bilinear
    from genefaceplusplus_tpu_torch.data.video import read_video

    os.makedirs(os.path.join(out_dir, "gt_imgs"), exist_ok=True)
    n = 0
    for frame in read_video(video_path):
        if frame.shape[:2] != (size, size):  # where cv2.resize's INTER_LINEAR samples; a copy at size
            frame = np.clip(np.round(resize_bilinear(frame, size, size)), 0, 255).astype(np.uint8)
        write_jpeg(os.path.join(out_dir, "gt_imgs", f"{n:08d}.jpg"), frame)
        n += 1
    return n


def step_audio(out_dir: str, device=None) -> None:
    """aud.wav -> aud_mel_f0.npy (mel and f0), and aud_hubert.npy (HuBERT on
    `device`, the card unless named) where a local snapshot is found;
    otherwise aud_hubert.npy must be supplied."""
    from genefaceplusplus_tpu_torch.data import audio as audio_lib

    wav_path = os.path.join(out_dir, "aud.wav")
    if not os.path.exists(wav_path):
        raise FileNotFoundError(
            f"{wav_path} missing: extract the audio to a 16 kHz wav first (ffmpeg or any demuxer; "
            "this image has no ffmpeg).")
    wav = audio_lib.load_wav_16k(wav_path)
    wav, mel = audio_lib.extract_mel(wav)
    f0 = audio_lib.extract_f0(wav, mel_len=len(mel))
    np.save(os.path.join(out_dir, "aud_mel_f0.npy"), {"mel": mel, "f0": f0}, allow_pickle=True)
    if audio_lib.hubert_available():
        np.save(os.path.join(out_dir, "aud_hubert.npy"), audio_lib.get_hubert_from_16k_speech(wav, device=device))
    else:
        print("| hubert weights unavailable: provide aud_hubert.npy separately")


def _frame_names(out_dir: str):
    return sorted(os.listdir(os.path.join(out_dir, "gt_imgs")))


def _load_frame(out_dir: str, name: str) -> np.ndarray:
    return read_image(os.path.join(out_dir, "gt_imgs", name))[..., :3]


def step_landmarks(out_dir: str, mp_model_path: str = None) -> None:
    """Mediapipe 478-point landmarks -> lms_2d.npy [T, 478, 2] in pixels, the
    IMAGE and VIDEO modes fused per region (face_landmarker.py:44-126);
    without mediapipe an existing lms_2d.npy is used."""
    lm_path = os.path.join(out_dir, "lms_2d.npy")
    try:
        from genefaceplusplus_tpu_torch.data.mp_extract import MediapipeLandmarker

        landmarker = MediapipeLandmarker(mp_model_path)
    except (RuntimeError, FileNotFoundError) as e:
        if os.path.exists(lm_path):
            print(f"| landmarker unavailable ({e}); using existing lms_2d.npy")
            return
        raise
    frames = [_load_frame(out_dir, name) for name in _frame_names(out_dir)]
    lms = landmarker.extract_fused_lm478(frames)
    np.save(lm_path, lms.astype(np.float32))
    print(f"| wrote {lm_path} {lms.shape}")


def step_segment(out_dir: str, mp_model_path: str = None) -> None:
    """Segmentation-guided preparation (extract_segment_imgs.py): per-frame
    segmaps, head / torso / person RGBA crops, inpainted torso images, the
    nearest-neighbour background and com_imgs (the person over it).

    Segmaps come from mediapipe when it is there, else from precomputed
    segmaps/ pngs."""
    from genefaceplusplus_tpu_torch.data import segmenter as seg_lib

    seg_dir = os.path.join(out_dir, "segmaps")
    names = _frame_names(out_dir)
    T = len(names)

    have_pngs = os.path.isdir(seg_dir) and len(os.listdir(seg_dir)) >= T
    if have_pngs:
        print("| using precomputed segmaps/")
    else:
        from genefaceplusplus_tpu_torch.data.mp_extract import MediapipeSegmenter

        mp_seg = MediapipeSegmenter(mp_model_path)
        mp_video_seg = mp_seg._vision.ImageSegmenter.create_from_options(mp_seg.video_options)

    def get_segmap(i, name, img):
        if have_pngs:
            return seg_lib.load_segmap(os.path.join(seg_dir, os.path.splitext(name)[0] + ".png"))
        import mediapipe as mp

        image = mp.Image(image_format=mp.ImageFormat.SRGB, data=np.asarray(img, np.uint8))
        cat = mp_video_seg.segment_for_video(image, 40 * i).category_mask
        return seg_lib.onehot_from_categories(cat.numpy_view().copy().astype(np.int64))

    # pass 1: per-frame crops and inpainted torso, keeping only the frames
    # the background samples (a 5-minute 512^2 video would need ~6 GB)
    interval = 5 if T <= 100 else (20 if T < 10000 else T // 500)
    sample_idx = set(range(0, T, interval)) if T > interval else {0}
    bg_frames, bg_segmaps = [], []
    for i, name in enumerate(names):
        img = _load_frame(out_dir, name)
        segmap = get_segmap(i, name, img)
        seg_lib.generate_segment_images(out_dir, name, img, segmap)
        if i in sample_idx:
            bg_frames.append(img)
            bg_segmaps.append(segmap)

    bg = seg_lib.extract_background(bg_frames, bg_segmaps, select_interval=1)
    write_jpeg(os.path.join(out_dir, "bg.jpg"), bg)

    # pass 2: com_imgs = the person over the reconstructed background
    com_dir = os.path.join(out_dir, "com_imgs")
    os.makedirs(com_dir, exist_ok=True)
    for name in names:
        img = _load_frame(out_dir, name)
        segmap = seg_lib.load_segmap(os.path.join(seg_dir, os.path.splitext(name)[0] + ".png"))
        person, mask = seg_lib.segment_out(img, segmap, "person")
        write_jpeg(os.path.join(com_dir, os.path.splitext(name)[0] + ".jpg"),
                   np.where(mask[..., None], person, bg))
    print(f"| segment step done: {T} frames")


def step_background(out_dir: str, n_samples: int = 32) -> None:
    """A static background without segmentation: the per-pixel median of
    sampled frames (the fallback where no segmaps exist)."""
    names = _frame_names(out_dir)
    idx = np.linspace(0, len(names) - 1, min(n_samples, len(names))).astype(int)
    frames = np.stack([_load_frame(out_dir, names[i]) for i in idx])
    write_jpeg(os.path.join(out_dir, "bg.jpg"), np.median(frames, axis=0).astype(np.uint8))


def step_fit(out_dir: str, bfm_dir: str = "deep_3drecon/BFM", device=None) -> Dict:
    """lms_2d.npy -> coeff_fit_mp.npy through the 3DMM fit on `device` (the
    card unless named). Returns the fit's dict."""
    from genefaceplusplus_tpu_torch.data.face3d import Face3DHelper
    from genefaceplusplus_tpu_torch.data.fit_3dmm import fit_3dmm_for_video
    from genefaceplusplus_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    lms = np.load(os.path.join(out_dir, "lms_2d.npy"))
    if lms.shape[1] in (468, 478):
        helper = Face3DHelper.load(bfm_dir, keypoint_mode="mediapipe", device=dev)
        lms = lms[:, :468]
    else:
        helper = Face3DHelper.load(bfm_dir, keypoint_mode="lm68", device=dev)
    if lms.max() > 2.0:  # pixels -> [0, 1], at the reference's 512 whatever the frame size, as JAX
        lms = lms / 512.0
    coeff = fit_3dmm_for_video(lms.astype(np.float32), helper)
    np.save(os.path.join(out_dir, "coeff_fit_mp.npy"), coeff, allow_pickle=True)
    print(f"| 3DMM fit done on {dev}: {lms.shape[0]} frames x {lms.shape[1]} landmarks, "
          f"final loss {coeff['final_loss']:.2e}")
    return coeff


def step_binarize(out_dir: str, binary_out: str, bfm_dir: str = "deep_3drecon/BFM", device=None) -> None:
    from genefaceplusplus_tpu_torch.data.binarizer import binarize

    binarize(out_dir, binary_out, bfm_dir, device=device)
    print(f"| wrote {binary_out}")


def main(argv=None) -> Dict[str, float]:
    """Run the steps in order; returns each step's wall time in seconds."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--video_id", type=str, required=True)
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--steps", type=str, default="frames,audio,segment,landmarks,fit,binarize")
    p.add_argument("--mp_model_dir", type=str, default=None,
                   help="dir holding face_landmarker.task / selfie_multiclass_256x256.tflite")
    p.add_argument("--bfm_dir", type=str, default="deep_3drecon/BFM")
    p.add_argument("--size", type=int, default=512, help="frame resize target (the reference pipeline is 512)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device of HuBERT and the fit (default: the CUDA card; 'cpu' to run on the CPU)")
    args = p.parse_args(argv)

    raw = os.path.join(args.data_dir, "raw/videos", f"{args.video_id}.mp4")
    if not os.path.exists(raw):  # the port's own AVI
        raw = os.path.join(args.data_dir, "raw/videos", f"{args.video_id}.avi")
    out_dir = os.path.join(args.data_dir, "processed/videos", args.video_id)
    binary_out = os.path.join(args.data_dir, "binary/videos", args.video_id, "trainval_dataset.npy")
    os.makedirs(out_dir, exist_ok=True)
    mp_dir = args.mp_model_dir

    walls = {}
    for step in args.steps.split(","):
        step = step.strip()
        print(f"| step: {step}")
        t0 = time.perf_counter()
        if step == "frames":
            print(f"| {step_frames(raw, out_dir, size=args.size)} frames")
        elif step == "audio":
            step_audio(out_dir, device=args.device)
        elif step == "segment":
            step_segment(out_dir, os.path.join(mp_dir, "selfie_multiclass_256x256.tflite") if mp_dir else None)
        elif step == "background":
            step_background(out_dir)
        elif step == "landmarks":
            step_landmarks(out_dir, os.path.join(mp_dir, "face_landmarker.task") if mp_dir else None)
        elif step == "fit":
            step_fit(out_dir, args.bfm_dir, device=args.device)
        elif step == "debug_fit":
            from genefaceplusplus_tpu_torch.data.visualization import debug_fit_video

            debug_fit_video(out_dir, bfm_dir=args.bfm_dir, device=args.device)
        elif step == "binarize":
            step_binarize(out_dir, binary_out, args.bfm_dir, device=args.device)
        else:
            raise ValueError(f"unknown step {step}")
        walls[step] = time.perf_counter() - t0
        print(f"| step {step}: {walls[step]:.3f} s")
    return walls


if __name__ == "__main__":
    main()
