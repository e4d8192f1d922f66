"""Command line: JAX work dirs and audio features in, a video file out.

    python -m genefaceplusplus_tpu_torch.inference.cli --a2m_ckpt A \\
        --torso_ckpt T --drv_aud_features f.npy --out_name out.mp4

The flags and defaults of `genefaceplusplus_tpu/inference/cli.py`, plus
`--device` (the CUDA card unless named; `--device cpu` runs on the CPU).
`--drv_aud_features` is an .npy of {'hubert' [2T, C], 'f0' [2T][, 'wav16k']};
a bare `--drv_aud` wav gets its HuBERT features from the port's HuBERT on
`--device`, read from a local Hugging Face snapshot of
facebook/hubert-large-ls960-ft (`data/audio.py`; it raises where none is
found). The output
has the audio: an `.mp4` name writes H.264 + PCM mp4 (its frames encoded on
`--device`), an `.avi` name an uncompressed AVI.
`--postnet_ckpt` names a postnet work dir: its refiner runs on the a2m's
landmarks. `--color_topk K` runs the colour MLP on the K samples of highest
weight a ray; `--compact_frac` runs the head field on a budget of live
samples (a float, or "auto" to measure the request's poses). `--debug`
writes each frame beside its SECC panel and its 68 landmarks (three panels
side by side). `--n_devices N` splits each frame's field work over N
devices of `--device`'s type (`parallel/mesh.py`): the first N cards,
raising where fewer exist, or N shards of the CPU; 1 serves on one.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GeneFace++ inference (PyTorch port)")
    p.add_argument("--a2m_ckpt", type=str, default="", help="audio2motion work dir")
    p.add_argument("--postnet_ckpt", type=str, default="", help="postnet work dir")
    p.add_argument("--head_ckpt", type=str, default="", help="head NeRF work dir")
    p.add_argument("--torso_ckpt", type=str, default="", help="torso work dir")
    p.add_argument("--drv_aud", type=str, default="", help="driving wav")
    p.add_argument("--drv_aud_features", type=str, default="",
                   help="precomputed {'hubert','f0'[,'wav16k']} npy")
    p.add_argument("--drv_pose", type=str, default="nearest",
                   help="static | <idx> | <start-end> | nearest")
    p.add_argument("--blink_mode", type=str, default="period", choices=["none", "period"])
    p.add_argument("--temperature", type=float, default=0.2)
    p.add_argument("--lle_percent", type=float, default=0.2)
    p.add_argument("--mouth_amp", type=float, default=0.4)
    p.add_argument("--out_name", type=str, default="out.mp4")
    p.add_argument("--T_thresh", "--raymarching_end_threshold", dest="T_thresh",
                   type=float, default=1e-2, help="transmittance early-out")
    p.add_argument("--fast", action="store_true", help="T_thresh=0.05 for more fps")
    p.add_argument("--low_memory_usage", action="store_true", default=True)
    p.add_argument("--debug", action="store_true",
                   help="write frame | SECC | lm68 panels side by side (3x the width)")
    p.add_argument("--head_crop", type=str, default="auto", help="auto | off")
    p.add_argument("--torso_crop", type=str, default="auto", help="auto | off")
    p.add_argument("--sr_crop", type=str, default="auto", help="auto | off")
    p.add_argument("--frames_per_dispatch", type=int, default=8, help="frames rendered per chunk")
    p.add_argument("--color_topk", type=int, default=0,
                   help="colour MLP on only the K highest-weight samples a ray (0 = all)")
    p.add_argument("--compact_frac", type=str, default="0",
                   help="head field on a budget of frac x rays x samples live slots: a float, "
                        "'auto' (measured on the request's poses), or 0 = off")
    p.add_argument("--n_devices", type=int, default=1,
                   help="split each frame's field work over this many devices (the mesh's 'rays' axis; 1 = one)")
    p.add_argument("--device", type=str, default=None, help="cuda (default) | cpu")
    return p


def make_infer_mesh(n_devices: int, device=None):
    """The mesh of `n_devices` on `device` (`parallel.mesh.make_mesh`), or
    None for one device."""
    if n_devices <= 1:
        return None
    from genefaceplusplus_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n_devices, device)


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    mesh = make_infer_mesh(args.n_devices, args.device)
    from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer

    infer = GeneFaceInfer.from_work_dirs(
        audio2secc_dir=args.a2m_ckpt or None,
        head_model_dir=args.head_ckpt or None,
        torso_model_dir=args.torso_ckpt or None,
        postnet_dir=args.postnet_ckpt or None,
        device=args.device,
        mesh=mesh,
    )
    inp = {
        "drv_aud": args.drv_aud,
        "drv_aud_features": args.drv_aud_features,
        "drv_pose": args.drv_pose,
        "blink_mode": args.blink_mode,
        "temperature": args.temperature,
        "lle_percent": args.lle_percent,
        "mouth_amp": args.mouth_amp,
        "out_name": args.out_name,
        "T_thresh": 0.05 if args.fast else args.T_thresh,
        "low_memory_usage": args.low_memory_usage,
        "debug": args.debug,
        "head_crop": args.head_crop,
        "torso_crop": args.torso_crop,
        "sr_crop": args.sr_crop,
        "frames_per_dispatch": args.frames_per_dispatch,
        "color_topk": args.color_topk,
        "compact_frac": args.compact_frac,
    }
    out = infer.infer_once(inp)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
