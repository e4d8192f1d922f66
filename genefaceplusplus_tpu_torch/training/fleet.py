"""Identity training, stage by stage, resumable (port of
`genefaceplusplus_tpu/training/fleet.py`).

For each identity of a list: data preparation (`data/process.py`), the head
(+ SR) stage, then the torso stage, each through `training/run.py:main`
with shared base configs. A stage whose work dir already holds a checkpoint
is skipped, so running the command again resumes; the torso stage gets
`head_model_dir=<head dir>` in its hparams.

    python -m genefaceplusplus_tpu_torch.training.fleet --video_ids May,Obama \\
        --head_config egs/datasets/May/lm3d_radnerf_sr.yaml \\
        --torso_config egs/datasets/May/lm3d_radnerf_torso_sr.yaml \\
        [--steps preprocess,head,torso] [--max_updates_head 250000] [--device cpu]

`--device` (the card unless named) is passed on to every stage.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional


def _stage_done(work_dir: str) -> bool:
    from genefaceplusplus_tpu_torch.utils.ckpt import get_all_ckpts

    return os.path.isdir(work_dir) and bool(get_all_ckpts(work_dir))


def train_identity(
    video_id: str,
    head_config: str,
    torso_config: Optional[str] = None,
    data_dir: str = "data",
    ckpt_root: str = "checkpoints",
    steps: List[str] = ("preprocess", "head", "torso"),
    extra_hparams: str = "",
    max_updates: Optional[Dict[str, int]] = None,
    device: Optional[str] = None,
) -> Dict[str, str]:
    """Run one identity's stages; returns stage -> work dir (the
    preprocess stage: the binarized record)."""
    from genefaceplusplus_tpu_torch.training import run as run_mod

    max_updates = max_updates or {}
    out: Dict[str, str] = {}
    dev = ["--device", str(device)] if device is not None else []

    binary_npy = os.path.join(data_dir, "binary/videos", video_id, "trainval_dataset.npy")
    if "preprocess" in steps:
        if os.path.exists(binary_npy):
            print(f"| [{video_id}] preprocess: {binary_npy} exists, skipping")
        else:
            from genefaceplusplus_tpu_torch.data import process as process_mod

            process_mod.main(["--video_id", video_id, "--data_dir", data_dir] + dev)
        out["preprocess"] = binary_npy

    def _hp(stage: str, extra: str = "") -> str:
        parts = [f"video_id={video_id}"]
        if stage in max_updates:
            parts.append(f"max_updates={max_updates[stage]}")
        if extra:
            parts.append(extra)
        if extra_hparams:
            parts.append(extra_hparams)
        return ",".join(parts)

    head_dir = os.path.join(ckpt_root, f"{video_id}_head")
    if "head" in steps:
        if _stage_done(head_dir):
            print(f"| [{video_id}] head: checkpoint exists, skipping")
        else:
            run_mod.main(["--config", head_config, "--exp_name", f"{video_id}_head",
                          "--work_dir", head_dir, "--hparams", _hp("head")] + dev)
        out["head"] = head_dir

    if "torso" in steps and torso_config:
        torso_dir = os.path.join(ckpt_root, f"{video_id}_torso")
        if _stage_done(torso_dir):
            print(f"| [{video_id}] torso: checkpoint exists, skipping")
        else:
            run_mod.main(["--config", torso_config, "--exp_name", f"{video_id}_torso",
                          "--work_dir", torso_dir,
                          "--hparams", _hp("torso", f"head_model_dir={head_dir}")] + dev)
        out["torso"] = torso_dir
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--video_ids", type=str, required=True, help="comma-separated identity list")
    p.add_argument("--head_config", type=str, required=True)
    p.add_argument("--torso_config", type=str, default="")
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--ckpt_root", type=str, default="checkpoints")
    p.add_argument("--steps", type=str, default="preprocess,head,torso")
    p.add_argument("--hparams", type=str, default="")
    p.add_argument("--max_updates_head", type=int, default=0)
    p.add_argument("--max_updates_torso", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device of every stage (default: the CUDA card; 'cpu' to run on the CPU)")
    args = p.parse_args(argv)

    mu = {}
    if args.max_updates_head:
        mu["head"] = args.max_updates_head
    if args.max_updates_torso:
        mu["torso"] = args.max_updates_torso

    results = {}
    for vid in [v.strip() for v in args.video_ids.split(",") if v.strip()]:
        print(f"|==== identity {vid} ====")
        results[vid] = train_identity(
            vid, args.head_config, args.torso_config or None,
            data_dir=args.data_dir, ckpt_root=args.ckpt_root,
            steps=[s.strip() for s in args.steps.split(",")],
            extra_hparams=args.hparams, max_updates=mu, device=args.device,
        )
    print("| fleet done:")
    for vid, stages in results.items():
        for stage, path in stages.items():
            print(f"|   {vid}.{stage}: {path}")
    return results


if __name__ == "__main__":
    main()
