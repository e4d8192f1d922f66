"""Training entry point (port of `genefaceplusplus_tpu/training/run.py`):

    python -m genefaceplusplus_tpu_torch.training.run --config egs/... \\
        --exp_name NAME [--hparams k=v,...] [--reset] [--work_dir DIR] [--device cpu]

The task comes from the config's `task_cls` (JAX's `TASK_REGISTRY`): the
head (`HeadNeRFTask`, or `SRHeadNeRFTask` with `with_sr`), the torso
(`TorsoNeRFTask`, from `head_model_dir`), the audio-to-motion flow-VAE
(`A2MTask`; `egs/datasets/May/audio2motion_vae.yaml`) or the postnet
refiner (`PostnetTask`; `egs/datasets/May/postnet.yaml`). The dataset is
`binary_data_dir/video_id/trainval_dataset.npy`, rendered at half size
where `with_sr` (JAX's default, also for the dataset of a head config that
does not set it), with the held-out val split where it has one; the a2m
and postnet tasks read only its arrays (`hubert`, `f0`, `exp`,
`idexp_lm3d`), never an image. The work dir gets JAX-layout checkpoints
and config.yaml, with the resolved `binary_data_dir` and `video_id`. It
runs on the card unless `--device` names another.
"""

from __future__ import annotations

import argparse
import os

TASK_REGISTRY = {
    "tasks.radnerfs.radnerf.RADNeRFTask": "head",
    "tasks.radnerfs.radnerf_sr.RADNeRFTask": "head",
    "tasks.radnerfs.radnerf_torso.RADNeRFTorsoTask": "torso",
    "tasks.radnerfs.radnerf_torso_sr.RADNeRFTorsoTask": "torso",
    "head": "head",
    "torso": "torso",
    "a2m": "a2m",
    "postnet": "postnet",
}


def _dataset(cfg, path: str, split: str):
    from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset

    return RADNeRFDataset(path, split=split, camera_scale=cfg.get("camera_scale", 4.0),
                          camera_offset=tuple(cfg.get("camera_offset", (0.0, 0.0, 0.0))),
                          cond_win_size=cfg.get("cond_win_size", 1),
                          smo_win_size=cfg.get("smo_win_size", 3),
                          with_sr=cfg.get("with_sr", True))


def build_task(cfg, device=None):
    """The task a resolved config names, with its train (and val) dataset."""
    from genefaceplusplus_tpu_torch.models.radnerf import RADNeRFConfig
    from genefaceplusplus_tpu_torch.training.radnerf_task import TaskHParams
    from genefaceplusplus_tpu_torch.training.tasks.head_task import HeadNeRFTask, HeadTaskConfig

    kind = TASK_REGISTRY.get(cfg.get("task_cls", "head"), "head")
    ds_path = os.path.join(cfg["binary_data_dir"], cfg["video_id"], "trainval_dataset.npy")
    dataset = _dataset(cfg, ds_path, "train")
    seed = cfg.get("seed", 9999)
    if kind == "a2m":  # the widths are A2MTaskConfig's defaults, as in JAX
        from genefaceplusplus_tpu_torch.training.tasks.a2m_task import A2MTask, A2MTaskConfig

        target = cfg.get("a2m_target", "exp")
        return A2MTask(dataset, A2MTaskConfig(
            lr=cfg.get("lr", 5e-4), lambda_kl=cfg.get("lambda_kl", 0.02),
            kl_anneal_steps=cfg.get("kl_anneal_steps", 20000), seq_len=cfg.get("seq_len", 64),
            batch_size=cfg.get("batch_size", 8), use_pitch=cfg.get("use_pitch", True),
            audio_in_dim=cfg.get("audio_in_dim", 1024), target=target,
            in_out_dim=cfg.get("a2m_in_out_dim", 204 if target == "idexp_lm3d" else 64)),
            seed=seed, device=device)
    if kind == "postnet":
        from genefaceplusplus_tpu_torch.training.tasks.postnet_task import PostnetTask, PostnetTaskConfig

        return PostnetTask(dataset, PostnetTaskConfig(
            lr=cfg.get("lr", 1e-4), seq_len=cfg.get("seq_len", 64), batch_size=cfg.get("batch_size", 4),
            hidden=cfg.get("postnet_hidden", 256), n_layers=cfg.get("postnet_layers", 4)),
            seed=seed, device=device)
    hp = TaskHParams(
        lambda_weights_entropy=cfg.get("lambda_weights_entropy", 1e-4),
        target_ambient_loss=float(cfg.get("target_ambient_loss", 1e-8) or 1e-8),
        lr_lambda_ambient=cfg.get("lr_lambda_ambient", 0.01),
        ambient_loss_mode=cfg.get("ambient_loss_mode", "mae"),
    )
    if kind == "torso":
        from genefaceplusplus_tpu_torch.training.tasks.torso_task import TorsoNeRFTask

        task = TorsoNeRFTask(dataset, RADNeRFConfig.from_hparams(cfg), cfg, seed=seed, device=device)
    elif cfg.get("with_sr", False):
        from genefaceplusplus_tpu_torch.training.tasks.sr_task import SRHeadNeRFTask, SRTaskConfig

        tcfg = SRTaskConfig(
            n_rays=dataset.H * dataset.W,
            update_extra_interval=cfg.get("update_extra_interval", 16),
            lr=cfg.get("lr", 5e-4),
            sr_start_iters=cfg.get("sr_start_iters", 0),
            lpips_start_iters=cfg.get("lpips_start_iters", 200_000),
            lambda_lpips=cfg.get("lambda_lpips_loss", 0.001),
            lambda_dual_fm=cfg.get("lambda_dual_fm", 0.0),
            disc_model_dir=cfg.get("disc_model_dir", ""),
            lip_window=cfg.get("lip_window", 64),
            finetune_lips=cfg.get("finetune_lips", True),
            finetune_lips_start_iter=cfg.get("finetune_lips_start_iter", 200_000),
            sr_dtype=cfg.get("sr_dtype", "bfloat16"),
            perceptual_arch=cfg.get("perceptual_arch", "small"),
            vgg_weights_path=cfg.get("vgg_weights_path", ""),
            vggface_weights_path=cfg.get("vggface_weights_path", ""),
        )
        task = SRHeadNeRFTask(dataset, RADNeRFConfig.from_hparams(cfg), tcfg, hp, seed=seed, device=device)
    else:
        task = HeadNeRFTask(dataset, RADNeRFConfig.from_hparams(cfg), HeadTaskConfig.from_hparams(cfg),
                            hp, seed=seed, device=device)
    try:  # the held-out val split (1/11 of the frames)
        task.val_dataset = _dataset(cfg, ds_path, "val")
    except (KeyError, IndexError, ValueError):
        pass  # no val split (an empty val_samples raises ValueError)
    return task


def main(argv=None):
    """Train as the config says; returns the final train state."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--exp_name", type=str, default="")
    p.add_argument("--hparams", type=str, default="")
    p.add_argument("--reset", action="store_true")
    p.add_argument("--work_dir", type=str, default="")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    args = p.parse_args(argv)

    from genefaceplusplus_tpu_torch.config import set_hparams
    from genefaceplusplus_tpu_torch.training.trainer import Trainer

    work_dir = args.work_dir or os.path.join("checkpoints", args.exp_name or "default")
    cfg = set_hparams(config=args.config, exp_name=args.exp_name, hparams_str=args.hparams,
                      work_dir=work_dir, reset=args.reset)
    # the resolved data location, so the work dir describes itself for inference
    cfg = cfg.replace(binary_data_dir=os.path.abspath(cfg.get("binary_data_dir", "data/binary/videos")),
                      video_id=cfg.get("video_id", ""))
    task = build_task(cfg, device=args.device)
    trainer = Trainer(
        task, work_dir, config=cfg,
        max_updates=cfg.get("max_updates", 250_000),
        val_check_interval=cfg.get("val_check_interval", 2000),
        tb_log_interval=cfg.get("tb_log_interval", 100),
        num_ckpt_keep=cfg.get("num_ckpt_keep", 1),
        update_extra_interval=cfg.get("update_extra_interval", 16),
        print_nan_grads=cfg.get("print_nan_grads", False),
    )
    return trainer.fit(resume=not args.reset)


if __name__ == "__main__":
    main()
