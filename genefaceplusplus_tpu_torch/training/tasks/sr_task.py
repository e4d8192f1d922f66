"""Head + 2x SR training task (port of
`genefaceplusplus_tpu/training/tasks/sr_task.py`).

Full-frame steps (every ray of the half-resolution frame), losses mse +
weights entropy + the adaptive masked ambient (no ramp, as JAX's SR task)
+ SR mse (from `sr_start_iters`) + perceptual on the raw frame, the SR
frame (half weight) and the SR frame's lip crop (half weight), from
`lpips_start_iters`. The state's model is a `ModuleDict` {'head': RADNeRF,
'sr': Superresolution}, written as JAX's params {'head', 'sr'}; the SR
blocks compute in bf16 by default (`sr_dtype`) with float32 parameters,
and the optimizer steps the SR's `noise_const` buffers as optax steps
JAX's (they are in its params tree). Validation adds `val_sr_psnr`, the
SR frame against the stored full-resolution gt, and saves the SR renders
as PNG. From `train_compact_start` on the head field runs on a compacted
budget of live samples (the head task's switch; the batch is a full frame,
so the live fraction is the head's screen coverage).

With `lambda_dual_fm > 0` a frozen dual discriminator scores the SR frame
with the raw frame and the gt pair under the frame's EG3D camera label,
and the step adds `lambda_dual_fm` x the L1 between their per-resolution
feature maps (`dual_feature_matching_loss`, with the perceptual terms from
`lpips_start_iters`). `disc_arch` "eg3d" is the reference's
discriminator at 2H (its mapping depth from `disc_model_dir`'s
config.yaml, default 8), "compact" the small stack; with `disc_model_dir`
its weights come from that dir's newest checkpoint, every tensor
accounted for (`tools/convert_ckpt.py --type disc` writes one), else from
a seeded init. It is never trained and never checkpointed: it is not in
the state's model, so neither the optimizer, the gradient norms nor the
checkpoint see it, and its parameters need no gradient, while the
gradient flows through it into the SR and raw frames. It runs in float32
on images in [0, 1], as JAX's does: the clipped SR frame is float32 (the
SR sums its image in float32 whatever `sr_dtype`).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from genefaceplusplus_tpu_torch.config import set_hparams
from genefaceplusplus_tpu_torch.data import image_io
from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset, resize_bilinear
from genefaceplusplus_tpu_torch.data.eg3d_convention import eg3d_camera_from_euler_trans
from genefaceplusplus_tpu_torch.models.dual_discriminator import DualDiscriminator
from genefaceplusplus_tpu_torch.models.eg3d_discriminator import EG3DDualDiscriminator, feature_matching_loss
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF, RADNeRFConfig
from genefaceplusplus_tpu_torch.models.renderer import RenderOptions, render_rays
from genefaceplusplus_tpu_torch.models.superresolution import Superresolution
from genefaceplusplus_tpu_torch.training import frame_store
from genefaceplusplus_tpu_torch.training import losses as L
from genefaceplusplus_tpu_torch.training.perceptual import perceptual_from_task_config
from genefaceplusplus_tpu_torch.training.radnerf_task import TaskHParams, TrainState, create_train_state
from genefaceplusplus_tpu_torch.training.schedulers import grad_norms_by_group
from genefaceplusplus_tpu_torch.training.tasks.head_task import HeadNeRFTask, HeadTaskConfig
from genefaceplusplus_tpu_torch.utils.ckpt import get_last_checkpoint
from genefaceplusplus_tpu_torch.utils.convert_jax import convert_flax_params
from genefaceplusplus_tpu_torch.utils.rays import pixel_rays


@dataclasses.dataclass
class SRTaskConfig(HeadTaskConfig):
    sr_start_iters: int = 0
    lpips_start_iters: int = 200_000
    lambda_lpips: float = 0.001
    lambda_dual_fm: float = 0.0  # the frozen dual discriminator's feature matching
    disc_model_dir: str = ""  # a work dir holding the discriminator's checkpoint
    disc_arch: str = "eg3d"  # "eg3d" (the reference's) or "compact" (tests, tiny resolutions)
    sr_dtype: str = "bfloat16"  # the SR blocks' compute dtype; parameters stay float32


class SRHeadNeRFTask(HeadNeRFTask):
    """Full-frame head + 2x SR training."""

    def __init__(self, dataset: RADNeRFDataset, model_cfg: RADNeRFConfig,
                 task_cfg: SRTaskConfig = SRTaskConfig(), hp: TaskHParams = TaskHParams(),
                 seed: int = 9999, device=None):
        super().__init__(dataset, model_cfg, task_cfg, hp, seed, device)
        self._train_step = functools.partial(self._sr_step, opts=self.opts)
        self.sr_dtype = torch.bfloat16 if task_cfg.sr_dtype == "bfloat16" else torch.float32
        self.perceptual = perceptual_from_task_config(task_cfg, self.device)
        self.disc_model = self._frozen_discriminator() if task_cfg.lambda_dual_fm > 0 else None

    def _frozen_discriminator(self) -> nn.Module:
        """The discriminator (module docstring), on the task's device, its
        parameters without gradient."""
        tcfg: SRTaskConfig = self.task_cfg
        H = self.dataset.H
        g = torch.Generator().manual_seed(self.seed + 7)
        if tcfg.disc_arch == "eg3d":
            n_map = 8
            if tcfg.disc_model_dir:
                try:
                    n_map = int(set_hparams(work_dir=tcfg.disc_model_dir).get("disc_mapping_layers", 8))
                except (OSError, ValueError):
                    pass
            disc = EG3DDualDiscriminator(img_resolution=2 * H, mapping_layers=n_map, generator=g)
        else:
            disc = DualDiscriminator(2 * H, n_down=max(2, min(5, int(np.log2(H)) - 2)), generator=g)
        if tcfg.disc_model_dir:
            ckpt, _ = get_last_checkpoint(tcfg.disc_model_dir)
            if ckpt is None:
                raise FileNotFoundError(f"disc_model_dir={tcfg.disc_model_dir!r} has no checkpoint (convert one "
                                        "with tools/convert_ckpt.py --type disc)")
            state = ckpt.get("state_dict", ckpt)
            disc.load_state_dict(convert_flax_params(state.get("disc", state), disc))
        return disc.requires_grad_(False).to(self.device)

    def create_state(self) -> TrainState:
        head = RADNeRF(self.cfg, generator=torch.Generator().manual_seed(self.seed))
        sr = Superresolution(3, self.dataset.H, dtype=self.sr_dtype,
                             generator=torch.Generator().manual_seed(self.seed + 1))
        model = nn.ModuleDict({"head": head, "sr": sr}).to(self.device)
        noise_gen = torch.Generator(device=self.device).manual_seed(self.seed)
        return create_train_state(model, self.tx, noise_gen, self.hp)

    def _head(self, state: TrainState) -> RADNeRF:
        return state.model["head"]

    def _device_frames(self) -> Dict[str, torch.Tensor]:
        """The head's store plus the 2x gt (the stored full-resolution image,
        else the gt resized), the lip crop's top-left and the EG3D camera
        label (zeros without a discriminator)."""
        if self._dev_frames is not None:
            return self._dev_frames
        frames = super()._device_frames()
        ds = self.dataset
        T, H, W = len(ds), ds.H, ds.W
        win = min(self.task_cfg.lip_window, H, W)
        sc = H / int(ds.ds["H"])
        gt2_l, lip_l = [], []
        for i in range(T):
            g2 = ds.load_image(i, "gt", full_res=True)
            if g2 is None or g2.shape[0] != 2 * H:
                gt = ds.load_image(i, "gt")
                g2 = resize_bilinear(np.asarray(ds.bg_img if gt is None else gt), 2 * H, 2 * W)
            gt2_l.append(frame_store.quantize_u8(g2))
            rect = ds.samples[i].get("lip_rect", [0, H, 0, W])
            cy = int((rect[0] + rect[1]) / 2 * sc)
            cx = int((rect[2] + rect[3]) / 2 * sc)
            lip_l.append([int(np.clip(cy - win // 2, 0, H - win)), int(np.clip(cx - win // 2, 0, W - win))])
        if self.disc_model is not None:
            cams = eg3d_camera_from_euler_trans(np.asarray(ds.ds["euler"])[:T], np.asarray(ds.ds["trans"])[:T])
        else:
            cams = np.zeros((T, 25), np.float32)
        frames["gt2x"] = torch.from_numpy(np.stack(gt2_l)).to(self.device)
        frames["lip_xy0"] = torch.from_numpy(np.asarray(lip_l, np.int64)).to(self.device)
        frames["camera"] = torch.from_numpy(cams).to(self.device)
        return frames

    def _gather(self, frames, idx: int) -> Dict[str, torch.Tensor]:
        ds = self.dataset
        H, W = ds.H, ds.W
        intr = tuple(float(x) for x in np.asarray(ds.intrinsics).reshape(-1))
        t_idx = torch.tensor(idx, dtype=torch.int64, device=self.device)
        rays_o, rays_d = frame_store.device_frame_rays(frames, t_idx, intr, H, W)
        return {
            "rays_o": rays_o,
            "rays_d": rays_d,
            "cond": frame_store.device_cond_window(frames, t_idx, ds.smo_win_size, len(ds.conds_all)),
            "gt_rgb": frames["gt"][idx].float().reshape(-1, 3) / 255.0,
            "gt_rgb_2x": frames["gt2x"][idx].float().reshape(-1, 3) / 255.0,
            "bg_color": frames["bg"][idx].float().reshape(-1, 3) / 255.0,
            "face_mask": frames["mask"][idx].reshape(-1),
            "idx": t_idx,
            "eye_area_percent": frames["eye"][idx][None],
            "lip_xy0": frames["lip_xy0"][idx].tolist(),
            "camera": frames["camera"][idx][None],
        }

    def sample_train_batch(self, global_step=None) -> Dict:
        """Full-frame sampling: a frame index (the batch is gathered on the
        device from the frame store)."""
        if global_step is not None:
            self._host_step = int(global_step)
        self._device_frames()
        return {"frame_idx": int(self.np_rng.randint(len(self.dataset)))}

    def _build_compact_step(self, budget: float):
        """The SR step with the head field on a compacted budget."""
        return functools.partial(self._sr_step, opts=dataclasses.replace(self.opts, compact_frac=budget))

    def train_step(self, state: TrainState, batch, noise: Optional[torch.Tensor] = None):
        """One SR step; `noise` [H*W] overrides the draw from
        `state.generator`."""
        if self._host_step is None:
            self._host_step = int(state.global_step)
        step = self._host_step
        step_fn = self._step_fn()
        b = self._gather(self._device_frames(), int(batch["frame_idx"]))
        state, metrics = step_fn(state, b, use_sr=step >= self.task_cfg.sr_start_iters,
                                 use_lpips=step >= self.task_cfg.lpips_start_iters, noise=noise)
        metrics.update(self._compact_telemetry)
        self._host_step = step + 1
        return state, metrics

    def _sr_step(self, state: TrainState, batch: Dict, use_sr: bool, use_lpips: bool,
                 noise: Optional[torch.Tensor] = None, *, opts: RenderOptions):
        head, sr_model = state.model["head"], state.model["sr"]
        cfg, hp, tcfg = self.cfg, self.hp, self.task_cfg
        H, W = self.dataset.H, self.dataset.W
        if noise is None and opts.perturb:
            noise = torch.rand(batch["rays_o"].shape[:1], generator=state.generator, device=self.device)
        state.opt.zero_grad()
        cond_feat = head.cal_cond_feat(batch["cond"], batch.get("eye_area_percent"))
        ind = head.get_individual_code(batch["idx"])
        out = render_rays(lambda x, d: head.field(x, d, cond_feat, ind), batch["rays_o"],
                          batch["rays_d"], self.occupancy, bound=cfg.bound, min_near=cfg.min_near,
                          bg_color=batch["bg_color"], opts=opts, noise=noise)
        raw = out.rgb_map.reshape(1, H, W, 3)
        mse = L.mse_loss(out.rgb_map, batch["gt_rgb"])
        went = L.weights_entropy_loss(out.weights_sum)
        amb = L.ambient_loss(out.ambient_sum, batch["face_mask"], hp.ambient_loss_mode)
        amb = torch.where(torch.isnan(amb), torch.zeros_like(amb), amb)
        total = mse + hp.lambda_weights_entropy * went + state.lambda_ambient * amb
        metrics = {"mse_loss": mse, "weights_entropy_loss": went, "ambient_loss": amb,
                   "head_psnr": L.mse2psnr(mse)}
        if use_sr:
            sr = torch.clamp(sr_model(raw), 0.0, 1.0)
            gt512 = batch["gt_rgb_2x"].reshape(1, 2 * H, 2 * W, 3)
            sr_mse = L.mse_loss(sr, gt512)
            total = total + sr_mse
            metrics["sr_mse_loss"] = sr_mse
            if use_lpips:
                lam = tcfg.lambda_lpips
                lp = self.perceptual(raw, batch["gt_rgb"].reshape(1, H, W, 3))
                lp_sr = self.perceptual(sr, gt512)
                win = min(tcfg.lip_window, H, W)
                y0, x0 = batch["lip_xy0"]

                def crop(img):  # the lip window at SR resolution
                    return img[:, 2 * y0:2 * (y0 + win), 2 * x0:2 * (x0 + win)]

                lp_lip = self.perceptual(crop(sr), crop(gt512))
                total = total + lam * lp + 0.5 * lam * lp_sr + 0.5 * lam * lp_lip
                metrics.update(lpips_loss=lp, sr_lpips_loss=lp_sr, sr_lip_lpips_loss=lp_lip)
                if self.disc_model is not None:  # the frozen discriminator's feature matching
                    def nchw(img):
                        return img.permute(0, 3, 1, 2)

                    cam = batch["camera"]
                    _, fake = self.disc_model(nchw(sr), nchw(raw), cam)
                    with torch.no_grad():
                        _, real = self.disc_model(nchw(gt512), nchw(batch["gt_rgb"].reshape(1, H, W, 3)), cam)
                    fm = feature_matching_loss(fake, real)
                    total = total + tcfg.lambda_dual_fm * fm
                    metrics["dual_feature_matching_loss"] = fm
        metrics["total_loss"] = total
        total.backward()
        named = [(n, p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in state.opt.named]
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(grad_norms_by_group(named))
        state.opt.step()
        with torch.no_grad():
            state.lambda_ambient = L.adaptive_lambda_ambient(
                state.lambda_ambient, metrics["ambient_loss"], hp.target_ambient_loss, hp.lr_lambda_ambient)
        metrics["lambda_ambient"] = state.lambda_ambient
        state.global_step += 1
        return state, metrics

    def validate(self, state: TrainState, max_frames: int = 2, save_dir: str = "",
                 ray_chunk: Optional[int] = None) -> Dict[str, float]:
        """The head's validation (raw val_psnr) and the SR frames against the
        stored full-resolution gt (val_sr_psnr); with `save_dir` the SR
        renders go to validation_results/val_sr_<step>_<i>.png."""
        ray_chunk = ray_chunk or self.val_ray_chunk
        metrics = super().validate(state, max_frames=max_frames, save_dir=save_dir, ray_chunk=ray_chunk)
        ds = self.val_dataset if self.val_dataset is not None else self.dataset
        head, sr_model = state.model["head"], state.model["sr"]
        cfg, H, W, dev = self.cfg, ds.H, ds.W, self.device
        v_opts = dataclasses.replace(self.opts, perturb=False)
        sr_psnrs = []
        with torch.no_grad():
            for i in range(min(max_frames, len(ds))):
                gt2x = ds.load_image(i, "gt", full_res=True)
                if gt2x is None or gt2x.shape[0] != 2 * H:
                    continue
                pose = torch.from_numpy(ds.frame_pose(i)[None]).to(dev)
                rays_o, rays_d = pixel_rays(pose, ds.intrinsics, H, W)
                gid = max(min(int(ds.frame_ids[i]), cfg.individual_embedding_num - 1), 0)
                cond_feat = head.cal_cond_feat(torch.from_numpy(ds.frame_cond_window(i)).to(dev),
                                               torch.from_numpy(ds.eye_area_percents[i:i + 1]).to(dev))
                ind = head.get_individual_code(gid)
                bg = ds.frame_bg_torso(i)
                bg = torch.from_numpy(np.asarray(ds.bg_img if bg is None else bg, np.float32)
                                      .reshape(-1, 3)).to(dev)
                parts = []
                for s in range(0, H * W, ray_chunk):
                    out = render_rays(lambda x, d: head.field(x, d, cond_feat, ind),
                                      rays_o[0, s:s + ray_chunk], rays_d[0, s:s + ray_chunk],
                                      self.occupancy, bound=cfg.bound, min_near=cfg.min_near,
                                      bg_color=bg[s:s + ray_chunk], opts=v_opts)
                    parts.append(out.rgb_map)
                raw = torch.cat(parts).reshape(1, H, W, 3)
                sr = torch.clamp(sr_model(raw), 0.0, 1.0)[0].cpu().numpy()
                mse = float(np.mean((sr - gt2x) ** 2))
                sr_psnrs.append(-10.0 * np.log10(max(mse, 1e-10)))
                if save_dir:
                    vdir = os.path.join(save_dir, "validation_results")
                    os.makedirs(vdir, exist_ok=True)
                    image_io.write_png(os.path.join(vdir, f"val_sr_{int(state.global_step)}_{i}.png"),
                                       (sr * 255).astype(np.uint8))
        if sr_psnrs:
            metrics["val_sr_psnr"] = float(np.mean(sr_psnrs))
        return metrics
