"""Head-NeRF training task: dataset sampling, the train step, grid refresh
and validation (port of `genefaceplusplus_tpu/training/tasks/head_task.py`).

Random-frame random-ray batches (same numpy draws as the JAX task, so
frame ids and ray indices match it draw for draw), gathered on the device
from a resident frame store; losses mse + weights entropy + masked ambient
with the adaptive lambda; density-grid refresh every update_extra_interval
steps with a random condition; full-image validation with PSNR.

Not ported (they raise NotImplementedError when they would run): the lip
fine-tuning step, which needs the perceptual tower, and train-side
live-sample compaction (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset, get_boundary_mask
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF, RADNeRFConfig
from genefaceplusplus_tpu_torch.models.renderer import RenderOptions, render_rays
from genefaceplusplus_tpu_torch.training import frame_store
from genefaceplusplus_tpu_torch.training.grid_updater import mark_untrained_grid, update_density_grid
from genefaceplusplus_tpu_torch.training.radnerf_task import (
    TaskHParams,
    TrainState,
    create_train_state,
    make_train_step,
)
from genefaceplusplus_tpu_torch.training.schedulers import make_radnerf_optimizer
from genefaceplusplus_tpu_torch.utils.rays import pixel_rays


@dataclasses.dataclass
class HeadTaskConfig:
    n_rays: int = 65536
    update_extra_interval: int = 16
    lr: float = 5e-4
    warmup_updates: int = 0
    max_steps: int = 16
    num_coarse: int = 48  # grid-mode marching only (not ported)
    num_samples: int = 16
    grid_decay: float = 0.95
    finetune_lips: bool = True
    finetune_lips_start_iter: int = 200_000
    lip_window: int = 64
    lambda_lpips: float = 0.01
    perceptual_arch: str = "small"
    vgg_weights_path: str = ""
    vggface_weights_path: str = ""
    use_fused_field: bool = False
    fused_tile: int = 1024
    train_compact_start: int = 0
    train_compact_margin: float = 1.35

    @classmethod
    def from_hparams(cls, hp) -> "HeadTaskConfig":
        get = hp.get
        return cls(
            n_rays=get("n_rays", 65536),
            update_extra_interval=get("update_extra_interval", 16),
            lr=get("lr", 5e-4),
            warmup_updates=get("warmup_updates", 0),
            max_steps=get("max_steps", 16),
            finetune_lips=get("finetune_lips", True),
            finetune_lips_start_iter=get("finetune_lips_start_iter", 200_000),
            lambda_lpips=get("lambda_lpips_loss", 0.01),
            perceptual_arch=get("perceptual_arch", "small"),
            vgg_weights_path=get("vgg_weights_path", ""),
            vggface_weights_path=get("vggface_weights_path", ""),
            train_compact_start=get("train_compact_start", 0),
            train_compact_margin=get("train_compact_margin", 1.35),
        )


class HeadNeRFTask:
    def __init__(self, dataset: RADNeRFDataset, model_cfg: RADNeRFConfig,
                 task_cfg: HeadTaskConfig = HeadTaskConfig(), hp: TaskHParams = TaskHParams(),
                 seed: int = 9999, device=None):
        if task_cfg.train_compact_start > 0:
            raise NotImplementedError("train_compact_start > 0: train-side compaction is not "
                                      "ported (ROADMAP)")
        self.dataset = dataset
        self.val_dataset: Optional[RADNeRFDataset] = None
        self.cfg = model_cfg
        self.task_cfg = task_cfg
        self.hp = hp
        self.device = torch.device(device if device is not None else "cpu")
        self.tx = make_radnerf_optimizer(task_cfg.lr, task_cfg.warmup_updates)
        self.opts = RenderOptions(max_steps=task_cfg.max_steps,
                                  num_samples=task_cfg.num_samples, perturb=True)
        self._train_step = make_train_step(self.opts, hp, use_fused_field=task_cfg.use_fused_field,
                                           fused_tile=task_cfg.fused_tile)
        self._host_step: Optional[int] = None
        self.np_rng = np.random.RandomState(seed)
        self.seed = seed

        H = model_cfg.grid_size
        self.density_grid = mark_untrained_grid(
            torch.zeros((H, H, H), device=self.device), dataset.poses, dataset.intrinsics,
            model_cfg.bound)
        self.occupancy = torch.ones((H, H, H), dtype=torch.bool, device=self.device)
        self.mean_density = 0.0
        self._grid_gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.grid_telemetry: Dict[str, float] = {}
        self._face_masks: Dict[int, np.ndarray] = {}
        self._dev_frames = None

    # ------------------------------------------------------------------
    def create_state(self) -> TrainState:
        """Fresh parameters from the seed (random initialisation), their
        optimizer and the ray-noise generator."""
        model = RADNeRF(self.cfg, generator=torch.Generator().manual_seed(self.seed)).to(self.device)
        noise_gen = torch.Generator(device=self.device).manual_seed(self.seed)
        return create_train_state(model, self.tx, noise_gen, self.hp)

    def _face_mask(self, idx: int) -> np.ndarray:
        if idx not in self._face_masks:
            ds = self.dataset
            lms = ds.samples[idx].get("lms")
            if lms is not None:
                mask = get_boundary_mask(np.asarray(lms, np.float32), ds.H, ds.W)
            else:
                rect = ds.samples[idx].get("face_rect")
                mask = np.zeros((ds.H, ds.W), bool)
                if rect is not None:
                    sc = ds.H / int(ds.ds["H"])
                    x0, x1, y0, y1 = (int(v * sc) for v in rect)
                    mask[x0:x1, y0:y1] = True
            self._face_masks[idx] = mask
        return self._face_masks[idx]

    def _device_frames(self) -> Dict[str, torch.Tensor]:
        """Device-resident per-frame store (gt/bg/mask/pose/cond), uint8
        images as the dataset quantises them."""
        if self._dev_frames is not None:
            return self._dev_frames
        ds = self.dataset
        bg_l, mask_l = [], []
        for i in range(len(ds)):
            bg = ds.frame_bg_torso(i)
            bg_l.append(frame_store.quantize_u8(ds.bg_img if bg is None else bg))
            mask_l.append(self._face_mask(i))
        self._dev_frames = {
            **frame_store.base_device_frames(ds, self.device),
            "bg": torch.from_numpy(np.stack(bg_l)).to(self.device),
            "mask": torch.from_numpy(np.stack(mask_l)).to(self.device),
        }
        return self._dev_frames

    def _make_ray_gather(self):
        """On-device batch assembly for a frame index and ray indices."""
        ds = self.dataset
        H, W = ds.H, ds.W
        T_all = len(ds.conds_all)
        intr = tuple(float(x) for x in np.asarray(ds.intrinsics).reshape(-1))
        smo = ds.smo_win_size

        def gather(frames, idx, inds):
            rays_o, rays_d = frame_store.device_frame_rays(frames, idx, intr, H, W, inds)
            return {
                "rays_o": rays_o,
                "rays_d": rays_d,
                "cond": frame_store.device_cond_window(frames, idx, smo, T_all),
                "gt_rgb": frames["gt"][idx].reshape(-1, 3)[inds].float() / 255.0,
                "bg_color": frames["bg"][idx].reshape(-1, 3)[inds].float() / 255.0,
                "face_mask": frames["mask"][idx].reshape(-1)[inds],
                "idx": idx,
                "eye_area_percent": frames["eye"][idx][None],
            }

        return gather

    def _lip_active(self, gs: int) -> bool:
        return self.task_cfg.finetune_lips and gs > self.task_cfg.finetune_lips_start_iter

    def sample_train_batch(self, global_step=None) -> Dict:
        """A frame index and ray indices, drawn with the JAX task's numpy
        calls in its order; the rest is gathered on the device."""
        if global_step is not None:
            self._host_step = int(global_step)
        gs = self._host_step or 0
        if self._lip_active(gs):
            raise NotImplementedError("lip fine-tuning (finetune_lips past "
                                      "finetune_lips_start_iter) needs the perceptual tower, "
                                      "which is not ported (ROADMAP)")
        self._device_frames()
        ds = self.dataset
        idx = int(self.np_rng.randint(len(ds)))
        inds = self.np_rng.randint(0, ds.H * ds.W, size=self.task_cfg.n_rays)
        return {"frame_idx": idx, "inds": inds.astype(np.int32)}

    def train_step(self, state: TrainState, batch, noise: Optional[torch.Tensor] = None):
        if self._host_step is None:
            self._host_step = int(state.global_step)
        frames = self._device_frames()
        idx = torch.tensor(batch["frame_idx"], dtype=torch.int64, device=self.device)
        inds = torch.as_tensor(batch["inds"], device=self.device).long()
        gathered = self._make_ray_gather()(frames, idx, inds)
        state, metrics = self._train_step(state, gathered, self.occupancy, noise)
        metrics.update(self.grid_telemetry)
        self._host_step += 1
        return state, metrics

    def update_extra_state(self, state: TrainState):
        """Density-grid EMA refresh with a random condition."""
        gs = self._host_step if self._host_step is not None else int(state.global_step)
        if self._lip_active(gs):
            return
        ds = self.dataset
        idx = int(self.np_rng.randint(len(ds)))
        cond = torch.from_numpy(ds.frame_cond_window(idx)).to(self.device)
        model, cfg = state.model, self.cfg
        with torch.no_grad():
            cond_feat = model.cal_cond_feat(cond)
            self.density_grid, self.occupancy, mean_d = update_density_grid(
                lambda pts: model.density(pts, cond_feat), self.density_grid, self._grid_gen,
                bound=cfg.bound, decay=self.task_cfg.grid_decay,
                density_thresh=cfg.density_thresh)
        self.mean_density = float(mean_d)
        self.grid_telemetry = {
            "density_grid/mean_density": self.mean_density,
            "density_grid/occupancy_rate": float(self.occupancy.float().mean()),
        }

    # ------------------------------------------------------------------
    def validate(self, state: TrainState, max_frames: int = 2, save_dir: str = "",
                 ray_chunk: int = 65536) -> Dict[str, float]:
        """Full-image renders of val frames (the f32 model field, no
        perturbation) -> PSNR. Frames render in chunks of `ray_chunk` rays
        to bound memory; the result does not depend on the chunking.
        `save_dir` is accepted for the JAX signature; writing the renders
        needs an image encoder and is not ported."""
        ds_val = self.val_dataset if self.val_dataset is not None else self.dataset
        model, cfg = state.model, self.cfg
        v_opts = dataclasses.replace(self.opts, perturb=False)
        dev = self.device
        psnrs = []
        with torch.no_grad():
            for i in range(min(max_frames, len(ds_val))):
                pose = torch.from_numpy(ds_val.frame_pose(i)[None]).to(dev)
                rays_o, rays_d = pixel_rays(pose, ds_val.intrinsics, ds_val.H, ds_val.W)
                cond = torch.from_numpy(ds_val.frame_cond_window(i)).to(dev)
                eye = torch.from_numpy(ds_val.eye_area_percents[i: i + 1]).to(dev)
                gid = max(min(int(ds_val.frame_ids[i]), cfg.individual_embedding_num - 1), 0)
                cond_feat = model.cal_cond_feat(cond, eye)
                ind = model.get_individual_code(gid)
                bg = ds_val.frame_bg_torso(i)
                bg = torch.from_numpy(np.asarray(ds_val.bg_img if bg is None else bg,
                                                 np.float32).reshape(-1, 3)).to(dev)
                parts = []
                for s in range(0, rays_o.shape[1], ray_chunk):
                    out = render_rays(lambda x, d: model.field(x, d, cond_feat, ind),
                                      rays_o[0, s:s + ray_chunk], rays_d[0, s:s + ray_chunk],
                                      self.occupancy, bound=cfg.bound, min_near=cfg.min_near,
                                      bg_color=bg[s:s + ray_chunk], opts=v_opts)
                    parts.append(out.rgb_map)
                rgb = torch.cat(parts)
                gt = ds_val.load_image(i, "gt")
                if gt is None:
                    continue
                mse = float(torch.mean((rgb - torch.from_numpy(gt.reshape(-1, 3)).to(dev)) ** 2))
                psnrs.append(-10.0 * np.log10(max(mse, 1e-10)))
        return {"val_psnr": float(np.mean(psnrs))} if psnrs else {}

    def extra_state_dict(self):
        return {"density_grid": self.density_grid, "occupancy": self.occupancy}

    def load_extra_state(self, d):
        if "density_grid" in d:
            self.density_grid = torch.as_tensor(d["density_grid"], device=self.device).float()
        if "occupancy" in d:
            self.occupancy = torch.as_tensor(d["occupancy"], device=self.device).bool()
