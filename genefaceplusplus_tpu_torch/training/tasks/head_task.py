"""Head-NeRF training task: dataset sampling, the train step, grid refresh
and validation (port of `genefaceplusplus_tpu/training/tasks/head_task.py`).

Random-frame random-ray batches (same numpy draws as the JAX task, so
frame ids and ray indices match it draw for draw), gathered on the device
from a resident frame store; losses mse + weights entropy + masked ambient
with the adaptive lambda; density-grid refresh every update_extra_interval
steps with a random condition; full-image validation with PSNR, the
renders saved as PNG. From `finetune_lips_start_iter` on (with
`finetune_lips`), every other step is a lip step: the rays of a static
window on the frame's lip rect, mse + the perceptual loss on the window,
with the float32 field; the grid refresh pauses.

Not ported (it raises NotImplementedError when it would run): train-side
live-sample compaction (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from genefaceplusplus_tpu_torch.data import image_io
from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset, get_boundary_mask
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF, RADNeRFConfig
from genefaceplusplus_tpu_torch.models.renderer import RenderOptions, render_rays
from genefaceplusplus_tpu_torch.training import frame_store
from genefaceplusplus_tpu_torch.training import losses as L
from genefaceplusplus_tpu_torch.training.grid_updater import mark_untrained_grid, update_density_grid
from genefaceplusplus_tpu_torch.training.radnerf_task import (
    TaskHParams,
    TrainState,
    create_train_state,
    make_train_step,
)
from genefaceplusplus_tpu_torch.training.perceptual import perceptual_from_task_config
from genefaceplusplus_tpu_torch.training.schedulers import make_radnerf_optimizer
from genefaceplusplus_tpu_torch.training.trainer import (
    generator_state, numpy_rng_state, set_generator_state, set_numpy_rng_state)
from genefaceplusplus_tpu_torch.utils.device import resolve_device
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
        self.device = resolve_device(device)  # the card unless named
        self.tx = make_radnerf_optimizer(task_cfg.lr, task_cfg.warmup_updates)
        self.opts = RenderOptions(max_steps=task_cfg.max_steps,
                                  num_samples=task_cfg.num_samples, perturb=True)
        self._train_step = make_train_step(self.opts, hp, use_fused_field=task_cfg.use_fused_field,
                                           fused_tile=task_cfg.fused_tile)
        self._host_step: Optional[int] = None
        self.np_rng = np.random.RandomState(seed)
        self.seed = seed
        self._finetune_lip_flag = False
        self.perceptual = None  # built with the first lip step

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

    def _head(self, state: TrainState) -> RADNeRF:
        return state.model

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

    def _lip_window_indices(self, idx: int) -> np.ndarray:
        """Pixel indices of a static window centred on the frame's lip rect."""
        ds = self.dataset
        win = min(self.task_cfg.lip_window, ds.H, ds.W)
        rect = ds.samples[idx].get("lip_rect", [0, ds.H, 0, ds.W])
        sc = ds.H / int(ds.ds["H"])
        cy = int((rect[0] + rect[1]) / 2 * sc)
        cx = int((rect[2] + rect[3]) / 2 * sc)
        y0 = int(np.clip(cy - win // 2, 0, ds.H - win))
        x0 = int(np.clip(cx - win // 2, 0, ds.W - win))
        rows = np.arange(y0, y0 + win)
        cols = np.arange(x0, x0 + win)
        return (rows[:, None] * ds.W + cols[None, :]).reshape(-1)

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
        """A frame index and ray indices (past `finetune_lips_start_iter`,
        every other batch the lip window's), drawn with the JAX task's numpy
        calls in its order; the rest is gathered on the device."""
        if global_step is not None:
            self._host_step = int(global_step)
        gs = self._host_step or 0
        self._device_frames()
        ds = self.dataset
        idx = int(self.np_rng.randint(len(ds)))
        lip_active = self._lip_active(gs)
        if lip_active:  # alternate lip-window and full-image iterations
            self._finetune_lip_flag = not self._finetune_lip_flag
        is_lip = lip_active and self._finetune_lip_flag
        if is_lip:
            inds = self._lip_window_indices(idx)
        else:
            inds = self.np_rng.randint(0, ds.H * ds.W, size=self.task_cfg.n_rays)
        return {"frame_idx": idx, "inds": inds.astype(np.int32), "_is_lip": is_lip}

    def train_step(self, state: TrainState, batch, noise: Optional[torch.Tensor] = None):
        if self._host_step is None:
            self._host_step = int(state.global_step)
        frames = self._device_frames()
        idx = torch.tensor(batch["frame_idx"], dtype=torch.int64, device=self.device)
        inds = torch.as_tensor(batch["inds"], device=self.device).long()
        gathered = self._make_ray_gather()(frames, idx, inds)
        if batch.get("_is_lip", False):
            state, metrics = self._lip_step(state, gathered, noise)
        else:
            state, metrics = self._train_step(state, gathered, self.occupancy, noise)
        metrics.update(self.grid_telemetry)
        self._host_step += 1
        return state, metrics

    def _lip_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                  noise: Optional[torch.Tensor] = None):
        """One lip-window step: mse + lambda_lpips * perceptual on the [win,
        win] crop, through the float32 field; lambda_ambient is kept.
        `noise` overrides the draw from `state.generator`."""
        if self.perceptual is None:
            self.perceptual = perceptual_from_task_config(self.task_cfg, self.device)
        model, cfg = state.model, self.cfg
        win = min(self.task_cfg.lip_window, self.dataset.H, self.dataset.W)
        if noise is None and self.opts.perturb:
            noise = torch.rand(batch["rays_o"].shape[:1], generator=state.generator,
                               device=self.device)
        state.opt.zero_grad()
        cond_feat = model.cal_cond_feat(batch["cond"], batch.get("eye_area_percent"))
        ind = model.get_individual_code(batch["idx"])
        out = render_rays(lambda x, d: model.field(x, d, cond_feat, ind), batch["rays_o"],
                          batch["rays_d"], self.occupancy, bound=cfg.bound, min_near=cfg.min_near,
                          bg_color=batch["bg_color"], opts=self.opts, noise=noise)
        mse = L.mse_loss(out.rgb_map, batch["gt_rgb"])
        lp = self.perceptual(out.rgb_map.reshape(1, win, win, 3), batch["gt_rgb"].reshape(1, win, win, 3))
        total = mse + self.task_cfg.lambda_lpips * lp
        total.backward()
        state.opt.step()
        state.global_step += 1
        metrics = {"mse_loss": mse, "lpips_loss": lp, "head_psnr": L.mse2psnr(mse), "total_loss": total}
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["lambda_ambient"] = state.lambda_ambient
        return state, metrics

    def update_extra_state(self, state: TrainState):
        """Density-grid EMA refresh with a random condition."""
        gs = self._host_step if self._host_step is not None else int(state.global_step)
        if self._lip_active(gs):
            return
        ds = self.dataset
        idx = int(self.np_rng.randint(len(ds)))
        cond = torch.from_numpy(ds.frame_cond_window(idx)).to(self.device)
        model, cfg = self._head(state), self.cfg
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
        to bound memory; the result does not depend on the chunking. With
        `save_dir` each render is written to
        <save_dir>/validation_results/val_<step>_<i>.png."""
        ds_val = self.val_dataset if self.val_dataset is not None else self.dataset
        model, cfg = self._head(state), self.cfg
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
                if save_dir:
                    vdir = os.path.join(save_dir, "validation_results")
                    os.makedirs(vdir, exist_ok=True)
                    image_io.write_png(os.path.join(vdir, f"val_{int(state.global_step)}_{i}.png"),
                                       image_io.to_u8(rgb.reshape(ds_val.H, ds_val.W, 3).cpu().numpy()))
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
            self.density_grid = torch.as_tensor(np.array(d["density_grid"]), device=self.device).float()
        if "occupancy" in d:
            self.occupancy = torch.as_tensor(np.array(d["occupancy"]), device=self.device).bool()

    def host_state(self) -> Dict:
        """The task's draws and host-side state, for an exact resume
        (`Trainer.save`)."""
        return {"np_rng": numpy_rng_state(self.np_rng), "grid": generator_state(self._grid_gen),
                "lip_flag": np.asarray(self._finetune_lip_flag),
                "mean_density": np.asarray(self.mean_density, np.float64),
                "grid_telemetry": {k: np.asarray(v, np.float64) for k, v in self.grid_telemetry.items()}}

    def load_host_state(self, d: Dict):
        set_numpy_rng_state(self.np_rng, d["np_rng"])
        set_generator_state(self._grid_gen, d["grid"])
        self._finetune_lip_flag = bool(d["lip_flag"])
        self.mean_density = float(d["mean_density"])
        self.grid_telemetry = {k: float(v) for k, v in d["grid_telemetry"].items()}
