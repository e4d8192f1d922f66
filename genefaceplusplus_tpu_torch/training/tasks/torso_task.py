"""Torso training task: a frozen head and a trained torso field (port of
`genefaceplusplus_tpu/training/tasks/torso_task.py`).

The head, its occupancy and its density grid come from the head stage's
work dir (a head or head + SR dir, JAX's or the port's: the 'head' subtree
where there is one). Each step renders a full frame of the head (without
autograd: JAX's stop_gradient) over the torso field, losses mse + the
torso alpha's entropy + `lambda_torso_deform` x the mean |deformation| on
every 16th pixel. The torso's 2D alpha grid is refreshed every
`update_extra_interval` steps; validation renders the composite with it.
The state is written as JAX's `TorsoTrainState` (torso_params, opt_state,
global_step, rng).
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, Optional

import numpy as np
import torch

from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset
from genefaceplusplus_tpu_torch.models.full_renderer import render_full_frame
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF, RADNeRFConfig
from genefaceplusplus_tpu_torch.models.radnerf_torso import TorsoConfig, TorsoField
from genefaceplusplus_tpu_torch.models.renderer import RenderOptions
from genefaceplusplus_tpu_torch.training import frame_store
from genefaceplusplus_tpu_torch.training import losses as L
from genefaceplusplus_tpu_torch.training.grid_updater import update_torso_grid
from genefaceplusplus_tpu_torch.training.schedulers import RADNeRFAdam, grad_norms_by_group, make_radnerf_optimizer
from genefaceplusplus_tpu_torch.training.trainer import (
    generator_state, numpy_rng_state, set_generator_state, set_numpy_rng_state)
from genefaceplusplus_tpu_torch.utils.ckpt import get_last_checkpoint, restore_into
from genefaceplusplus_tpu_torch.utils.convert_jax import flax_leaves, unwrap_train_state
from genefaceplusplus_tpu_torch.utils.device import resolve_device
from genefaceplusplus_tpu_torch.utils.rays import get_bg_coords, pixel_rays


@dataclasses.dataclass
class TorsoTrainState:
    model: TorsoField
    opt: RADNeRFAdam
    global_step: int
    generator: torch.Generator  # unused by the step (no perturbation), kept as JAX's rng
    params_key: ClassVar[str] = "torso_params"


def load_head(head_cfg: RADNeRFConfig, head_dir: str, device) -> tuple:
    """(frozen RADNeRF, occupancy or None, density grid or None) from a head
    stage's newest checkpoint: its 'head' subtree where the params are
    {'head', 'sr'}. Without a dir or checkpoint the head keeps its seeded
    initialisation (JAX keeps its template); a checkpoint that restores no
    tensor raises."""
    head = RADNeRF(head_cfg, generator=torch.Generator().manual_seed(0))
    occ = grid = None
    ckpt = get_last_checkpoint(head_dir, map_location="cpu")[0] if head_dir else None
    if ckpt is not None:
        extra = ckpt.get("extra_state", {})
        if "occupancy" in extra:
            occ = torch.from_numpy(np.array(extra["occupancy"], bool))
        if "density_grid" in extra:
            grid = torch.from_numpy(np.array(extra["density_grid"], np.float32))
        state = ckpt.get("state_dict", {})
        if isinstance(state, dict) and "model" in state:  # the port's earlier torch.save format
            loaded = {k[5:] if k.startswith("head.") else k: v for k, v in state["model"].items()}
        else:
            loaded = {k: arr for k, (_, arr) in flax_leaves(unwrap_train_state(ckpt, sub="head")).items()}
        sd, restored = restore_into(head.state_dict(), loaded)
        if not restored:
            raise ValueError(f"{head_dir}: the checkpoint restores no tensor of the head")
        head.load_state_dict(sd)
    head.requires_grad_(False)
    return head.to(device).eval(), occ, grid


class TorsoNeRFTask:
    def __init__(self, dataset: RADNeRFDataset, head_cfg: RADNeRFConfig, cfg, seed: int = 9999,
                 device=None):
        self.dataset = dataset
        self.head_cfg = head_cfg
        self.cfg = cfg
        self.device = resolve_device(device)  # the card unless named
        self.torso_cfg = TorsoConfig.from_hparams(cfg)
        self.tx = make_radnerf_optimizer(cfg.get("lr", 5e-4), cfg.get("warmup_updates", 0))
        self.opts = RenderOptions(max_steps=cfg.get("max_steps", 16), num_samples=16, perturb=False)
        self.np_rng = np.random.RandomState(seed)
        self.seed = seed
        self.lambda_we = cfg.get("lambda_weights_entropy", 1e-4)
        self.lambda_deform = cfg.get("lambda_torso_deform", 0.0)
        self.val_dataset: Optional[RADNeRFDataset] = None

        G = head_cfg.grid_size
        self.head_model, occ, grid = load_head(head_cfg, cfg.get("head_model_dir", ""), self.device)
        self.occupancy = (occ if occ is not None else torch.ones((G, G, G), dtype=torch.bool)).to(self.device)
        self.density_grid = (grid if grid is not None else torch.zeros((G, G, G))).to(self.device)
        self.torso_grid = torch.zeros((G, G), device=self.device)
        self.mean_density_torso = 0.0
        self._grid_gen = torch.Generator(device=self.device).manual_seed(seed + 2)
        self._dev_frames = None

    def create_state(self) -> TorsoTrainState:
        model = TorsoField(self.torso_cfg, generator=torch.Generator().manual_seed(self.seed)).to(self.device)
        return TorsoTrainState(model=model, opt=self.tx(model), global_step=0,
                               generator=torch.Generator(device=self.device).manual_seed(self.seed))

    # ------------------------------------------------------------------
    def _frame_lm68(self, idx: int, ds: Optional[RADNeRFDataset] = None) -> np.ndarray:
        """[1, 68, 2] 2D landmarks of the torso condition (the canonical xy
        of idexp_lm3d when the record stores none)."""
        ds = self.dataset if ds is None else ds
        lms = ds.samples[idx].get("lms")
        if lms is not None:
            return np.asarray(lms, np.float32)[None]
        return np.asarray(ds.ds["idexp_lm3d"][idx], np.float32).reshape(68, 3)[:, :2][None]

    def _device_frames(self) -> Dict[str, torch.Tensor]:
        if self._dev_frames is not None:
            return self._dev_frames
        ds = self.dataset
        self._dev_frames = {
            **frame_store.base_device_frames(ds, self.device),
            "lm68": torch.from_numpy(np.stack([self._frame_lm68(i) for i in range(len(ds))])).to(self.device),
            "bg_color": torch.from_numpy(np.asarray(ds.bg_img, np.float32).reshape(-1, 3)).to(self.device),
            "bg_coords": get_bg_coords(ds.H, ds.W, self.device)[0],
        }
        return self._dev_frames

    def _gather(self, frames, idx: int) -> Dict[str, torch.Tensor]:
        ds = self.dataset
        intr = tuple(float(x) for x in np.asarray(ds.intrinsics).reshape(-1))
        t_idx = torch.tensor(idx, dtype=torch.int64, device=self.device)
        rays_o, rays_d = frame_store.device_frame_rays(frames, t_idx, intr, ds.H, ds.W)
        return {
            "rays_o": rays_o,
            "rays_d": rays_d,
            "cond": frame_store.device_cond_window(frames, t_idx, ds.smo_win_size, len(ds.conds_all)),
            "gt_rgb": frames["gt"][idx].float().reshape(-1, 3) / 255.0,
            "bg_color": frames["bg_color"],
            "bg_coords": frames["bg_coords"],
            "lm68": frames["lm68"][idx],
            "idx": idx,
            "eye_area_percent": frames["eye"][idx][None],
        }

    def sample_train_batch(self, global_step=None) -> Dict:
        self._device_frames()
        return {"frame_idx": int(self.np_rng.randint(len(self.dataset)))}

    def train_step(self, state: TorsoTrainState, batch):
        b = self._gather(self._device_frames(), int(batch["frame_idx"]))
        model = state.model
        state.opt.zero_grad()
        out = render_full_frame(self.head_model, b["rays_o"], b["rays_d"], b["cond"], self.occupancy,
                                bg_color=b["bg_color"], opts=self.opts,
                                image_hw=(self.dataset.H, self.dataset.W),
                                eye_area_percent=b["eye_area_percent"], index=b["idx"],
                                torso_model=model, bg_coords=b["bg_coords"], lm68=b["lm68"],
                                stop_head_gradient=True)
        mse = L.mse_loss(out.rgb_map, b["gt_rgb"])
        alpha = torch.clamp(out.torso_alpha[:, 0], 1e-5, 1 - 1e-5)
        went = torch.mean(-alpha * torch.log2(alpha) - (1 - alpha) * torch.log2(1 - alpha))
        total = mse + self.lambda_we * went
        metrics = {"mse_loss": mse, "torso_entropy": went, "head_psnr": L.mse2psnr(mse)}
        if self.lambda_deform > 0:  # L1 deformation regulariser on a pixel subsample
            t_out = model(b["bg_coords"][::16], b["lm68"], model.get_individual_code(0), None, None)
            deform_reg = torch.abs(t_out.deform).mean()
            total = total + self.lambda_deform * deform_reg
            metrics["deform_reg"] = deform_reg
        metrics["total_loss"] = total
        total.backward()
        named = [(n, p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in state.opt.named]
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(grad_norms_by_group(named))
        state.opt.step()
        state.global_step += 1
        return state, metrics

    def update_extra_state(self, state: TorsoTrainState):
        """The torso's 2D alpha-grid refresh at a random frame's landmarks."""
        idx = int(self.np_rng.randint(len(self.dataset)))
        lm = torch.from_numpy(self._frame_lm68(idx)).to(self.device)
        model = state.model
        ind = model.get_individual_code(0)
        self.torso_grid, mean_t = update_torso_grid(lambda pts: model(pts, lm, ind, None, None).alpha[:, 0],
                                                    self.torso_grid, self._grid_gen)
        self.mean_density_torso = float(mean_t)

    def validate(self, state: TorsoTrainState, max_frames: int = 2, save_dir: str = "") -> Dict[str, float]:
        """Full-frame head + torso renders, the torso masked by its 2D grid
        at min(density_thresh_torso, the grid's mean) -> PSNR."""
        ds = self.val_dataset if self.val_dataset is not None else self.dataset
        dt = self.torso_cfg.density_thresh_torso
        thr = min(dt, self.mean_density_torso) if self.mean_density_torso > 0 else dt
        dev = self.device
        bg = torch.from_numpy(np.asarray(ds.bg_img, np.float32).reshape(-1, 3)).to(dev)
        coords = get_bg_coords(ds.H, ds.W, dev)[0]
        psnrs = []
        with torch.no_grad():
            for i in range(min(max_frames, len(ds))):
                pose = torch.from_numpy(ds.frame_pose(i)[None]).to(dev)
                rays_o, rays_d = pixel_rays(pose, ds.intrinsics, ds.H, ds.W)
                gid = min(int(ds.frame_ids[i]), self.torso_cfg.torso_individual_embedding_num - 1)
                out = render_full_frame(
                    self.head_model, rays_o[0], rays_d[0], torch.from_numpy(ds.frame_cond_window(i)).to(dev),
                    self.occupancy, bg_color=bg, opts=self.opts, image_hw=(ds.H, ds.W),
                    eye_area_percent=torch.from_numpy(ds.eye_area_percents[i:i + 1]).to(dev),
                    index=max(gid, 0), torso_model=state.model, bg_coords=coords,
                    lm68=torch.from_numpy(self._frame_lm68(i, ds)).to(dev), occupancy_2d=self.torso_grid,
                    density_thresh_torso=thr)
                gt = ds.load_image(i, "gt")
                if gt is None:
                    continue
                mse = float(torch.mean((out.rgb_map - torch.from_numpy(gt.reshape(-1, 3)).to(dev)) ** 2))
                psnrs.append(-10.0 * np.log10(max(mse, 1e-10)))
        return {"val_psnr": float(np.mean(psnrs))} if psnrs else {}

    def extra_state_dict(self):
        return {"torso_grid": self.torso_grid, "occupancy": self.occupancy, "density_grid": self.density_grid}

    def load_extra_state(self, d):
        if "torso_grid" in d:
            self.torso_grid = torch.as_tensor(np.array(d["torso_grid"]), device=self.device).float()
        if "occupancy" in d:
            self.occupancy = torch.as_tensor(np.array(d["occupancy"]), device=self.device).bool()
        if "density_grid" in d:
            self.density_grid = torch.as_tensor(np.array(d["density_grid"]), device=self.device).float()

    def host_state(self) -> Dict:
        return {"np_rng": numpy_rng_state(self.np_rng), "grid": generator_state(self._grid_gen),
                "mean_density_torso": np.asarray(self.mean_density_torso, np.float64)}

    def load_host_state(self, d: Dict):
        set_numpy_rng_state(self.np_rng, d["np_rng"])
        set_generator_state(self._grid_gen, d["grid"])
        self.mean_density_torso = float(d["mean_density_torso"])
