"""Head-NeRF training step (port of
`genefaceplusplus_tpu/training/radnerf_task.py`).

Losses: mse + weights entropy + masked ambient with its 250k ramp and the
adaptive lambda_ambient controller; grouped Adam; perturbed marching. The
field is the f32 model field, or with `use_fused_field` the fused field
(`fused_field_train`: the CUDA forward and backward kernels on the card),
whose gradients reach the parameters through the differentiable weight
folding.

PyTorch idiom: the `TrainState` holds the module, its optimizer and a
`torch.Generator` for the ray noise, and `train_step` updates them in
place (the JAX step returns a new state; this one returns the same
object). `training/trainer.py` writes it as JAX's `TrainState` (fields
params, opt_state, global_step, lambda_ambient, rng).
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, Optional, Tuple

import torch

from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF
from genefaceplusplus_tpu_torch.models.renderer import RenderOptions, render_rays
from genefaceplusplus_tpu_torch.ops.fused_field import fused_field_train, weights_from_params
from genefaceplusplus_tpu_torch.training import losses as L
from genefaceplusplus_tpu_torch.training.schedulers import RADNeRFAdam, grad_norms_by_group


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module  # RADNeRF; for the SR task a ModuleDict {'head', 'sr'}
    opt: RADNeRFAdam
    global_step: int
    lambda_ambient: torch.Tensor  # f32 scalar (adaptive controller)
    generator: torch.Generator  # ray noise
    params_key: ClassVar[str] = "params"  # the JAX state's field of the variables


@dataclasses.dataclass(frozen=True)
class TaskHParams:
    lambda_weights_entropy: float = 1e-4
    lambda_ambient: float = 1.0  # initial value of the adaptive lambda
    target_ambient_loss: float = 1e-8
    lr_lambda_ambient: float = 0.01
    ambient_loss_mode: str = "mae"
    ambient_ramp_total: int = 250_000


def create_train_state(model: RADNeRF, tx, generator: torch.Generator,
                       hp: TaskHParams = TaskHParams()) -> TrainState:
    """`tx` is `make_radnerf_optimizer(...)`; `model` is already on its device."""
    dev = next(model.parameters()).device
    return TrainState(model=model, opt=tx(model), global_step=0,
                      lambda_ambient=torch.tensor(hp.lambda_ambient, dtype=torch.float32, device=dev),
                      generator=generator)


def head_loss_fn(model: RADNeRF, batch: Dict[str, torch.Tensor], occupancy: torch.Tensor,
                 opts: RenderOptions, hp: TaskHParams, global_step: int,
                 lambda_ambient: torch.Tensor, noise: Optional[torch.Tensor],
                 use_fused_field: bool = False, fused_tile: int = 1024,
                 remat_field: bool = False):
    """Total loss and metrics of one ray batch. `fused_tile` and
    `remat_field` are accepted for the JAX signature and do nothing here:
    the CUDA kernels fix their own tile, and the fused backward already
    recomputes the field per tile (eager autograd keeps no field
    activations for it)."""
    cfg = model.cfg
    cond_feat = model.cal_cond_feat(batch["cond"], batch.get("eye_area_percent"))
    ind_code = model.get_individual_code(batch["idx"])

    if use_fused_field:
        weights = weights_from_params(model, bound=cfg.bound, differentiable=True)

        def field_fn(xyz, dirs):
            return fused_field_train(xyz, dirs, cond_feat, ind_code, weights,
                                     amb_dim=cfg.ambient_coord_dim)
    else:
        def field_fn(xyz, dirs):
            return model.field(xyz, dirs, cond_feat, ind_code)

    out = render_rays(field_fn, batch["rays_o"], batch["rays_d"], occupancy, bound=cfg.bound,
                      min_near=cfg.min_near, bg_color=batch["bg_color"], opts=opts, noise=noise)

    mse = L.mse_loss(out.rgb_map, batch["gt_rgb"])
    went = L.weights_entropy_loss(out.weights_sum)
    amb = L.ambient_loss(out.ambient_sum, batch["face_mask"], hp.ambient_loss_mode)
    amb = torch.where(torch.isnan(amb), torch.zeros_like(amb), amb)
    ramp = L.ambient_ramp(global_step, hp.ambient_ramp_total)
    total = mse + hp.lambda_weights_entropy * went + ramp * lambda_ambient * amb
    metrics = {
        "mse_loss": mse,
        "weights_entropy_loss": went,
        "ambient_loss": amb,
        "head_psnr": L.mse2psnr(mse),
        "total_loss": total,
    }
    return total, metrics


def make_train_step(opts: RenderOptions, hp: TaskHParams = TaskHParams(),
                    use_fused_field: bool = False, fused_tile: int = 1024,
                    remat_field: bool = False):
    """Returns train_step(state, batch, occupancy, noise=None) ->
    (state, metrics). `noise` [R] in [0, 1) overrides the draw from
    `state.generator` (tests feed both packages the same noise)."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], occupancy: torch.Tensor,
                   noise: Optional[torch.Tensor] = None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        rays_o = batch["rays_o"]
        if noise is None and opts.perturb:
            noise = torch.rand(rays_o.shape[:1], generator=state.generator, device=rays_o.device)
        state.opt.zero_grad()
        total, metrics = head_loss_fn(state.model, batch, occupancy, opts, hp, state.global_step,
                                      state.lambda_ambient, noise, use_fused_field, fused_tile,
                                      remat_field)
        total.backward()
        named = [(n, p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in state.opt.named]
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(grad_norms_by_group(named))
        state.opt.step()
        with torch.no_grad():
            state.lambda_ambient = L.adaptive_lambda_ambient(
                state.lambda_ambient, metrics["ambient_loss"], hp.target_ambient_loss,
                hp.lr_lambda_ambient)
        metrics["lambda_ambient"] = state.lambda_ambient
        state.global_step += 1
        return state, metrics

    return train_step
