"""Audio-to-motion (flow-VAE) training task (port of
`genefaceplusplus_tpu/training/tasks/a2m_task.py`).

`PitchContourVAEModel` (or `VAEModel` without `use_pitch`) learns
hubert [2T, 1024] + f0 [2T] -> the target track [T, C] (`exp`, 64-d, or
`idexp_lm3d`, 204-d) on windows of `seq_len` motion frames. Loss: masked
MSE + lambda_kl x min(step / kl_anneal_steps, 1) x the flow-prior KL, with
`step` the global step before the update. The optimizer is `optax.adam(lr,
b1=0.9, b2=0.98)` over the params (`OptaxAdam`); BatchNorm's running
statistics take flax's update in each step's forward.

The tracks live on the device; a step draws B window starts on the host
(JAX's numpy draws: `randint(0, max(1, T_train - seq_len), B)`) and gathers
its windows there. The last 1/11 of the timeline is held out (`T_val =
max(seq_len, T // 11)` when T > 2 seq_len): training windows never start in
it, `validate` slides over it: the posterior reconstruction (train-mode
BatchNorm, its updates thrown away), the temperature-0 prior sample, and
LMD when the target is `idexp_lm3d`. The posterior noise of a step comes
from the state's generator, or from `noise=`; validation's from a generator
seeded 0 (JAX: `PRNGKey(0)`).

The state is written as JAX's `A2MTrainState` (variables = params +
batch_stats, opt_state, global_step, rng).
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, Optional

import numpy as np
import torch

from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset
from genefaceplusplus_tpu_torch.models.audio2motion.vae_model import PitchContourVAEModel, VAEModel
from genefaceplusplus_tpu_torch.training.schedulers import OptaxAdam
from genefaceplusplus_tpu_torch.training.trainer import numpy_rng_state, set_numpy_rng_state
from genefaceplusplus_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class A2MTrainState:
    model: torch.nn.Module  # PitchContourVAEModel or VAEModel
    opt: OptaxAdam
    global_step: int
    generator: torch.Generator  # the posterior noise
    params_key: ClassVar[str] = "variables"


@dataclasses.dataclass
class A2MTaskConfig:
    lr: float = 5e-4
    lambda_kl: float = 0.02
    kl_anneal_steps: int = 20_000
    seq_len: int = 64  # motion frames per training clip (25 Hz)
    batch_size: int = 8
    use_pitch: bool = True
    audio_in_dim: int = 1024
    in_out_dim: int = 64
    hidden_channels: int = 256
    enc_n_layers: int = 8
    dec_n_layers: int = 4
    flow_hidden: int = 64
    flow_n_blocks: int = 4
    target: str = "exp"  # "exp" (64-d) or "idexp_lm3d" (204-d, with val_lmd)


class A2MTask:
    def __init__(self, dataset: RADNeRFDataset, cfg: A2MTaskConfig = A2MTaskConfig(), seed: int = 9999,
                 device=None):
        self.dataset = dataset
        self.cfg = cfg
        self.device = resolve_device(device)  # the card unless named
        self.np_rng = np.random.RandomState(seed)
        self.seed = seed
        ds = dataset.ds
        hubert = np.asarray(ds["hubert"], np.float32)
        f0 = np.asarray(ds["f0"], np.float32)
        target = np.asarray(ds[cfg.target], np.float32)
        if target.shape[-1] != cfg.in_out_dim:
            raise ValueError(f"target {cfg.target} is {target.shape[-1]}-d but in_out_dim={cfg.in_out_dim}")
        self.T = min(len(hubert) // 2, len(target))
        L = cfg.seq_len
        self.T_val = max(L, self.T // 11) if self.T > 2 * L else 0
        self.T_train = self.T - self.T_val
        self.tracks = {k: torch.from_numpy(v).to(self.device)
                       for k, v in (("hubert", hubert), ("f0", f0), ("target", target))}

    def _model(self) -> torch.nn.Module:
        c = self.cfg
        kw = dict(in_out_dim=c.in_out_dim, audio_in_dim=c.audio_in_dim, hidden_channels=c.hidden_channels,
                  enc_n_layers=c.enc_n_layers, dec_n_layers=c.dec_n_layers, flow_hidden=c.flow_hidden,
                  flow_n_blocks=c.flow_n_blocks, generator=torch.Generator().manual_seed(self.seed))
        return PitchContourVAEModel(**kw) if c.use_pitch else VAEModel(**kw)

    def create_state(self) -> A2MTrainState:
        model = self._model().to(self.device)
        return A2MTrainState(model=model, opt=OptaxAdam(model, self.cfg.lr, b1=0.9, b2=0.98), global_step=0,
                             generator=torch.Generator(device=self.device).manual_seed(self.seed + 2))

    def sample_train_batch(self, global_step=None) -> Dict[str, torch.Tensor]:
        c = self.cfg
        starts = self.np_rng.randint(0, max(1, self.T_train - c.seq_len), size=c.batch_size)
        return {"starts": torch.from_numpy(starts.astype(np.int64)).to(self.device)}

    def gather(self, starts: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The B windows at `starts` from the device-resident tracks; each
        start is clamped so its window fits, as `lax.dynamic_slice` does."""
        L, tr = self.cfg.seq_len, self.tracks
        offsets = torch.arange(2 * L, device=starts.device)

        def window(track, start, n):
            return track[torch.clamp(start, 0, track.shape[0] - n)[:, None] + offsets[:n]]

        return {"audio": window(tr["hubert"], 2 * starts, 2 * L), "f0": window(tr["f0"], 2 * starts, 2 * L),
                "y": window(tr["target"], starts, L), "y_mask": torch.ones((starts.shape[0], L), device=starts.device)}

    def loss(self, model, batch, step: int, noise=None, generator=None):
        c = self.cfg
        recon, aux = model(batch, train=True, noise=noise, generator=generator)
        mask = batch["y_mask"][..., None]
        mse = (((recon - batch["y"]) ** 2) * mask).sum() / mask.sum() / recon.shape[-1]
        anneal = min(step / c.kl_anneal_steps, 1.0)
        total = mse + c.lambda_kl * anneal * aux["loss_kl"]
        return total, {"mse_loss": mse, "kl_loss": aux["loss_kl"], "total_loss": total}

    def train_step(self, state: A2MTrainState, batch, noise: Optional[torch.Tensor] = None):
        """One update (in place); `batch` is {'starts'} or a gathered window
        batch. `noise` [B, T_sqz, 16] replaces the posterior draw."""
        if "starts" in batch:
            batch = self.gather(batch["starts"])
        state.opt.zero_grad()
        total, metrics = self.loss(state.model, batch, state.global_step, noise, state.generator)
        total.backward()
        state.opt.step()
        state.global_step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    def update_extra_state(self, state):
        pass

    @torch.no_grad()
    def validate(self, state: A2MTrainState, max_frames: int = 0, save_dir: str = "") -> Dict[str, float]:
        """Held-out metrics on the last 1/11 (module docstring): val_recon_mse,
        val_gen_l1, val_kl, and val_lmd for the idexp_lm3d target (its
        landmarks are x10, so distances divide by 10)."""
        if self.T_val == 0:
            return {}
        c, model, L = self.cfg, state.model, self.cfg.seq_len
        gen = torch.Generator(device=self.device).manual_seed(0)
        starts = list(range(self.T_train, self.T - L + 1, L)) or [self.T - L]
        mses, gen_l1s, lmds, kls = [], [], [], []
        for s in starts:
            batch = self.gather(torch.tensor([s], device=self.device))
            saved = {k: b.clone() for k, b in model.named_buffers()}
            try:
                recon, aux = model(batch, train=True, generator=gen)
            finally:  # the reconstruction's BatchNorm updates are thrown away
                for k, b in model.named_buffers():
                    b.copy_(saved[k])
            genr, _ = model(batch, train=False, temperature=0.0)
            gt = batch["y"]
            mses.append(float(torch.mean((recon - gt) ** 2)))
            gen_l1s.append(float(torch.mean(torch.abs(genr - gt))))
            kls.append(float(aux["loss_kl"]))
            if c.target == "idexp_lm3d":
                d = (genr.reshape(1, L, 68, 3) - gt.reshape(1, L, 68, 3)) / 10.0
                lmds.append(float(torch.mean(torch.linalg.vector_norm(d, dim=-1))))
        out = {"val_recon_mse": float(np.mean(mses)), "val_gen_l1": float(np.mean(gen_l1s)),
               "val_kl": float(np.mean(kls))}
        if lmds:
            out["val_lmd"] = float(np.mean(lmds))
        return out

    def extra_state_dict(self):
        return {}

    def load_extra_state(self, d):
        pass

    def host_state(self) -> Dict:
        return {"np_rng": numpy_rng_state(self.np_rng)}

    def load_host_state(self, d: Dict):
        set_numpy_rng_state(self.np_rng, d["np_rng"])
