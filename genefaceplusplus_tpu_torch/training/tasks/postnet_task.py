"""Postnet training task: pitch-conditioned landmark refinement (port of
`genefaceplusplus_tpu/training/tasks/postnet_task.py`).

`PitchContourCNNPostNet` learns to map raw a2m-predicted idexp_lm3d windows
[L, 204] onto the identity's ground truth, conditioned on the pitch (f0 /
400). Raw predictions come from `raw_bank` [K, T, out_dim] (pre-generated
full-track predictions), else from `predict_fn(hubert [2L, C], f0 [2L],
seed)`, else are synthesised as gt + smoothed noise (`_smooth_noise`, which
smooths along axis 1 of [L, 204], the coordinates, as the reference does).
The numpy draws are JAX's, in JAX's order, so one seed gives JAX's
batches. Loss: L1 + lambda_temporal x L1 of the first differences in time;
`optax.adam(lr)` over the whole `{'params': ...}` tree (`OptaxAdam` with
`collection=None`). The last 1/11 of the timeline is held out: `validate`
reports the refined and the raw L1 and LMD there, its synthesised raw from a
fixed `RandomState(1234)`.

The state is written as JAX's `PostnetTrainState` (params = the whole
variables dict, opt_state, global_step, rng).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, Dict, Optional

import numpy as np
import torch

from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset
from genefaceplusplus_tpu_torch.models.postnet.models import PitchContourCNNPostNet
from genefaceplusplus_tpu_torch.training.schedulers import OptaxAdam
from genefaceplusplus_tpu_torch.training.trainer import numpy_rng_state, set_numpy_rng_state
from genefaceplusplus_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class PostnetTrainState:
    model: PitchContourCNNPostNet
    opt: OptaxAdam
    global_step: int
    generator: torch.Generator  # unused by the step, kept as JAX's rng
    params_key: ClassVar[str] = "params"


@dataclasses.dataclass
class PostnetTaskConfig:
    lr: float = 1e-4
    out_dim: int = 204
    hidden: int = 256
    n_layers: int = 4
    seq_len: int = 64
    batch_size: int = 4
    lambda_temporal: float = 0.2
    noise_scale: float = 0.1  # the synthesised raw predictions' perturbation


class PostnetTask:
    def __init__(self, dataset: RADNeRFDataset, cfg: PostnetTaskConfig = PostnetTaskConfig(),
                 predict_fn: Optional[Callable] = None, seed: int = 9999,
                 raw_bank: Optional[np.ndarray] = None, device=None):
        self.dataset = dataset
        self.cfg = cfg
        self.device = resolve_device(device)  # the card unless named
        self.predict_fn = predict_fn
        self.raw_bank = None if raw_bank is None else np.asarray(raw_bank, np.float32)
        self.lm = np.asarray(dataset.ds["idexp_lm3d"], np.float32)  # [T, 204]
        self.f0 = np.asarray(dataset.ds["f0"], np.float32)  # [2T]
        T = len(self.lm)
        self.T = T
        self.T_val = max(cfg.seq_len, T // 11) if T > 2 * cfg.seq_len else 0
        self.T_train = T - self.T_val
        self.np_rng = np.random.RandomState(seed)
        self.seed = seed

    def create_state(self) -> PostnetTrainState:
        c = self.cfg
        model = PitchContourCNNPostNet(c.out_dim, c.hidden, c.n_layers,
                                       generator=torch.Generator().manual_seed(self.seed)).to(self.device)
        return PostnetTrainState(model=model, opt=OptaxAdam(model, c.lr, collection=None), global_step=0,
                                 generator=torch.Generator(device=self.device).manual_seed(self.seed))

    def _hubert(self, s: int, L: int) -> np.ndarray:
        return np.asarray(self.dataset.ds["hubert"], np.float32)[2 * s:2 * (s + L)]

    def _smooth_noise(self, shape) -> np.ndarray:
        """A moving average of 9 over normal noise, along axis 1 (JAX's)."""
        n = self.np_rng.randn(*shape).astype(np.float32)
        kern = np.ones(9, np.float32) / 9
        n = np.apply_along_axis(lambda s: np.convolve(s, kern, mode="same"), 1, n)
        return n * self.cfg.noise_scale

    def sample_train_batch(self, global_step=None) -> Dict[str, torch.Tensor]:
        c, lm, f0 = self.cfg, self.lm, self.f0
        T = self.T_train if self.T_val else len(lm)
        L = min(c.seq_len, T)
        gts, raws, pitches = [], [], []
        for _ in range(c.batch_size):
            s = int(self.np_rng.randint(0, max(1, T - L + 1)))
            gt = lm[s:s + L]
            if self.raw_bank is not None:
                raw = self.raw_bank[self.np_rng.randint(len(self.raw_bank)), s:s + L]
            elif self.predict_fn is not None:
                raw = np.asarray(self.predict_fn(self._hubert(s, L), f0[2 * s:2 * (s + L)],
                                                 self.np_rng.randint(1 << 30)))
            else:
                raw = gt + self._smooth_noise(gt.shape)
            gts.append(gt)
            raws.append(raw)
            pitches.append(f0[2 * s:2 * (s + L), None] / 400.0)
        return {k: torch.from_numpy(np.stack(v).astype(np.float32)).to(self.device)
                for k, v in (("gt", gts), ("raw", raws), ("pitch", pitches))}

    def loss(self, model, batch):
        refined = model(batch["raw"], batch["pitch"])
        l1 = torch.abs(refined - batch["gt"]).mean()
        dt_pred = refined[:, 1:] - refined[:, :-1]
        dt_gt = batch["gt"][:, 1:] - batch["gt"][:, :-1]
        temporal = torch.abs(dt_pred - dt_gt).mean()
        total = l1 + self.cfg.lambda_temporal * temporal
        return total, {"l1_loss": l1, "temporal_loss": temporal, "total_loss": total}

    def train_step(self, state: PostnetTrainState, batch):
        state.opt.zero_grad()
        total, metrics = self.loss(state.model, batch)
        total.backward()
        state.opt.step()
        state.global_step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    def update_extra_state(self, state):
        pass

    @torch.no_grad()
    def validate(self, state: PostnetTrainState, max_frames: int = 0, save_dir: str = "") -> Dict[str, float]:
        """Refinement on the held-out split: val_l1_refined, val_l1_raw,
        val_lmd; deterministic (a fixed noise seed, or seed 1234 to
        `predict_fn`). Empty when the timeline is too short to hold out."""
        if self.T_val == 0:
            return {}
        lm, f0, L = self.lm, self.f0, self.cfg.seq_len
        starts = list(range(self.T_train, self.T - L + 1, L)) or [self.T - L]
        val_rng = np.random.RandomState(1234)
        l1_post, l1_raw, lmds = [], [], []
        for s in starts:
            gt = lm[s:s + L]
            if self.predict_fn is not None:
                raw = np.asarray(self.predict_fn(self._hubert(s, L), f0[2 * s:2 * (s + L)], 1234))
            else:
                saved, self.np_rng = self.np_rng, val_rng
                try:
                    raw = gt + self._smooth_noise(gt.shape)
                finally:
                    self.np_rng = saved
            pitch = f0[2 * s:2 * (s + L), None] / 400.0
            refined = state.model(torch.from_numpy(np.asarray(raw, np.float32)[None]).to(self.device),
                                  torch.from_numpy(pitch[None]).to(self.device))[0].cpu().numpy()
            l1_post.append(float(np.abs(refined - gt).mean()))
            l1_raw.append(float(np.abs(raw - gt).mean()))
            d = (refined.reshape(L, 68, 3) - gt.reshape(L, 68, 3)) / 10.0
            lmds.append(float(np.mean(np.linalg.norm(d, axis=-1))))
        return {"val_l1_refined": float(np.mean(l1_post)), "val_l1_raw": float(np.mean(l1_raw)),
                "val_lmd": float(np.mean(lmds))}

    def extra_state_dict(self):
        return {}

    def load_extra_state(self, d):
        pass

    def host_state(self) -> Dict:
        return {"np_rng": numpy_rng_state(self.np_rng)}

    def load_host_state(self, d: Dict):
        set_numpy_rng_state(self.np_rng, d["np_rng"])
