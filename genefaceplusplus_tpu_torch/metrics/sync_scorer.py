"""The lip-sync confidence instrument (port of
`genefaceplusplus_tpu/metrics/sync_scorer.py`): a small audio-mouth twin
network trained contrastively on an identity's own aligned gt pairs, then
scoring a clip by how sharply its mouth motion locks onto the driving
audio across temporal offsets (SyncNet's LSE-C / LSE-D analogue).

  * audio tower: 1-D convs (kernels 5, 3, 3; 128 channels) with 2x max
    pools over a 0.4 s window of 50 Hz features (20 frames), flattened in
    JAX's NWC order, then dense 256 and dense 128;
  * mouth tower: an MLP (256, 256, 128) over a 0.2 s window (5 frames at
    25 Hz) of pose- and scale-normalised mouth landmarks;
  * InfoNCE over in-batch negatives and a temporally shifted copy of the
    anchor's own mouth window (5..15 frames either way);
  * confidence = peak - median of the mean cosine similarity over offsets
    -15..15, and the argmax offset (0 = in sync).

Parameters are JAX's flax trees: `train_sync_scorer` returns one,
`sync_confidence` takes one, and `save_params` / `load_params` write and
read the msgpack bytes JAX's `save_params` / `load_params` do. One training
step is `optax.adam`'s (`training/schedulers.py:OptaxAdam`); the batch
indices come from a `torch.Generator` seeded with `seed + 1`, so a run
draws other indices than JAX's `jax.random` and its trained weights differ
from JAX's. The entry points run on the card unless `device` names
another.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from genefaceplusplus_tpu_torch.models.audio2motion.wavenet import Conv1d
from genefaceplusplus_tpu_torch.models.cond_encoder import lecun_normal_
from genefaceplusplus_tpu_torch.training.schedulers import OptaxAdam
from genefaceplusplus_tpu_torch.utils import msgpack
from genefaceplusplus_tpu_torch.utils.convert_jax import export_flax_params, load_flax_tree
from genefaceplusplus_tpu_torch.utils.device import resolve_device

AUDIO_WIN = 20   # 50 Hz audio frames (0.4 s)
MOUTH_WIN = 5    # 25 Hz video frames (0.2 s)
EMB_DIM = 128
MAX_OFFSET = 15  # the offset sweep's half-width (25 Hz frames)
MOUTH_DIM = 40   # 20 mouth landmarks x (x, y)


def normalize_mouth_lms(lms: np.ndarray) -> np.ndarray:
    """[T, 68, 2] (any scale) -> [T, 40] mouth points centred on the nose
    (rigid to the jaw) and scaled by the interocular distance."""
    lms = np.asarray(lms, np.float32)
    eye_l = lms[:, 36:42].mean(1)
    eye_r = lms[:, 42:48].mean(1)
    scale = np.linalg.norm(eye_r - eye_l, axis=-1, keepdims=True) + 1e-6
    centre = lms[:, 27:36].mean(1)
    mouth = (lms[:, 48:68] - centre[:, None]) / scale[:, None]
    return mouth.reshape(len(lms), -1)


def _init(module: nn.Module, fan_in: int, generator: Optional[torch.Generator]) -> nn.Module:
    lecun_normal_(module.weight, fan_in, generator)
    nn.init.zeros_(module.bias)
    return module


class SyncScorer(nn.Module):
    """The twin towers -> L2-normalised embeddings (the score is their
    cosine similarity). Takes audio windows [B, AUDIO_WIN, C] and mouth
    windows [B, MOUTH_WIN, 40], as JAX's."""

    def __init__(self, audio_dim: int, emb_dim: int = EMB_DIM, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        c_in = audio_dim
        for i, k in enumerate((5, 3, 3)):
            setattr(self, f"a_conv{i}", _init(Conv1d(c_in, 128, k, padding=k // 2), k * c_in, g))
            c_in = 128
        self.a_fc = _init(nn.Linear(128 * (AUDIO_WIN // 8), 256), 128 * (AUDIO_WIN // 8), g)
        self.a_out = _init(nn.Linear(256, emb_dim), 256, g)
        self.v_fc0 = _init(nn.Linear(MOUTH_WIN * MOUTH_DIM, 256), MOUTH_WIN * MOUTH_DIM, g)
        self.v_fc1 = _init(nn.Linear(256, 256), 256, g)
        self.v_out = _init(nn.Linear(256, emb_dim), 256, g)

    def forward(self, audio_win: torch.Tensor, mouth_win: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        a = audio_win.transpose(1, 2)  # NCW
        for i in range(3):
            a = F.max_pool1d(torch.relu(getattr(self, f"a_conv{i}")(a)), 2, 2)
        a = a.transpose(1, 2).reshape(a.shape[0], -1)  # JAX's NWC flatten
        a = self.a_out(torch.relu(self.a_fc(a)))
        v = mouth_win.reshape(mouth_win.shape[0], -1)
        v = self.v_out(torch.relu(self.v_fc1(torch.relu(self.v_fc0(v)))))
        a = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-6)
        v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-6)
        return a, v


def _windows(hubert: np.ndarray, mouth: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The aligned (audio, mouth) windows of every valid centre frame t."""
    T = len(mouth)
    lo = max(MOUTH_WIN // 2, AUDIO_WIN // 4 + 1)
    hi = T - lo - 1
    ts = np.arange(lo, hi)
    aw = np.stack([hubert[2 * t - AUDIO_WIN // 2: 2 * t + AUDIO_WIN // 2] for t in ts])
    vw = np.stack([mouth[t - MOUTH_WIN // 2: t + MOUTH_WIN // 2 + 1] for t in ts])
    return aw.astype(np.float32), vw.astype(np.float32), ts


def _scorer(params: Mapping, device) -> SyncScorer:
    """A `SyncScorer` holding a flax params tree, on `device`."""
    model = SyncScorer(int(np.shape(params["params"]["a_conv0"]["kernel"])[1]))
    load_flax_tree(model, params)
    return model.to(device)


def info_nce_loss(model: SyncScorer, audio: torch.Tensor, mouth: torch.Tensor, mouth_shifted: torch.Tensor,
                  temperature: float = 0.07) -> torch.Tensor:
    """InfoNCE of each audio window against the batch's mouth windows and its
    own shifted mouth window (the last logit)."""
    a, v = model(audio, mouth)
    _, v_neg = model(audio, mouth_shifted)
    logits = torch.cat([a @ v.T / temperature, (a * v_neg).sum(-1, keepdim=True) / temperature], dim=1)
    return F.cross_entropy(logits, torch.arange(len(a), device=a.device))


def train_sync_scorer(hubert: np.ndarray, lms: np.ndarray, steps: int = 2000, batch: int = 64, lr: float = 3e-4,
                      seed: int = 0, temperature: float = 0.07, log_every: int = 0, device=None) -> Dict:
    """Contrastive training on the identity's aligned gt pairs (hubert [2T,
    C] at 50 Hz, lms [T, 68, 2]); returns the flax params tree."""
    dev = resolve_device(device)
    aw, vw, _ = _windows(np.asarray(hubert, np.float32), normalize_mouth_lms(lms))
    n = len(aw)
    model = SyncScorer(aw.shape[-1], generator=torch.Generator().manual_seed(seed)).to(dev)
    opt = OptaxAdam(model, lr, collection=None)
    aw_t, vw_t = torch.from_numpy(aw).to(dev), torch.from_numpy(vw).to(dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    for it in range(steps):
        idx = torch.randint(0, n, (batch,), generator=g, device=dev)
        # the shift negatives: the same clip, 5..MAX_OFFSET frames either way
        mag = torch.randint(5, MAX_OFFSET + 1, (batch,), generator=g, device=dev)
        sgn = torch.where(torch.rand(batch, generator=g, device=dev) < 0.5, -1, 1)
        nidx = torch.clamp(idx + sgn * mag, 0, n - 1)
        opt.zero_grad()
        loss = info_nce_loss(model, aw_t[idx], vw_t[idx], vw_t[nidx], temperature)
        loss.backward()
        opt.step()
        if log_every and (it + 1) % log_every == 0:
            print(f"| sync it {it + 1} loss={float(loss):.4f}")
    return export_flax_params(model)


def sync_confidence(params: Mapping, hubert: np.ndarray, lms: np.ndarray, max_offset: int = MAX_OFFSET,
                    device=None) -> Dict[str, float]:
    """The offset sweep of a clip: for every centre frame t the cosine
    similarity of audio(t) and mouth(t + d), d in [-max_offset,
    max_offset], averaged into a curve. Returns confidence (peak - median),
    offset (the argmax d), sim_at_zero and the curve."""
    dev = resolve_device(device)
    aw, vw, _ = _windows(np.asarray(hubert, np.float32), normalize_mouth_lms(lms))
    n = len(aw)
    with torch.no_grad():
        a, v = _scorer(params, dev)(torch.from_numpy(aw).to(dev), torch.from_numpy(vw).to(dev))
    a_emb, v_emb = a.cpu().numpy(), v.cpu().numpy()
    offsets = np.arange(-max_offset, max_offset + 1)
    curve = np.full(len(offsets), np.nan, np.float32)
    for i, d in enumerate(offsets):
        if d >= 0:
            sims = (a_emb[: n - d] * v_emb[d:]).sum(-1)
        else:
            sims = (a_emb[-d:] * v_emb[: n + d]).sum(-1)
        curve[i] = float(np.mean(sims))
    peak = int(np.argmax(curve))
    return {
        "confidence": round(float(curve[peak] - np.median(curve)), 4),
        "offset": int(offsets[peak]),
        "sim_at_zero": round(float(curve[max_offset]), 4),
        "curve": [round(float(c), 4) for c in curve],
    }


def save_params(params: Mapping, path: str) -> None:
    """Write a params tree as flax msgpack (JAX's `load_params` reads it)."""
    with open(path, "wb") as f:
        f.write(msgpack.packb(params))


def load_params(path: str, audio_dim: int = 1024) -> Dict:
    """A params tree from flax msgpack, checked against the scorer at
    `audio_dim` (every leaf and tensor of its shape)."""
    with open(path, "rb") as f:
        params = msgpack.unpackb(f.read())
    load_flax_tree(SyncScorer(audio_dim), params)
    return params
