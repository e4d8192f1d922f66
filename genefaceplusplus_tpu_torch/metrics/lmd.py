"""The landmark-distance (LMD) quality instrument (port of
`genefaceplusplus_tpu/metrics/lmd.py`): light landmark detectors trained
per identity on its gt frames, applied to rendered frames; the distance in
512-scale pixels.

Two detectors, both on [B, 3, 128, 128] images in [0, 1]:
  v1  a plain conv regressor, 136 coordinates from an 8x8 bottleneck;
  v2  a U-Net decoding to 32x32 heatmaps, a spatial soft-argmax at the
      learned `softargmax_temp`, a 2x2 calibration (`raw @ calib_w +
      calib_b`) and, on request, each landmark's heatmap-peak probability
      (near 1 / 1024 means no detection).

Parameters are JAX's flax trees (a detector's msgpack file, read by
`load_detector_params` through `utils/msgpack.py`), loaded into the port's
modules by the weight bridge. The convolutions follow flax's "SAME": a
stride-2 3x3 conv on an even input pads 0 before and 1 after, and a
stride-2 transposed conv is torch's `ConvTranspose2d` (padding 0, the
kernel flipped by the bridge) cropped to 2x. Dense layers flatten in
JAX's NHWC order. The entry points run on the card unless `device` names
another; frames resize with `data/dataset.py:resize_bilinear` (where
cv2.resize samples) and no cv2.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from genefaceplusplus_tpu_torch.data.dataset import resize_bilinear
from genefaceplusplus_tpu_torch.models.cond_encoder import lecun_normal_
from genefaceplusplus_tpu_torch.utils import msgpack
from genefaceplusplus_tpu_torch.utils.convert_jax import load_flax_tree
from genefaceplusplus_tpu_torch.utils.device import Conv2d, conv_f32, resolve_device

__all__ = [
    "lm_detector",
    "load_detector_params",
    "to_detector_input",
    "detect_lmd",
    "detect_lms",
]

_WIDTHS = (32, 64, 128, 256)


def _init(module: nn.Module, fan_in: int, generator: Optional[torch.Generator]) -> nn.Module:
    """flax's default init: lecun normal weights, zero bias."""
    lecun_normal_(module.weight, fan_in, generator)
    nn.init.zeros_(module.bias)
    return module


def _encoder(generator: Optional[torch.Generator]) -> list:
    """Per width a stride-2 3x3 conv and a 3x3 conv (flax's Conv_0..Conv_7)."""
    convs, c_in = [], 3
    for w in _WIDTHS:
        convs += [_init(Conv2d(c_in, w, 3, stride=2), 9 * c_in, generator),
                  _init(Conv2d(w, w, 3, padding=1), 9 * w, generator)]
        c_in = w
    return convs


def _encode(convs, x: torch.Tensor, skips: Optional[list] = None) -> torch.Tensor:
    for i, conv in enumerate(convs[:2 * len(_WIDTHS)]):
        if i % 2 == 0:
            x = F.pad(x, (0, 1, 0, 1))  # flax SAME, stride 2, even input
        x = torch.relu(conv(x))
        if i % 2 == 1 and skips is not None:
            skips.append(x)
    return x


class LMDetector(nn.Module):
    """v1: the encoder to [B, 256, 8, 8], then dense 256 and dense 136."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.convs = nn.ModuleList(_encoder(generator))
        self.dense = nn.ModuleList([_init(nn.Linear(8 * 8 * 256, 256), 8 * 8 * 256, generator),
                                    _init(nn.Linear(256, 136), 256, generator)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _encode(self.convs, x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # JAX's NHWC flatten
        return self.dense[1](torch.relu(self.dense[0](x)))  # normalised (x, y) x 68


class LMDetectorV2(nn.Module):
    """v2: the encoder, two transposed-conv up steps joined to the 16^2 and
    32^2 skips, a 1x1 conv to 68 heatmaps, the soft-argmax and the
    calibration. Returns [B, 136] (and the peak probabilities [B, 68] with
    `return_conf`)."""

    def __init__(self, return_conf: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.return_conf = return_conf
        convs = _encoder(g)
        convs += [_init(Conv2d(128, 128, 3, padding=1), 9 * 128, g), _init(Conv2d(64, 64, 3, padding=1), 9 * 64, g),
                  _init(Conv2d(64, 68, 1), 64, g)]
        self.convs = nn.ModuleList(convs)
        self.deconvs = nn.ModuleList([_init(nn.ConvTranspose2d(256, 128, 3, stride=2), 9 * 256, g),
                                      _init(nn.ConvTranspose2d(128, 64, 3, stride=2), 9 * 128, g)])
        self.softargmax_temp = nn.Parameter(torch.tensor(10.0))
        self.calib_w = nn.Parameter(torch.eye(2))
        self.calib_b = nn.Parameter(torch.zeros(2))

    @staticmethod
    def _up(deconv: nn.ConvTranspose2d, x: torch.Tensor) -> torch.Tensor:
        """flax's stride-2 SAME transposed conv: torch's, cropped to 2x."""
        H, W = x.shape[-2:]
        y = conv_f32(x, deconv.weight, deconv.bias, stride=2, transposed=True)
        return y[..., :2 * H, :2 * W]

    def forward(self, x: torch.Tensor):
        skips = []
        x = _encode(self.convs, x, skips)  # skips at 64, 32, 16, 8
        x = torch.relu(self._up(self.deconvs[0], x) + skips[2])
        x = torch.relu(self.convs[8](x))
        x = torch.relu(self._up(self.deconvs[1], x) + skips[1])
        x = torch.relu(self.convs[9](x))
        h = self.convs[10](x)  # [B, 68, Hh, Wh] logits
        B, L, Hh, Wh = h.shape
        probs = torch.softmax((h * self.softargmax_temp).reshape(B, L, Hh * Wh), dim=-1)
        cell = torch.arange(Hh, dtype=torch.float32, device=h.device) + 0.5
        rows = (cell / Hh).repeat_interleave(Wh)  # [Hh*Wh] normalised row
        cols = (cell / Wh).repeat(Hh)  # [Hh*Wh] normalised column
        raw = torch.stack([(probs * cols).sum(-1), (probs * rows).sum(-1)], dim=-1)  # [B, 68, 2] (x, y)
        out = (raw @ self.calib_w + self.calib_b).reshape(B, 136)
        if self.return_conf:
            return out, probs.amax(dim=-1)
        return out


def lm_detector(arch: str = "v2", return_conf: bool = False, generator: Optional[torch.Generator] = None):
    """The detector module for `arch` in {v1, v2} (seeded from `generator`)."""
    if arch == "v1":
        return LMDetector(generator)
    if arch == "v2":
        return LMDetectorV2(return_conf, generator)
    raise ValueError(f"unknown LMD detector arch: {arch!r}")


def load_detector_params(path: str):
    """A detector's flax variables from its msgpack file."""
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read())


def to_detector_input(img_u8) -> np.ndarray:
    """A frame (uint8, or float in [0, 1]) -> [128, 128, 3] float32 in [0,
    1]; as JAX's, only the height is checked before resizing."""
    img = np.asarray(img_u8)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    if img.shape[0] != 128:
        img = resize_bilinear(img, 128, 128)
    return img[..., :3]


def _run(frames_u8, arch: str, return_conf: bool, params: Mapping, device):
    dev = resolve_device(device)
    det = lm_detector(arch, return_conf=return_conf)
    load_flax_tree(det, params)
    det = det.to(dev)
    x = torch.from_numpy(np.stack([to_detector_input(f) for f in frames_u8])).to(dev).permute(0, 3, 1, 2)
    with torch.no_grad():
        return det(x)


def detect_lmd(frames_u8, gt_lms, detector_path: str, arch: str = "v1", per_landmark: bool = False,
               with_conf: bool = False, params=None, device=None):
    """The mean landmark distance (px at 512) of the detector's landmarks on
    the frames against `gt_lms` [N, 68, 2] in [0, 1]; with `per_landmark`
    the [N, 68] distances; with `with_conf` (v2) also the [N, 68] peak
    probabilities. `params` (a flax tree) replaces the file's."""
    conf = with_conf and arch == "v2"
    if params is None:
        params = load_detector_params(detector_path)
    out = _run(frames_u8, arch, conf, params, device)
    probs = None
    if conf:
        out, probs = out
        probs = probs.cpu().numpy()
    pred = out.cpu().numpy().reshape(-1, 68, 2)
    gt = np.asarray(gt_lms).reshape(-1, 68, 2)
    err = np.linalg.norm((pred - gt) * 512.0, axis=-1)  # [N, 68]
    res = err if per_landmark else float(np.mean(err))
    return (res, probs) if conf else res


def detect_lms(frames_u8, detector_path: str, arch: str = "v2", params=None, device=None) -> np.ndarray:
    """The detector's landmarks [N, 68, 2] in [0, 1] on the frames (the
    sync-confidence instrument's input, `metrics/sync_scorer.py`)."""
    if params is None:
        params = load_detector_params(detector_path)
    return _run(frames_u8, arch, False, params, device).cpu().numpy().reshape(-1, 68, 2)
