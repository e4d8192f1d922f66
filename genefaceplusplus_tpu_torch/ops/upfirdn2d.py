"""upfirdn2d (upsample -> FIR filter -> downsample) and conv2d_resample (port
of `genefaceplusplus_tpu/ops/upfirdn2d.py`).

Layout: NCHW activations, OIHW conv weights (`F.conv2d`'s); filters are
2-D numpy arrays. JAX upsamples through `lhs_dilation`, which `F.conv2d`
lacks: here the input is zero-inserted explicitly (size n * up, so JAX's
after-pad `p1 + up - 1` becomes `p1`), giving the same sizes and values.
Both convolutions are cross-correlations, so every flip sits where JAX has
it. A float32 convolution on the card runs with cuDNN's TF32 off for the
call (`conv2d`), whatever `torch.backends.cudnn.allow_tf32` says; bfloat16
convolutions are unaffected.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from genefaceplusplus_tpu_torch.utils.device import cudnn_tf32_off


def setup_filter(f: Sequence[float], normalize: bool = True, gain: float = 1.0) -> np.ndarray:
    """1D taps -> normalised 2D filter (reference setup_filter, separable)."""
    f = np.asarray(f, dtype=np.float32)
    if f.ndim == 1:
        f = np.outer(f, f)
    if normalize:
        f = f / f.sum()
    return f * gain


def _parse_padding(padding: Union[int, Sequence[int]]):
    if isinstance(padding, int):
        return padding, padding, padding, padding
    padding = list(padding)
    if len(padding) == 2:
        px, py = padding
        return px, px, py, py
    px0, px1, py0, py1 = padding
    return px0, px1, py0, py1


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, groups: int = 1) -> torch.Tensor:
    """VALID cross-correlation of x [N, C, H, W] with w [O, C/groups, kh, kw]
    in x's dtype; in full float32 for a float32 CUDA tensor."""
    w = w.to(x.dtype)
    if x.is_cuda and x.dtype == torch.float32:
        with cudnn_tf32_off():
            return F.conv2d(x, w, stride=stride, groups=groups)
    return F.conv2d(x, w, stride=stride, groups=groups)


def _zero_insert(x: torch.Tensor, up: int) -> torch.Tensor:
    """[N, C, H, W] -> [N, C, H*up, W*up], x at multiples of `up`, zeros
    elsewhere (up - 1 trailing zeros per row and column, as torch's
    reference upfirdn2d)."""
    if up == 1:
        return x
    N, C, H, W = x.shape
    y = x.new_zeros((N, C, H, up, W, up))
    y[:, :, :, 0, :, 0] = x
    return y.reshape(N, C, H * up, W * up)


def _pad(x: torch.Tensor, py0: int, py1: int, px0: int, px1: int) -> torch.Tensor:
    """Zero padding; a negative amount crops, as lax's padding does."""
    return F.pad(x, (px0, px1, py0, py1))


def upfirdn2d(x: torch.Tensor, f: Optional[np.ndarray], up: int = 1, down: int = 1,
              padding: Union[int, Sequence[int]] = 0, gain: float = 1.0,
              flip_filter: bool = False) -> torch.Tensor:
    """Zero-insert upsample by `up`, pad, FIR filter, downsample by `down`
    (x [N, C, H, W])."""
    px0, px1, py0, py1 = _parse_padding(padding)
    C = x.shape[1]
    f = np.ones((1, 1), np.float32) if f is None else np.asarray(f, dtype=np.float32)
    if not flip_filter:
        f = f[::-1, ::-1]  # convolution (the reference flips when flip_filter=False)
    f = f * gain
    x = _pad(_zero_insert(x, up), py0, py1, px0, px1)
    if f.shape == (1, 1) and down == 1:  # a 1x1 depthwise filter is a scale
        return x if f[0, 0] == 1.0 else x * float(f[0, 0])
    kern = torch.from_numpy(np.ascontiguousarray(f)).to(x.device)[None, None].repeat(C, 1, 1, 1)
    return conv2d(x, kern, stride=down, groups=C)


def upsample2d(x: torch.Tensor, f: np.ndarray, up: int = 2, gain: float = 1.0) -> torch.Tensor:
    """2x (or `up`x) FIR upsampling (reference upsample2d)."""
    fw = f.shape[-1]
    p0 = (fw + up - 1) // 2
    p1 = (fw - up) // 2
    return upfirdn2d(x, f, up=up, padding=(p0, p1, p0, p1), gain=gain * up * up)


def downsample2d(x: torch.Tensor, f: np.ndarray, down: int = 2, gain: float = 1.0) -> torch.Tensor:
    fw = f.shape[-1]
    p0 = (fw - down + 1) // 2
    p1 = (fw - down) // 2
    return upfirdn2d(x, f, down=down, padding=(p0, p1, p0, p1), gain=gain)


def _phase_slices(ch: int, up: int, pad_lo: int):
    """Per-output-phase 1D slices of a combined up-conv kernel: for output
    phase p, the taps s with (p + s - pad_lo) % up == 0 and the input offset
    of the phase kernel's first tap. Returns [(taps_idx, delta)] per phase."""
    out = []
    for p in range(up):
        rho = (pad_lo - p) % up
        taps = list(range(rho, ch, up))
        delta = (p + rho - pad_lo) // up
        out.append((taps, delta))
    return out


def _conv2d_up_subpixel(x: torch.Tensor, c: torch.Tensor, up: int, py0, py1, px0, px1):
    """Up-`up` conv with combined kernel c [O, I, ch, cw] as one stride-1 conv
    at the input resolution with up^2 * O output channels, then
    depth-to-space: phase (p, q) is channel (p*up + q)*O + o, as in JAX
    (`F.pixel_shuffle` would expect o*up^2 + p*up + q). The paddings follow
    JAX's lhs-dilation convention (after-pads include up - 1). Returns None
    when the geometry does not decompose."""
    N, _, H, W = x.shape
    O, I, ch, cw = c.shape
    out_h = (H - 1) * up + 1 + py0 + py1 - ch + 1
    out_w = (W - 1) * up + 1 + px0 + px1 - cw + 1
    if out_h % up or out_w % up or out_h <= 0 or out_w <= 0:
        return None
    ph = _phase_slices(ch, up, py0)
    pw = _phase_slices(cw, up, px0)
    dh_min = min(d for _, d in ph)
    Lh = max(d + len(t) for t, d in ph) - dh_min
    dw_min = min(d for _, d in pw)
    Lw = max(d + len(t) for t, d in pw) - dw_min
    mh = out_h // up - 1
    mw = out_w // up - 1
    pad_top = -dh_min
    pad_bot = (mh + dh_min + Lh) - H
    pad_left = -dw_min
    pad_right = (mw + dw_min + Lw) - W
    if min(pad_top, pad_bot, pad_left, pad_right) < 0:
        return None  # negative padding: the generic path crops instead
    K = c.new_zeros((up * up * O, I, Lh, Lw))
    for p, (th, dh) in enumerate(ph):
        for q, (tw, dw) in enumerate(pw):
            oh, ow = dh - dh_min, dw - dw_min
            K[(p * up + q) * O:(p * up + q + 1) * O, :, oh:oh + len(th), ow:ow + len(tw)] = \
                c[:, :, th][:, :, :, tw]
    z = conv2d(_pad(x, pad_top, pad_bot, pad_left, pad_right), K)  # [N, up*up*O, out_h/up, out_w/up]
    z = z.reshape(N, up, up, O, out_h // up, out_w // up).permute(0, 3, 4, 1, 5, 2)
    return z.reshape(N, O, out_h, out_w)


def _fold_filter(b: torch.Tensor, a: np.ndarray) -> torch.Tensor:
    """The kernel c [O, I, fh+kh-1, fw+kw-1] with x (*) a (*) b == x (*) c
    for cross-correlations (*): c[u:u+kh, v:v+kw] += a[u, v] * b over every
    tap of a, computed as one full convolution of b with a."""
    O, I, kh, kw = b.shape
    fh, fw = a.shape
    k = torch.from_numpy(np.ascontiguousarray(a[::-1, ::-1])).to(b.device)[None, None]
    bp = _pad(b.reshape(O * I, 1, kh, kw), fh - 1, fh - 1, fw - 1, fw - 1)
    return conv2d(bp, k).reshape(O, I, fh + kh - 1, fw + kw - 1)


def conv2d_resample(x: torch.Tensor, w: torch.Tensor, f: Optional[np.ndarray] = None,
                    up: int = 1, down: int = 1, padding: Union[int, Sequence[int]] = 0,
                    groups: int = 1, flip_weight: bool = True) -> torch.Tensor:
    """Conv of x [N, I, H, W] with w [O, I/groups, kh, kw] and optional FIR
    up/downsampling (the reference's generic path, equivalent to every fast
    path). Upsampling with a filter and one group takes the folded-FIR
    subpixel path, as JAX does."""
    fw = f.shape[-1] if f is not None else 1
    fh = f.shape[-2] if f is not None else 1
    px0, px1, py0, py1 = _parse_padding(padding)
    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2
    flip = not flip_weight and (w.shape[2] > 1 or w.shape[3] > 1)

    if up > 1 and down == 1 and f is not None and groups == 1:
        # fold the depthwise FIR into the conv weights: one conv instead of
        # a zero-inserted full-resolution depthwise pass and a conv
        a = np.asarray(f, dtype=np.float32)[::-1, ::-1] * (up ** 2)  # upfirdn's flip_filter=False
        b = torch.flip(w, dims=(2, 3)) if flip else w
        c = _fold_filter(b.float(), a).to(x.dtype)
        y = _conv2d_up_subpixel(x, c, up, py0, py1 + up - 1, px0, px1 + up - 1)
        if y is not None:
            return y
        return conv2d(_pad(_zero_insert(x, up), py0, py1, px0, px1), c)

    x = upfirdn2d(x, f if up > 1 else None, up=up, padding=(px0, px1, py0, py1), gain=up ** 2)
    x = conv2d(x, torch.flip(w, dims=(2, 3)) if flip else w, groups=groups)
    if down > 1:
        x = upfirdn2d(x, f, down=down)
    return x
