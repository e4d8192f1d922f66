"""Fused head-field forward: the hand-written CUDA kernel and its plain
PyTorch version (port of the forward of
`genefaceplusplus_tpu/ops/pallas/fused_field.py`: `weights_from_params` and
`fused_field_eval`).

`fused_field` is the serving path's field. For a CUDA tensor it launches
`csrc/fused_field.cu` (built with nvcc at first use, loaded with ctypes) or
raises; for a CPU tensor it runs `fused_field_plain`, the same function in
PyTorch: bf16 matrix products with float32 results, bf16 rounding at the
same places as the kernel, the same per-frame bias rows.

Widths are the flagship's (pos 128, amb 64, hidden 128, geo 128, cond 64),
checked by `weights_from_params`. The weight layout is the JAX package's
padded `FieldWeights`, so both packages fold weights identically.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple, Tuple

import torch

from genefaceplusplus_tpu_torch.ops.fastmath import fast_cos, fast_sin, fast_tanh
from genefaceplusplus_tpu_torch.ops.fourier_encoder import project

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "fused_field.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
AMB_DIM = 3  # the kernel's ambient coordinate width
NVCC_HOMES = ("/usr/local/cuda",)  # searched after PATH, $CUDA_HOME, $CUDA_PATH


class FieldWeights(NamedTuple):
    """All field weights in the JAX kernel's padded layout."""

    pos_B: torch.Tensor  # [8, 128] f32   rows 0..2 live, 2pi/bound folded in
    amb_w1: torch.Tensor  # [384, 128] bf16 rows: 256 pos_feat + 64 cond + pad
    amb_w2: torch.Tensor  # [128, 128] bf16
    amb_w3: torch.Tensor  # [128, 128] bf16 cols: amb_dim live
    amb_B: torch.Tensor  # [128, 64] f32   rows: amb_dim live, 2pi folded in
    sig_w1: torch.Tensor  # [384, 128] bf16 rows: 256 pos_feat + 128 amb_feat
    sig_w2: torch.Tensor  # [128, 128] bf16
    sig_w3: torch.Tensor  # [128, 256] bf16 cols: 1 sigma + 128 geo + pad
    col_w1: torch.Tensor  # [256, 128] bf16 rows: 16 SH + 128 geo + ind_dim + pad
    col_w2: torch.Tensor  # [128, 128] bf16 cols: 3 rgb live


FIELD_SHAPES = {
    "pos_B": ((8, 128), torch.float32), "amb_w1": ((384, 128), torch.bfloat16),
    "amb_w2": ((128, 128), torch.bfloat16), "amb_w3": ((128, 128), torch.bfloat16),
    "amb_B": ((128, 64), torch.float32), "sig_w1": ((384, 128), torch.bfloat16),
    "sig_w2": ((128, 128), torch.bfloat16), "sig_w3": ((128, 256), torch.bfloat16),
    "col_w1": ((256, 128), torch.bfloat16), "col_w2": ((128, 128), torch.bfloat16),
}


def weights_from_params(model, bound: float = 1.0) -> FieldWeights:
    """Fold a port `RADNeRF` (Fourier, flagship width) into kernel form."""
    c = model.cfg
    if not (c.grid_type == "fourier" and c.fourier_pos_features == 128
            and c.fourier_amb_features == 64 and c.hidden_dim_ambient == 128
            and c.hidden_dim_sigma == 128 and c.hidden_dim_color == 128
            and c.geo_feat_dim == 128 and c.cond_out_dim == 64
            and c.individual_embedding_dim <= 16):
        raise ValueError("the fused field takes the flagship Fourier width only "
                         "(pos 128, amb 64, hidden 128, geo 128, cond 64, ind <= 16)")
    two_pi = 2.0 * math.pi

    def pad(x, shape, dtype=torch.bfloat16):
        out = torch.zeros(shape, dtype=torch.float32, device=x.device)
        out[: x.shape[0], : x.shape[1]] = x.float()
        return out.to(dtype)

    with torch.no_grad():
        f32 = torch.float32
        amb, sig, col = model.ambient_net.dense, model.sigma_net.dense, model.color_net.dense
        return FieldWeights(
            pos_B=pad(model.position_embedder.B.t() * (two_pi / bound), (8, 128), f32),
            amb_w1=pad(amb[0].weight.t(), (384, 128)),
            amb_w2=pad(amb[1].weight.t(), (128, 128)),
            amb_w3=pad(amb[2].weight.t(), (128, 128)),
            amb_B=pad(model.ambient_embedder.B.t() * two_pi, (128, 64), f32),
            sig_w1=pad(sig[0].weight.t(), (384, 128)),
            sig_w2=pad(sig[1].weight.t(), (128, 128)),
            sig_w3=pad(sig[2].weight.t(), (128, 256)),
            col_w1=pad(col[0].weight.t(), (256, 128)),
            col_w2=pad(col[1].weight.t(), (128, 128)),
        )


def bias_rows(cond_feat: torch.Tensor, ind_code, w: FieldWeights) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame constant terms as bias rows [128] f32: bf16(cond) . amb_w1's
    cond rows and bf16(ind) . col_w1's ind rows, rounded to bf16 as the JAX
    kernel rounds them. Computed once per frame, not per point."""
    dev = w.amb_w1.device
    cond128 = torch.zeros((1, 128), dtype=torch.float32, device=dev)
    cond128[:, :64] = cond_feat.reshape(1, 64).float()
    amb_bias = (cond128.to(torch.bfloat16) @ w.amb_w1[256:]).float()
    ind16 = torch.zeros((1, 16), dtype=torch.float32, device=dev)
    if ind_code is not None and ind_code.numel() > 0:
        ind16[:, : ind_code.numel()] = ind_code.reshape(1, -1).float()
    col_bias = (ind16.to(torch.bfloat16) @ w.col_w1[144:160]).float()
    return amb_bias.reshape(128), col_bias.reshape(128)


def _sh16(d: torch.Tensor) -> torch.Tensor:
    """Degree-4 real SH basis [N, 16], in the fused kernel's form
    (fused_field.py:_sh16; term 8 factors (x2 - y2), unlike sh_encode)."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z
    cols = [
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y,
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy,
        -1.0925484305920792 * yz,
        0.94617469575755997 * z2 - 0.31539156525251999,
        -1.0925484305920792 * xz,
        0.54627421529603959 * (x2 - y2),
        0.59004358992664352 * y * (-3.0 * x2 + y2),
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * z2),
        0.3731763325901154 * z * (5.0 * z2 - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * z2),
        1.4453057213202769 * z * (x2 - y2),
        0.59004358992664352 * x * (-x2 + 3.0 * y2),
    ]
    return torch.stack(cols, dim=-1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 product with a float32 result. Products of bf16 values
    are exact in float32, so a float32 matmul of the upcast operands is the
    bf16-in / f32-accumulate product (given TF32 is off on a GPU)."""
    return a.float() @ b.float()


def fused_field_plain(xyz, dirs, amb_bias, col_bias, w: FieldWeights, amb_dim: int = AMB_DIM):
    """Plain PyTorch version of the fused field.

    xyz, dirs [N, 3] f32; amb_bias, col_bias [128] f32 (`bias_rows`).
    Returns (sigma [N], rgb [N, 3], ambient_pos [N, amb_dim])."""
    relu = torch.relu
    bf16 = torch.bfloat16
    proj = project(xyz.float(), w.pos_B[:3])
    pos_feat = torch.cat([fast_sin(proj), fast_cos(proj)], dim=-1).to(bf16)

    h = relu(_dot(pos_feat, w.amb_w1[:256]) + amb_bias).to(bf16)
    h = relu(_dot(h, w.amb_w2)).to(bf16)
    amb_pos = fast_tanh(_dot(h, w.amb_w3[:, :amb_dim]))
    aproj = project(amb_pos, w.amb_B[:amb_dim])
    amb_feat = torch.cat([fast_sin(aproj), fast_cos(aproj)], dim=-1).to(bf16)

    h = relu(_dot(pos_feat, w.sig_w1[:256]) + _dot(amb_feat, w.sig_w1[256:384])).to(bf16)
    h = relu(_dot(h, w.sig_w2)).to(bf16)
    sig_out = _dot(h, w.sig_w3[:, :129])
    sigma = torch.exp(torch.clamp(sig_out[:, 0], -15.0, 15.0))
    geo = sig_out[:, 1:129].to(bf16)

    sh = _sh16(dirs.float()).to(bf16)
    h = relu(_dot(sh, w.col_w1[:16]) + _dot(geo, w.col_w1[16:144]) + col_bias).to(bf16)
    rgb_logit = _dot(h, w.col_w2[:, :3])
    rgb = 1.0 / (1.0 + torch.exp(-rgb_logit))
    return sigma, rgb, amb_pos


# ---------------------------------------------------------------------------
# The CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------

def _find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), *NVCC_HOMES):
        if home:
            cands.append(os.path.join(home, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "cannot build csrc/fused_field.cu: nvcc not found (looked on PATH, "
        "$CUDA_HOME/bin, /usr/local/cuda/bin). The CUDA field needs the CUDA "
        "toolkit; CPU tensors take fused_field_plain instead.")


def build_fused_field() -> Path:
    """Compile csrc/fused_field.cu into build/kernels/, keyed by the hash of
    the source and flags (a changed source rebuilds). Returns the library
    path; nvcc's -Xptxas -v report sits beside it as `.log`."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libfused_field-{key}.so"
    if out.exists():
        return out
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {SOURCE} (rc {proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_fused_field()))
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    lib.gfpp_fused_field_forward.argtypes = [ptr, ptr, c_int] + [ptr] * 15 + [ptr]
    lib.gfpp_fused_field_forward.restype = c_int
    lib.gfpp_cuda_error_string.argtypes = [c_int]
    lib.gfpp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"fused_field: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_field: {name} must be {dtype} {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"fused_field: {name} must be contiguous")
    if dtype == torch.bfloat16 and t.data_ptr() % 32:
        # the kernel loads the bf16 weight matrices as WMMA fragments
        raise ValueError(f"fused_field: {name} must be 32-byte aligned")


def fused_field(xyz, dirs, amb_bias, col_bias, w: FieldWeights, amb_dim: int = AMB_DIM):
    """The fused field: CUDA kernel for CUDA tensors, `fused_field_plain`
    for CPU tensors. Same contract as `fused_field_plain`.

    `fused_field.launches` counts kernel launches (plain calls do not count)."""
    if xyz.device.type == "cpu":
        return fused_field_plain(xyz, dirs, amb_bias, col_bias, w, amb_dim)
    if xyz.device.type != "cuda":
        raise ValueError(f"fused_field: unsupported device {xyz.device}")
    if amb_dim != AMB_DIM:
        raise ValueError(f"fused_field: the CUDA kernel takes amb_dim={AMB_DIM}, got {amb_dim}")
    dev = xyz.device
    N = xyz.shape[0]
    if N >= 2 ** 31 // 3:
        raise ValueError(f"fused_field: {N} points exceed the kernel's int32 indexing")
    _check("xyz", xyz, (N, 3), torch.float32, dev)
    _check("dirs", dirs, (N, 3), torch.float32, dev)
    _check("amb_bias", amb_bias, (128,), torch.float32, dev)
    _check("col_bias", col_bias, (128,), torch.float32, dev)
    for name, (shape, dtype) in FIELD_SHAPES.items():
        _check(name, getattr(w, name), shape, dtype, dev)

    sigma = torch.empty((N,), dtype=torch.float32, device=dev)
    rgb = torch.empty((N, 3), dtype=torch.float32, device=dev)
    amb = torch.empty((N, AMB_DIM), dtype=torch.float32, device=dev)
    if N == 0:
        return sigma, rgb, amb
    lib = _library()
    with torch.cuda.device(dev):  # the launch goes to the current device
        rc = lib.gfpp_fused_field_forward(
            xyz.data_ptr(), dirs.data_ptr(), N, w.pos_B.data_ptr(), w.amb_w1.data_ptr(),
            w.amb_w2.data_ptr(), w.amb_w3.data_ptr(), w.amb_B.data_ptr(), w.sig_w1.data_ptr(),
            w.sig_w2.data_ptr(), w.sig_w3.data_ptr(), w.col_w1.data_ptr(), w.col_w2.data_ptr(),
            amb_bias.data_ptr(), col_bias.data_ptr(), sigma.data_ptr(), rgb.data_ptr(),
            amb.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.gfpp_cuda_error_string(rc).decode()
        raise RuntimeError(f"fused_field kernel launch failed: CUDA error {rc} ({msg})")
    fused_field.launches += 1
    return sigma, rgb, amb


fused_field.launches = 0
