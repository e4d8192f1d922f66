"""Fused head field, forward and backward: the hand-written CUDA kernels and
their plain PyTorch versions (port of
`genefaceplusplus_tpu/ops/pallas/fused_field.py`: `weights_from_params`,
`weights_from_params_jnp`, `fused_field_eval`, `_fused_backward` and
`fused_field_train`).

`fused_field` is the field's forward. For a CUDA tensor it launches
`csrc/fused_field.cu` (built with nvcc at first use, loaded with ctypes) or
raises; for a CPU tensor it runs `fused_field_plain`, the same function in
PyTorch: bf16 matrix products with float32 results, bf16 rounding at the
same places as the kernel, the same per-frame bias rows. The kernel reads
its weights as one stream packed in the Hopper matrix-product layout
(`pack_field_weights`, cached per `FieldWeights`).

`fused_field_backward` is its backward: `csrc/fused_field_bwd.cu` on the
card, `fused_field_backward_plain` (the Pallas backward's explicit math,
with its rounding points) on the CPU. `fused_field_train` ties the two into
a `torch.autograd.Function`, the counterpart of the JAX custom VJP.

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
import weakref
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from genefaceplusplus_tpu_torch.ops.fastmath import fast_cos, fast_sin, fast_tanh
from genefaceplusplus_tpu_torch.ops.fourier_encoder import project

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {"fused_field": CSRC / "fused_field.cu", "fused_field_bwd": CSRC / "fused_field_bwd.cu"}
HEADERS = (CSRC / "fused_field_common.cuh", CSRC / "sm90.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
AMB_DIM = 3  # the kernels' ambient coordinate width
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

# the backward's 14 gradient blocks, in `_fused_backward`'s order: name,
# full (padded) shape, and the live region [rows, cols] the kernel computes
GRAD_BLOCKS = (
    ("pos_B", (8, 128), (3, 128)), ("amb_w1p", (256, 128), (256, 128)),
    ("amb_bias", (8, 128), (1, 128)), ("amb_w2", (128, 128), (128, 128)),
    ("amb_w3", (128, 128), (128, 16)), ("amb_B", (128, 64), (3, 64)),
    ("sig_w1p", (256, 128), (256, 128)), ("sig_w1a", (128, 128), (128, 128)),
    ("sig_w2", (128, 128), (128, 128)), ("sig_w3", (128, 256), (128, 144)),
    ("col_w1s", (16, 128), (16, 128)), ("col_w1g", (128, 128), (128, 128)),
    ("col_bias", (8, 128), (1, 128)), ("col_w2", (128, 128), (128, 16)),
)
PACKED_SIZE = sum(r * c for _, _, (r, c) in GRAD_BLOCKS)  # 156,480

# The forward kernel's weight stream (csrc/fused_field.cu, SPEC), in the
# order its products read it: (name, N, K, k16 steps per chunk). Each layer
# is its B operand, the weight's live block transposed to N rows x K,
# packed by `pack_kmajor`; the 3-wide outputs are zero-padded to N = 8, and
# sig_w3's block is its geo columns 1..128, then column 0 (sigma) and 7
# zero columns.
FWD_TILE, FWD_STEP = 64, 192  # points per consumer tile, per persistent block step
FWD_LAYERS = (("amb_w1", 128, 256, 4), ("amb_w2", 128, 128, 4), ("amb_w3", 8, 128, 8),
              ("sig_w1", 128, 384, 4), ("sig_w2", 128, 128, 4), ("sig_w3", 136, 128, 4),
              ("col_w1", 128, 144, 3), ("col_w2", 8, 128, 8))


def weights_from_params(model, bound: float = 1.0, differentiable: bool = False) -> FieldWeights:
    """Fold a port `RADNeRF` (Fourier, flagship width) into kernel form.

    With `differentiable=True` this is `weights_from_params_jnp`: padding,
    transposes and the 2pi/bound factors stay in the autograd graph, so the
    `FieldWeights` gradients of `fused_field_train` reach the `Linear`
    weights and both Fourier `B`s."""
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
        x = x.float()
        return F.pad(x, (0, shape[1] - x.shape[1], 0, shape[0] - x.shape[0])).to(dtype).contiguous()

    with torch.set_grad_enabled(differentiable and torch.is_grad_enabled()):
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


def _cond_ind_rows(cond_feat, ind_code, device):
    """cond [1,128] and ind [1,16] rows, zero-padded, float32."""
    cond128 = torch.zeros((1, 128), dtype=torch.float32, device=device)
    cond128[:, :64] = cond_feat.reshape(1, 64).float()
    ind16 = torch.zeros((1, 16), dtype=torch.float32, device=device)
    if ind_code is not None and ind_code.numel() > 0:
        ind16[:, : ind_code.numel()] = ind_code.reshape(1, -1).float()
    return cond128, ind16


def bias_rows(cond_feat: torch.Tensor, ind_code, w: FieldWeights) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame constant terms as bias rows [128] f32: bf16(cond) . amb_w1's
    cond rows and bf16(ind) . col_w1's ind rows, rounded to bf16 as the JAX
    kernel rounds them. Computed once per frame, not per point."""
    cond128, ind16 = _cond_ind_rows(cond_feat, ind_code, w.amb_w1.device)
    amb_bias = (cond128.to(torch.bfloat16) @ w.amb_w1[256:]).float()
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


def _r(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back to float32."""
    return x.to(torch.bfloat16).float()


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


def fused_field_backward_plain(xyz, dirs, amb_bias, col_bias, w: FieldWeights,
                               g_sigma, g_rgb, g_amb, amb_dim: int = AMB_DIM):
    """Plain PyTorch version of the fused backward (`_bwd_kernel`'s explicit
    math, not autograd of `fused_field_plain`): recompute the forward, then
    backprop with bf16 rounding of every tensor-core input at the Pallas
    kernel's places, ReLU masks from the float32 activations, the fast
    sin/cos values as the Fourier derivatives and 1 - amb_pos^2 for tanh.

    g_sigma [N], g_rgb [N, 3], g_amb [N, amb_dim] f32. Returns the 14 f32
    gradient blocks of `_fused_backward`, in its order and padded shapes
    (see GRAD_BLOCKS)."""
    relu = torch.relu
    f = [t.float() for t in w]
    pos_B, amb_w1, amb_w2, amb_w3, amb_B, sig_w1, sig_w2, sig_w3, col_w1, col_w2 = f
    xyz, dirs = xyz.float(), dirs.float()
    dev = xyz.device

    # ---- forward recompute ----
    proj = project(xyz, pos_B[:3])
    sin_p, cos_p = fast_sin(proj), fast_cos(proj)
    pos_feat = _r(torch.cat([sin_p, cos_p], dim=-1))
    a1 = relu(pos_feat @ amb_w1[:256] + amb_bias)
    a1b = _r(a1)
    a2 = relu(a1b @ amb_w2)
    a2b = _r(a2)
    amb_pos = fast_tanh(a2b @ amb_w3[:, :amb_dim])
    aproj = project(amb_pos, amb_B[:amb_dim])
    sin_a, cos_a = fast_sin(aproj), fast_cos(aproj)
    amb_feat = _r(torch.cat([sin_a, cos_a], dim=-1))
    s1 = relu(pos_feat @ sig_w1[:256] + amb_feat @ sig_w1[256:384])
    s1b = _r(s1)
    s2 = relu(s1b @ sig_w2)
    s2b = _r(s2)
    sig_out = s2b @ sig_w3[:, :129]
    sig_logit = sig_out[:, 0]
    sigma = torch.exp(torch.clamp(sig_logit, -15.0, 15.0))
    geo = _r(sig_out[:, 1:129])
    sh = _r(_sh16(dirs))
    c1 = relu(sh @ col_w1[:16] + geo @ col_w1[16:144] + col_bias)
    c1b = _r(c1)
    rgb = 1.0 / (1.0 + torch.exp(-(c1b @ col_w2[:, :3])))

    def padded(live, shape):
        out = torch.zeros(shape, dtype=torch.float32, device=dev)
        out[: live.shape[0], : live.shape[1]] = live
        return out

    # ---- backward ----
    g_rgb_logit = _r(g_rgb.float() * rgb * (1.0 - rgb))
    g_col_w2 = padded(c1b.t() @ g_rgb_logit, (128, 128))
    g_c1 = _r((g_rgb_logit @ col_w2[:, :3].t()) * (c1 > 0.0))
    g_col_w1s = sh.t() @ g_c1
    g_col_w1g = geo.t() @ g_c1
    g_col_bias = padded(g_c1.sum(0, keepdim=True), (8, 128))
    g_geo = g_c1 @ col_w1[16:144].t()

    in_range = (sig_logit > -15.0) & (sig_logit < 15.0)
    g_sig0 = torch.where(in_range, g_sigma.float() * sigma, torch.zeros_like(sigma))
    g_sig_out = _r(torch.cat([g_sig0[:, None], g_geo], dim=-1))  # [N, 129]
    g_sig_w3 = padded(s2b.t() @ g_sig_out, (128, 256))
    g_s2 = _r((g_sig_out @ sig_w3[:, :129].t()) * (s2 > 0.0))
    g_sig_w2 = s1b.t() @ g_s2
    g_s1 = _r((g_s2 @ sig_w2.t()) * (s1 > 0.0))
    g_sig_w1p = pos_feat.t() @ g_s1
    g_sig_w1a = amb_feat.t() @ g_s1
    g_pos_feat_s = g_s1 @ sig_w1[:256].t()
    g_amb_feat = g_s1 @ sig_w1[256:384].t()

    g_aproj = g_amb_feat[:, :64] * cos_a - g_amb_feat[:, 64:] * sin_a
    g_amb_B = padded(_r(amb_pos).t() @ _r(g_aproj), (128, 64))
    g_amb_pos = _r(g_aproj) @ _r(amb_B[:amb_dim]).t() + g_amb.float()
    g_amb_logit = _r(g_amb_pos * (1.0 - amb_pos * amb_pos))
    g_amb_w3 = padded(a2b.t() @ g_amb_logit, (128, 128))
    g_a2 = _r((g_amb_logit @ amb_w3[:, :amb_dim].t()) * (a2 > 0.0))
    g_amb_w2 = a1b.t() @ g_a2
    g_a1 = _r((g_a2 @ amb_w2.t()) * (a1 > 0.0))
    g_amb_w1p = pos_feat.t() @ g_a1
    g_amb_bias = padded(g_a1.sum(0, keepdim=True), (8, 128))
    g_pos_feat = g_pos_feat_s + g_a1 @ amb_w1[:256].t()

    g_proj = g_pos_feat[:, :128] * cos_p - g_pos_feat[:, 128:] * sin_p
    g_pos_B = padded(_r(xyz).t() @ _r(g_proj), (8, 128))
    return (g_pos_B, g_amb_w1p, g_amb_bias, g_amb_w2, g_amb_w3, g_amb_B,
            g_sig_w1p, g_sig_w1a, g_sig_w2, g_sig_w3, g_col_w1s, g_col_w1g,
            g_col_bias, g_col_w2)


# ---------------------------------------------------------------------------
# The forward kernel's packed weights
# ---------------------------------------------------------------------------

def pack_kmajor(x: torch.Tensor) -> torch.Tensor:
    """[R, K] (R rows of a wgmma operand, K contiguous; R % 8 == 0, K % 16
    == 0) -> flat, in csrc/sm90.cuh's layout: k16 step s is a block of R x
    16 values in which the 8 x 8 core matrix (row group j, k half h) sits at
    (2 j + h) x 64 values, its rows 8 values apart."""
    R, K = x.shape
    return x.reshape(R // 8, 8, K // 16, 2, 8).permute(2, 0, 3, 1, 4).contiguous().flatten()


def pack_field_weights(w: FieldWeights) -> torch.Tensor:
    """The forward kernel's weight stream (FWD_LAYERS), bf16, flat, on w's
    device: only the blocks the kernel reads, and zeros where a block is
    wider than its live columns."""
    with torch.no_grad():
        def cols(x, live, n):  # the first `live` columns, zero-padded to n, as [n, K]
            return F.pad(x[:, :live], (0, n - live)).t()

        operands = {
            "amb_w1": w.amb_w1[:256].t(), "amb_w2": w.amb_w2.t(), "amb_w3": cols(w.amb_w3, AMB_DIM, 8),
            "sig_w1": w.sig_w1.t(), "sig_w2": w.sig_w2.t(),
            "sig_w3": torch.cat([w.sig_w3[:, 1:129], cols(w.sig_w3, 1, 8).t()], dim=1).t(),
            "col_w1": w.col_w1[:144].t(), "col_w2": cols(w.col_w2, 3, 8),
        }
        parts = []
        for name, n, k, _ in FWD_LAYERS:
            x = operands[name]
            assert tuple(x.shape) == (n, k), (name, tuple(x.shape))
            parts.append(pack_kmajor(x.to(torch.bfloat16)))
        return torch.cat(parts)


_PACKED = WeakIdKeyDictionary()  # w.amb_w1 -> (weakrefs to w's tensors, versions, packed)


def packed_weights(w: FieldWeights) -> torch.Tensor:
    """`pack_field_weights(w)`, cached per FieldWeights (the same tensors,
    unmodified since: in-place updates bump a tensor's version). Inference
    tensors (made under `torch.inference_mode`) keep no version counter, so
    for them only the tensors' identity is checked."""
    versions = tuple(None if t.is_inference() else t._version for t in w)
    hit = _PACKED.get(w.amb_w1)
    if hit is not None and hit[1] == versions and all(r() is t for r, t in zip(hit[0], w)):
        return hit[2]
    packed = pack_field_weights(w)
    _PACKED[w.amb_w1] = (tuple(weakref.ref(t) for t in w), versions, packed)
    return packed


# ---------------------------------------------------------------------------
# The CUDA kernels: build, load, launch
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
        "cannot build the fused-field kernels: nvcc not found (looked on PATH, "
        "$CUDA_HOME/bin, /usr/local/cuda/bin). The CUDA field needs the CUDA "
        "toolkit; CPU tensors take the plain versions instead.")


def _library_path(name: str) -> Path:
    """build/kernels/lib<name>-<key>.so, keyed by the hash of the source,
    the shared header and the flags (a changed source rebuilds)."""
    blob = SOURCES[name].read_bytes() + b"".join(h.read_bytes() for h in HEADERS)
    key = hashlib.sha256(blob + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build_kernels(names: Sequence[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Compile the named kernels into build/kernels/, one nvcc each, all
    started together. Returns {name: library path}; nvcc's -Xptxas -v report
    sits beside each library as `.log`."""
    out = {name: _library_path(name) for name in names}
    todo = [name for name in names if not out[name].exists()]
    if not todo:
        return out
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = out[name].with_name(f"{out[name].stem}.{os.getpid()}.tmp.so")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {SOURCES[name]} (rc {proc.returncode}):\n{stdout}\n{stderr}")
            continue
        out[name].with_suffix(".log").write_text(stdout + stderr)
        os.replace(tmp, out[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build_fused_field() -> Path:
    """Compile csrc/fused_field.cu (the forward); returns the library path."""
    return build_kernels(["fused_field"])["fused_field"]


def fwd_config(lib: ctypes.CDLL) -> Tuple[int, int, int]:
    """The built forward's (points per consumer tile, points per persistent
    block step, dynamic shared memory bytes per block)."""
    out = [ctypes.c_int() for _ in range(3)]
    lib.gfpp_fused_field_tile(*[ctypes.byref(v) for v in out])
    return tuple(v.value for v in out)


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_kernels([name])[name]))
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    if name == "fused_field":
        lib.gfpp_fused_field_forward.argtypes = [ptr, ptr, c_int] + [ptr] * 9
        lib.gfpp_fused_field_forward.restype = c_int
        lib.gfpp_fused_field_layout.argtypes = [ctypes.POINTER(c_int), c_int]
        lib.gfpp_fused_field_layout.restype = c_int
        lib.gfpp_fused_field_tile.argtypes = [ctypes.POINTER(c_int)] * 3
        lib.gfpp_fused_field_tile.restype = c_int
        spec = (ctypes.c_int * (3 * len(FWD_LAYERS)))()
        n = lib.gfpp_fused_field_layout(spec, len(FWD_LAYERS))
        if n != len(FWD_LAYERS) or list(spec) != [v for _, n_, k, c in FWD_LAYERS for v in (k // 16, n_, c)]:
            raise RuntimeError("csrc/fused_field.cu's weight stream differs from FWD_LAYERS")
        if fwd_config(lib)[:2] != (FWD_TILE, FWD_STEP):
            raise RuntimeError("csrc/fused_field.cu's tiles differ from FWD_TILE, FWD_STEP")
    else:
        lib.gfpp_fused_field_backward.argtypes = (
            [ptr, ptr, c_int] + [ptr] * 3 + [ptr] * 12 + [ptr, c_int, ptr, ptr])
        lib.gfpp_fused_field_backward.restype = c_int
        lib.gfpp_fused_field_bwd_packed_size.restype = c_int
        if lib.gfpp_fused_field_bwd_packed_size() != PACKED_SIZE:
            raise RuntimeError("csrc/fused_field_bwd.cu's packed gradient layout differs "
                               "from GRAD_BLOCKS")
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
        # the kernels load the bf16 weight matrices as WMMA fragments
        raise ValueError(f"fused_field: {name} must be 32-byte aligned")


def _check_cuda_inputs(xyz, dirs, amb_bias, col_bias, w: FieldWeights, amb_dim: int) -> int:
    """Validate what the kernels take; returns N."""
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
    return N


def _raise_on(lib, rc: int, what: str):
    if rc != 0:
        msg = lib.gfpp_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} ({msg})")


def _weight_ptrs(w: FieldWeights):
    return [getattr(w, name).data_ptr() for name in FIELD_SHAPES]


def fused_field(xyz, dirs, amb_bias, col_bias, w: FieldWeights, amb_dim: int = AMB_DIM):
    """The fused field: CUDA kernel for CUDA tensors, `fused_field_plain`
    for CPU tensors. Same contract as `fused_field_plain`.

    `fused_field.launches` counts kernel launches (plain calls do not count)."""
    if xyz.device.type == "cpu":
        return fused_field_plain(xyz, dirs, amb_bias, col_bias, w, amb_dim)
    if xyz.device.type != "cuda":
        raise ValueError(f"fused_field: unsupported device {xyz.device}")
    N = _check_cuda_inputs(xyz, dirs, amb_bias, col_bias, w, amb_dim)
    dev = xyz.device
    sigma = torch.empty((N,), dtype=torch.float32, device=dev)
    rgb = torch.empty((N, 3), dtype=torch.float32, device=dev)
    amb = torch.empty((N, AMB_DIM), dtype=torch.float32, device=dev)
    if N == 0:
        return sigma, rgb, amb
    lib = _library("fused_field")
    packed = packed_weights(w)
    with torch.cuda.device(dev):  # the launch goes to the current device
        rc = lib.gfpp_fused_field_forward(
            xyz.data_ptr(), dirs.data_ptr(), N, packed.data_ptr(), w.pos_B.data_ptr(),
            w.amb_B.data_ptr(), amb_bias.data_ptr(), col_bias.data_ptr(), sigma.data_ptr(),
            rgb.data_ptr(), amb.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc, "fused_field")
    fused_field.launches += 1
    return sigma, rgb, amb


fused_field.launches = 0


def unpack_grads(packed: torch.Tensor):
    """The kernel's packed live regions -> the 14 padded gradient blocks."""
    out, off = [], 0
    for _, shape, (r, c) in GRAD_BLOCKS:
        g = torch.zeros(shape, dtype=torch.float32, device=packed.device)
        g[:r, :c] = packed[off: off + r * c].view(r, c)
        out.append(g)
        off += r * c
    return tuple(out)


def fused_field_backward(xyz, dirs, amb_bias, col_bias, w: FieldWeights,
                         g_sigma, g_rgb, g_amb, amb_dim: int = AMB_DIM):
    """The fused backward: CUDA kernel for CUDA tensors,
    `fused_field_backward_plain` for CPU tensors. Same contract.

    The kernel gives the same gradients run to run on one card (a fixed
    grid of one block per SM, partials summed in block order).
    `fused_field_backward.launches` counts kernel launches."""
    if xyz.device.type == "cpu":
        return fused_field_backward_plain(xyz, dirs, amb_bias, col_bias, w,
                                          g_sigma, g_rgb, g_amb, amb_dim)
    if xyz.device.type != "cuda":
        raise ValueError(f"fused_field: unsupported device {xyz.device}")
    N = _check_cuda_inputs(xyz, dirs, amb_bias, col_bias, w, amb_dim)
    dev = xyz.device
    _check("g_sigma", g_sigma, (N,), torch.float32, dev)
    _check("g_rgb", g_rgb, (N, 3), torch.float32, dev)
    _check("g_amb", g_amb, (N, AMB_DIM), torch.float32, dev)
    if N == 0:
        return unpack_grads(torch.zeros((PACKED_SIZE,), dtype=torch.float32, device=dev))
    lib = _library("fused_field_bwd")
    nblocks = min(-(-N // 64), torch.cuda.get_device_properties(dev).multi_processor_count)
    partial = torch.empty((nblocks, PACKED_SIZE), dtype=torch.float32, device=dev)
    packed = torch.empty((PACKED_SIZE,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.gfpp_fused_field_backward(
            xyz.data_ptr(), dirs.data_ptr(), N, g_sigma.data_ptr(), g_rgb.data_ptr(),
            g_amb.data_ptr(), *_weight_ptrs(w), amb_bias.data_ptr(), col_bias.data_ptr(),
            partial.data_ptr(), nblocks, packed.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc, "fused_field_backward")
    fused_field_backward.launches += 1
    return unpack_grads(packed)


fused_field_backward.launches = 0


class _FusedFieldTrain(torch.autograd.Function):
    """The JAX custom VJP (`_make_fused_field_train`): forward `fused_field`,
    backward `fused_field_backward`; gradients to cond_feat, ind_code and
    every `FieldWeights` matrix, none to xyz/dirs (they come from the
    marcher and are not optimised)."""

    @staticmethod
    def forward(ctx, xyz, dirs, cond_feat, ind_code, amb_dim, *weights):
        w = FieldWeights(*weights)
        amb_bias, col_bias = bias_rows(cond_feat, ind_code, w)
        ctx.amb_dim = amb_dim
        ctx.save_for_backward(xyz, dirs, cond_feat, ind_code, *weights)
        return fused_field(xyz, dirs, amb_bias, col_bias, w, amb_dim)

    @staticmethod
    def backward(ctx, g_sigma, g_rgb, g_amb):
        xyz, dirs, cond_feat, ind_code, *weights = ctx.saved_tensors
        w = FieldWeights(*weights)
        amb_dim = ctx.amb_dim
        N = xyz.shape[0]

        def out_grad(g, shape):
            return torch.zeros(shape, dtype=torch.float32, device=xyz.device) if g is None \
                else g.float().contiguous()

        amb_bias, col_bias = bias_rows(cond_feat, ind_code, w)
        (g_pos_B, g_amb_w1p, g_amb_bias8, g_amb_w2, g_amb_w3, g_amb_B,
         g_sig_w1p, g_sig_w1a, g_sig_w2, g_sig_w3,
         g_col_w1s, g_col_w1g, g_col_bias8, g_col_w2) = fused_field_backward(
            xyz, dirs, amb_bias, col_bias, w, out_grad(g_sigma, (N,)),
            out_grad(g_rgb, (N, 3)), out_grad(g_amb, (N, amb_dim)), amb_dim)
        g_amb_bias, g_col_bias = g_amb_bias8[0:1], g_col_bias8[0:1]

        cond128, ind16 = _cond_ind_rows(cond_feat, ind_code, xyz.device)
        g_cond = (g_amb_bias @ w.amb_w1[256:].float().t())[0, :64]
        g_cond = g_cond.reshape(cond_feat.shape).to(cond_feat.dtype)
        ind_dim = ind_code.numel() if ind_code is not None else 0
        g_ind = None
        if ind_code is not None:
            g_ind = (g_col_bias @ w.col_w1[144:160].float().t())[0, :ind_dim]
            g_ind = g_ind.reshape(ind_code.shape).to(ind_code.dtype)

        # the bias gradients also flow into the cond/ind rows of the packed w1s
        g_amb_w1 = torch.cat([g_amb_w1p, cond128.t() @ g_amb_bias], dim=0)
        g_sig_w1 = torch.cat([g_sig_w1p, g_sig_w1a], dim=0)
        g_col_w1 = torch.cat([g_col_w1s, g_col_w1g, ind16.t() @ g_col_bias,
                              torch.zeros((w.col_w1.shape[0] - 160, 128), device=xyz.device)], dim=0)
        g_w = FieldWeights(g_pos_B, g_amb_w1, g_amb_w2, g_amb_w3, g_amb_B,
                           g_sig_w1, g_sig_w2, g_sig_w3, g_col_w1, g_col_w2)
        # each weight's dtype, as the JAX VJP casts them (bf16 MLP matrices)
        g_w = [g.to(t.dtype) for g, t in zip(g_w, weights)]
        return (None, None, g_cond, g_ind, None, *g_w)


def fused_field_train(xyz, dirs, cond_feat, ind_code: Optional[torch.Tensor],
                      weights: FieldWeights, amb_dim: int = AMB_DIM):
    """Differentiable fused field (forward and backward kernels on the card,
    their plain versions on the CPU). Same outputs as `fused_field`; grads
    flow to cond_feat, ind_code and all FieldWeights (the packed w1 grads
    include the cond/ind rows). xyz and dirs get no gradient."""
    return _FusedFieldTrain.apply(xyz.detach(), dirs.detach(), cond_feat, ind_code, amb_dim, *weights)
