#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on an NVIDIA GPU.

Run from the repository root, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):
  build       compile genefaceplusplus_tpu_torch/csrc/fused_field.cu,
              fused_field_bwd.cu and fused_field_wgrad.cu into build/kernels/
              (three nvcc, in parallel); print each ptxas report (0 spills)
  kernel      the fused-field forward kernel vs its plain PyTorch version and
              vs the float32 model field, at the 512^2 x 10-sample serving
              size (2,621,440 points), with seeded weights and inputs; timed
              in turns with the plain version, against its bound, beside
              its ptxas report
  kernel_bwd  the fused-field backward (tile chain + weight-gradient kernel)
              vs its plain PyTorch version at the training size (65,536 rays
              x 16 samples = 1,048,576 points), all 14 gradient blocks,
              twice (bit-identical), on permuted points; the weight-gradient
              kernel vs its plain version on the chain's operands; the chain,
              the weight-gradient kernel and the whole backward each timed in
              turns with its plain version, and bf16 torch.matmul on the
              same operands beside the weight-gradient kernel
  serve       GeneFaceInfer at the May lm3d_radnerf head config (full width,
              random weights from a seed) on a synthetic 512^2 identity with the
              bench's head-sized occupancy: GT-driven requests through
              prepare_gt_batch -> forward_secc2video, checked and timed
  serve_full  GeneFaceInfer at the May lm3d_radnerf_torso_sr configuration (the
              lm3d_radnerf_sr head at 256^2, the torso field, bf16 2x SR to
              512^2; random weights from seeds, SR noise strengths non-zero) on
              a synthetic 512^2 identity loaded with_sr, with the bench's head
              occupancy and torso grid: GT-driven requests, checked against the
              plain field, against the float32 SR with the crops off, and bf16
              against float32 SR; timed per frame and per stage
  serve_audio serve_full's configuration plus the full-width May audio-to-motion
              model (PitchContourVAEModel, seeded weights, non-zero flow
              `post` convs and BatchNorm statistics): 4 requests of 4 s of
              features (seeded HuBERT, f0 from extract_f0 on a gliding tone)
              through prepare_batch_from_inp -> forward_audio2secc ->
              forward_secc2video, 100 frames each; checked (frames, condition,
              B1 launches, the a2m on the card vs the CPU, one frame vs the
              plain field) and timed (a2m, audio2secc, LLE, time to first
              frame, per frame)
  train       HeadNeRFTask + Trainer.fit at the same config with
              use_fused_field=True on a synthetic 512^2 identity: 20 steps of
              65,536 rays x 16 samples, grid refreshes at steps 0 and 16,
              validation, a checkpoint and a resume; checked and timed

Output: the card's name and power limit first; one JSON line
{"kernels": [...]} before the last; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero before printing either.
"""

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SIZE = 512  # the product's frame, rendered directly by the non-SR head stage
N_POINTS = SIZE * SIZE * 10  # one frame at the production 10 samples per ray
N_REQUESTS, FRAMES_PER_REQUEST = 4, 8
GRID = 128

# kernel vs plain: two bf16 chains that differ only in float32 summation
# order; a flipped bf16 rounding of one activation moves that point's
# outputs by a few bf16 steps, so the max is loose and the mean is tight
# (a wrong weight, rounding point or index would move the mean far more)
KERNEL_MAX = {"log_sigma": 0.3, "rgb": 0.08, "amb": 0.02}
KERNEL_MEAN = {"log_sigma": 5e-4, "rgb": 1e-4, "amb": 1e-5}
# kernel vs the float32 model field: tests/test_fused_field.py's bounds
FIELD_MAX = {"log_sigma": 0.3, "rgb": 0.08, "amb": 0.05}
FIELD_MIN_CORR = 0.98
PLAIN_FRAME_MIN_PSNR = 40.0  # dB, kernel frame vs plain-field frame (uint8)
# the full frame: the crops are lossless (tests/test_full_renderer.py's bound
# for SR crop vs full), and bf16 SR agrees with float32 SR as JAX's does
# (tests/test_superresolution.py)
CROP_MAX_ABS = 2e-5
SR_BF16_MIN_PSNR = 35.0  # dB, relative to the float32 frame's range

# audio-driven serving: 4 requests of 4 s (200 HuBERT frames at 50 Hz ->
# 100 motion frames -> 100 full frames each). The a2m on the card against
# the same module on the CPU, same weights and draw: float32 convolutions
# with TF32 off on both, measured on an H100 at 2.35e-6 of outputs up to
# 1.89 (this script; tests/test_torch_cuda.py with the TF32 flag on:
# 2.27e-6); held to the port's float32 tolerance
N_AUDIO_REQUESTS, AUDIO_SECONDS, HUBERT_FRAMES = 4, 4.0, 200
A2M_CARD_MAX = 1e-4
# the condition pipeline on the card against the CPU, from the same a2m
# output: the bounds of tests/test_torch_audio_drive.py (cond after the
# stored-std normalisation; lm68 relative to max(1, |value|))
COND_CARD_MAX, LM68_CARD_REL = 1e-4, 1e-3

N_RAYS, TRAIN_SAMPLES = 65536, 16  # egs/egs_bases/radnerf/base.yaml
N_TRAIN_POINTS = N_RAYS * TRAIN_SAMPLES
TRAIN_STEPS = 20  # grid refreshes at steps 0 and 16 (update_extra_interval 16)
# backward kernel vs plain, every gradient block: (min cosine, max |norm
# ratio - 1|, max |d| / max |plain|), over two sets of points.
# All points: the kernel recomputes the forward on the tensor cores, whose
# float32 sums round differently from the plain version's float32 matmuls;
# on about 13 % of the points some bf16 activation ends up rounded the
# other way (their forward outputs move by more than FWD_CLEAN), which
# moves that point's whole gradient. Measured at 65,537 and 262,144 points
# over six seeds: cosine >= 0.99724, |ratio - 1| <= 0.026, max |d| <= 0.084.
BWD_ALL = (0.995, 0.04, 0.15)
# Clean points, whose forward outputs (log sigma, rgb, ambient) from the
# forward kernel agree with the plain forward to FWD_CLEAN: only the
# backward's own bf16 roundings can differ. Measured at the same sizes:
# cosine >= 0.999997, |ratio - 1| <= 9e-4, max |d| <= 0.0056. A wrong
# weight, index, mask or rounding point moves these far more.
FWD_CLEAN = 3e-5
BWD_CLEAN = (0.9999, 0.005, 0.03)
BWD_PERMUTED_MAX_REL = 1e-4  # kernel on permuted points vs kernel: float32 summation order only

# bounds: the function's bf16 multiply-adds a point, at their live widths
# (no padding a kernel adds), at the H100's dense bf16 peak, against the
# bytes each point moves at its HBM rate. The float32 Fourier projections
# (3 x 128 + 3 x 64 multiply-adds a point) run beside them on the CUDA cores.
PEAK_BF16_FLOPS, HBM_BYTES_PER_S = 989e12, 3.35e12
AMB_OUT = 3
# (K, N) of the eight forward products: amb_w1..3, sig_w1 (pos_feat |
# amb_feat), sig_w2, sig_w3 (sigma + geo), col_w1 (SH | geo), col_w2
FWD_PRODUCTS = ((256, 128), (128, 128), (128, AMB_OUT), (384, 128), (128, 128), (128, 129), (144, 128), (128, 3))
FWD_MACS = sum(k * n for k, n in FWD_PRODUCTS)  # 150,400
# the backward: the forward recomputed; the weight gradient of each product,
# of pos_B (3 x 128) and of amb_B (3 x 64); the input gradient of each
# product but SH's rows of col_w1, and of amb_B (64 -> 3)
BWD_MACS = FWD_MACS + (FWD_MACS + 3 * 128 + 3 * 64) + (FWD_MACS - 16 * 128 + 64 * AMB_OUT)  # 449,920
FWD_BYTES, BWD_BYTES = 52, 52  # xyz, dirs in + sigma, rgb, amb out; xyz, dirs, three output grads in
# B2's tile chain alone: the forward recomputed and the input gradients, and
# the bf16 weight-gradient operands it must write (2,168 a point, as stored)
CHAIN_MACS = FWD_MACS + (FWD_MACS - 16 * 128 + 64 * AMB_OUT)  # 298,944
CHAIN_BYTES = BWD_BYTES + 2 * 2168
# the weight-gradient kernel: the weight gradients of the eight products and
# of pos_B and amb_B, against its operands read once at their live widths
# (2,141 bf16 a point; the buffer stores 2,168 with padding)
WGRAD_MACS = FWD_MACS + 3 * 128 + 3 * 64  # 150,976
WGRAD_BYTES = 2 * 2141
# weight-gradient kernel vs its plain version on the same operands: both
# float32 sums of the same bf16 products, in other orders, the kernel's
# through the tensor cores' float32 accumulation (8,192-point chunks, then
# across chunks). Measured on an H100 (tests/test_torch_cuda.py::
# test_wgrad_kernel_matches_plain, 1 to 1,146,957 points): 1.28e-5 to
# 1.43e-5 of the block's largest entry, whatever the number of points; on
# the chain's operands at 1,048,576 points (this script): 1.13e-5
WGRAD_MAX_REL = 5e-5


def kernel_bound(n: int, macs: int, point_bytes: int, fixed_bytes: int = 0):
    """(bound ms, "operations" or "bytes") for n points."""
    ops_ms = 2.0 * macs * n / PEAK_BF16_FLOPS * 1e3
    bytes_ms = (point_bytes * n + fixed_bytes) / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def card_line() -> str:
    if shutil.which("nvidia-smi"):
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip()
        return out.splitlines()[0]
    return torch.cuda.get_device_name(0)


def check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def head_config():
    from genefaceplusplus_tpu_torch.models.radnerf import MAY_LM3D_RADNERF, RADNeRFConfig

    return RADNeRFConfig.from_hparams(MAY_LM3D_RADNERF)


def sr_head_config():
    from genefaceplusplus_tpu_torch.models.radnerf import MAY_LM3D_RADNERF_SR, RADNeRFConfig

    return RADNeRFConfig.from_hparams(MAY_LM3D_RADNERF_SR)


def torso_config():
    from genefaceplusplus_tpu_torch.models.radnerf import MAY_LM3D_RADNERF_TORSO_SR
    from genefaceplusplus_tpu_torch.models.radnerf_torso import TorsoConfig

    return TorsoConfig.from_hparams(MAY_LM3D_RADNERF_TORSO_SR)


def bench_torso_grid(grid: int) -> np.ndarray:
    """The bench's torso footprint (bench.py): the lower 55 % of the rows and
    the centre 70 % of the columns, as a trained identity's 2D grid holds."""
    occ2d = np.zeros((grid, grid), np.float32)
    occ2d[int(0.45 * grid):, int(0.15 * grid):int(0.85 * grid)] = 0.5
    return occ2d


def psnr(a, ref, peak: float) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(ref, np.float64)) ** 2))
    return math.inf if mse == 0 else 10.0 * math.log10(peak ** 2 / mse)


def bench_occupancy(grid: int = GRID) -> np.ndarray:
    """The bench's head-sized occupancy (bench.py): an ellipsoid spanning
    about half the frame."""
    xx, yy, zz = np.meshgrid(*([np.linspace(-1, 1, grid)] * 3), indexing="ij")
    return (xx ** 2 + (2.2 * yy) ** 2 + (1.4 * zz) ** 2) < 0.16


def cuda_event():
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def cuda_ms(fn, reps: int) -> list:
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def errors(a, b):
    """(max, mean) |a - b| per output; sigma compared in log space."""
    out = {}
    for name, x, y in (("log_sigma", a[0].log(), b[0].log()), ("rgb", a[1], b[1]), ("amb", a[2], b[2])):
        e = (x - y).abs()
        out[name] = (e.max().item(), e.mean().item())
    return out


def ptxas_report(lib) -> list:
    """The -Xptxas -v lines of a built kernel library: entries, registers,
    shared memory, spills."""
    return [line.strip() for line in lib.with_suffix(".log").read_text().splitlines()
            if "registers" in line or "spill" in line or "Compiling entry" in line]


def phase_build():
    from genefaceplusplus_tpu_torch.ops import fused_field as ff

    t0 = time.perf_counter()
    libs = ff.build_kernels()
    print(f"[build] {len(libs)} kernels in {time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        print(f"[build] {name}: {lib.relative_to(os.getcwd()) if lib.is_relative_to(os.getcwd()) else lib}")
        for line in ptxas_report(lib):
            print(f"[build] {name} ptxas: {line}")
        spills = [int(v) for x in ptxas_report(lib) for v in re.findall(r"(\d+) bytes spill", x)]
        check(not any(spills), f"{name} spills registers")


def phase_kernel(dev):
    from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF
    from genefaceplusplus_tpu_torch.ops import fused_field as ff

    cfg = head_config()
    model = RADNeRF(cfg, generator=torch.Generator().manual_seed(0)).to(dev).eval()
    w = ff.weights_from_params(model, bound=cfg.bound)
    g = torch.Generator(device=dev).manual_seed(1)
    xyz = torch.rand((N_POINTS, 3), generator=g, device=dev) * 2.0 - 1.0
    dirs = torch.randn((N_POINTS, 3), generator=g, device=dev)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    cond = torch.randn((cfg.smo_win_size, cfg.cond_win_size, cfg.cond_in_dim), generator=g, device=dev)
    with torch.no_grad():
        cond_feat = model.cal_cond_feat(cond, torch.full((1, 1), 0.3, device=dev))
        ind = model.get_individual_code(0)
        ab, cb = ff.bias_rows(cond_feat, ind, w)
        kern = ff.fused_field(xyz, dirs, ab, cb, w)
        plain = ff.fused_field_plain(xyz, dirs, ab, cb, w)
        torch.cuda.synchronize()
        for out in (kern, plain):
            check(all(bool(torch.isfinite(t).all()) for t in out), "non-finite field output")
        e = errors(kern, plain)
        for k in KERNEL_MAX:
            print(f"[kernel] vs plain {k}: max {e[k][0]:.6g} (<= {KERNEL_MAX[k]}), "
                  f"mean {e[k][1]:.6g} (<= {KERNEL_MEAN[k]})")
            check(e[k][0] <= KERNEL_MAX[k] and e[k][1] <= KERNEL_MEAN[k], f"kernel vs plain {k}")

        # bf16 vs float32 differs by rounding, whose largest excursion grows
        # with the number of points: the max bounds hold at the size
        # test_fused_field.py sets them for (300 points), the same bounds
        # hold the 99.9th percentile over all points
        ref = model.field(xyz, dirs, cond_feat, ind)
        kern_l = (kern[0] + 1e-6).log(), kern[1], kern[2]
        ref_l = (ref[0] + 1e-6).log(), ref[1], ref[2]
        for (k, bound), a, b in zip(FIELD_MAX.items(), kern_l, ref_l):
            err = (a - b).abs().flatten()
            head, p999 = err[:300].max().item(), torch.quantile(err, 0.999).item()
            print(f"[kernel] vs f32 field {k}: first 300 max {head:.6g}, all p99.9 {p999:.6g} "
                  f"(both <= {bound}); all max {err.max().item():.6g}, mean {err.mean().item():.6g}")
            check(head <= bound and p999 <= bound, f"kernel vs f32 field {k}")
        for name, i in (("rgb", 1), ("amb", 2)):
            corr = torch.corrcoef(torch.stack([kern[i].flatten(), ref[i].flatten()]))[0, 1].item()
            print(f"[kernel] vs f32 field {name}: correlation {corr:.6f} (> {FIELD_MIN_CORR})")
            check(corr > FIELD_MIN_CORR, f"kernel vs f32 field {name} correlation")
        del ref

        def run_kernel():
            ff.fused_field(xyz, dirs, ab, cb, w)

        def run_plain():
            ff.fused_field_plain(xyz, dirs, ab, cb, w)

        for fn in (run_plain, run_kernel):
            cuda_ms(fn, 2)  # warm-up
        t_k, t_p = [], []
        for _ in range(4):  # in turns: plain, kernel, kernel, plain
            t_p += cuda_ms(run_plain, 1)
            t_k += cuda_ms(run_kernel, 2)
            t_p += cuda_ms(run_plain, 1)
    ms, plain_ms = statistics.median(t_k), statistics.median(t_p)
    bound_ms, bound_by = kernel_bound(N_POINTS, FWD_MACS, FWD_BYTES)
    tile, step, smem = ff.fwd_config(ff._library("fused_field"))
    print(f"[kernel] {card_line()}; ptxas: " + "; ".join(
        x for x in ptxas_report(ff.build_kernels(["fused_field"])["fused_field"]) if "Compiling" not in x)
          + f"; {smem} bytes of dynamic shared memory a block; {tile} points a consumer tile, {step} a block step")
    print(f"[kernel] time at {N_POINTS} points: kernel median {ms:.4f} ms "
          f"(min {min(t_k):.4f}, max {max(t_k):.4f}, n={len(t_k)}); plain median "
          f"{plain_ms:.4f} ms (min {min(t_p):.4f}, max {max(t_p):.4f}, n={len(t_p)})")
    print(f"[kernel] {2.0 * FWD_MACS * N_POINTS / ms / 1e9:.1f} TFLOP/s; bound {bound_ms:.4f} ms "
          f"({bound_by}): {100.0 * bound_ms / ms:.1f} % of the bound")
    return {"max_abs_err": max(e["rgb"][0], e["amb"][0]), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_serve(dev):
    from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset, synthetic
    from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer
    from genefaceplusplus_tpu_torch.models.full_renderer import render_full_frame
    from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF
    from genefaceplusplus_tpu_torch.ops import fused_field as ff
    from genefaceplusplus_tpu_torch.utils.audio_features import get_audio_features_batch
    from genefaceplusplus_tpu_torch.utils.rays import pixel_rays
    from genefaceplusplus_tpu_torch.utils.smoothing import mirror_index

    cfg = head_config()
    params = RADNeRF(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    ds = RADNeRFDataset(synthetic(num_frames=24, H=SIZE, W=SIZE, seed=0), smo_win_size=cfg.smo_win_size)
    infer = GeneFaceInfer(cfg, params, ds, bench_occupancy(cfg.grid_size), device=dev)
    H, W = ds.H, ds.W
    opts = infer.render_options({})
    rays = H * W if infer.head_crop is None else infer.head_crop[0] * infer.head_crop[1]
    print(f"[serve] {H}x{W}, grid {cfg.grid_size}, head_crop {infer.head_crop}, "
          f"{rays * opts.num_samples} field points per frame ({rays} rays x {opts.num_samples} samples)")
    bg_u8 = (np.clip(ds.bg_img, 0.0, 1.0) * 255.0).astype(np.uint8)

    requests = [[mirror_index(r * FRAMES_PER_REQUEST + i, len(ds)) for i in range(FRAMES_PER_REQUEST)]
                for r in range(N_REQUESTS)]
    frames_all, ms_per_frame = [], []
    torch.cuda.synchronize()
    ff.fused_field.launches = 0  # count only the main path's launches
    for ids in requests:
        batch = infer.prepare_gt_batch(ids)
        t0 = time.perf_counter()
        frames = list(infer.forward_secc2video(batch, {"frames_per_dispatch": 8}))
        ms_per_frame.append((time.perf_counter() - t0) * 1e3 / len(frames))
        frames_all.append(frames)
    launches = ff.fused_field.launches
    n_frames = sum(len(f) for f in frames_all)

    for ids, frames in zip(requests, frames_all):
        check(len(frames) == len(ids), "frame count")
        for f in frames:
            check(f.shape == (H, W, 3) and f.dtype == np.uint8, f"frame {f.shape} {f.dtype}")
            head = (np.abs(f.astype(np.int16) - bg_u8).max(axis=-1) > 8).mean()
            check(head > 0.02, f"head region missing: {head:.4f} of pixels differ from the background")
        check(any(not np.array_equal(frames[0], f) for f in frames[1:]), "frames do not vary")
    check(launches >= n_frames, f"fused_field launched {launches} times for {n_frames} frames")
    timed = ms_per_frame[1:]  # the first request includes one-time set-up
    print(f"[serve] {len(requests)} requests x {FRAMES_PER_REQUEST} frames: {launches} fused_field "
          f"launches for {n_frames} frames (one field call per frame)")
    print(f"[serve] per-frame time (request wall / frames, requests 2..{len(requests)}): median "
          f"{statistics.median(timed):.3f} ms, min {min(timed):.3f}, max {max(timed):.3f}; "
          f"first request {ms_per_frame[0]:.3f} ms/frame")

    # the first request's first frame again through the plain field
    batch = infer.prepare_gt_batch(requests[0])
    with torch.no_grad():
        ro, rd = pixel_rays(torch.as_tensor(batch["poses"][:1], device=dev), ds.intrinsics, H, W)
        conds = torch.as_tensor(batch["cond"], device=dev)
        win = get_audio_features_batch(conds, torch.arange(batch["T"], device=dev), cfg.smo_win_size)[0]
        eye = torch.as_tensor(batch["eye_area_percent"][:1], device=dev)
        out = render_full_frame(infer.head_model, ro[0], rd[0], win, infer.occupancy, infer.bg_color,
                                opts, (H, W), eye_area_percent=eye, head_crop=infer.head_crop,
                                field_weights=infer.field_weights, fused_fn=ff.fused_field_plain)
        plain = (torch.clamp(out.rgb_map, 0.0, 1.0) * 255.0).to(torch.uint8).reshape(H, W, 3).cpu().numpy()
    p_plain = psnr(plain, frames_all[0][0], 255.0)
    print(f"[serve] kernel frame vs plain-field frame: PSNR {p_plain:.2f} dB (>= {PLAIN_FRAME_MIN_PSNR}), "
          f"mean |d| {np.abs(plain.astype(np.int16) - frames_all[0][0]).mean():.5f}")
    check(p_plain >= PLAIN_FRAME_MIN_PSNR, "kernel frame vs plain-field frame")
    return launches


def stage_split(infer, dev, batch, frames: int) -> dict:
    """CUDA-event times of each stage of `frames` served frames (median, min,
    max ms): the head (condition + march + field + composite) until the torso
    field starts, the torso (field, 2D-occupancy mask, composite) until the
    SR starts, the SR (with its paste into SR(bg)), and the uint8 quantise
    and copy to the host. Events come from hooks on the torso and SR modules."""
    from genefaceplusplus_tpu_torch.utils.audio_features import get_audio_features_batch
    from genefaceplusplus_tpu_torch.utils.rays import pixel_rays

    H, W = infer.dataset.H, infer.dataset.W
    marks = {}

    def mark(name):
        def hook(*_):
            marks[name] = torch.cuda.Event(enable_timing=True)
            marks[name].record()
        return hook

    hooks = [infer.torso_model.register_forward_pre_hook(mark("torso")),
             infer.sr_model.register_forward_pre_hook(mark("sr"))]
    times = {k: [] for k in ("head", "torso", "sr", "quantise_copy", "frame")}
    try:
        with torch.no_grad():
            ro, rd = pixel_rays(torch.as_tensor(batch["poses"], device=dev), infer.dataset.intrinsics, H, W)
            conds = torch.as_tensor(batch["cond"], device=dev)
            wins = get_audio_features_batch(conds, torch.arange(batch["T"], device=dev), infer.head_cfg.smo_win_size)
            eyes = torch.as_tensor(batch["eye_area_percent"], device=dev)
            lm68 = torch.as_tensor(batch["lm68"], device=dev)
            for i in range(frames):
                torch.cuda.synchronize()
                start, done, copied = (torch.cuda.Event(enable_timing=True) for _ in range(3))
                start.record()
                out = infer.render_frame(ro[i], rd[i], wins[i], eyes[i], lm68[i][None])
                done.record()
                (torch.clamp(out.sr_rgb_map, 0.0, 1.0) * 255.0).to(torch.uint8).cpu()
                copied.record()
                torch.cuda.synchronize()
                times["head"].append(start.elapsed_time(marks["torso"]))
                times["torso"].append(marks["torso"].elapsed_time(marks["sr"]))
                times["sr"].append(marks["sr"].elapsed_time(done))
                times["quantise_copy"].append(done.elapsed_time(copied))
                times["frame"].append(start.elapsed_time(copied))
    finally:
        for h in hooks:
            h.remove()
    return {k: (statistics.median(v), min(v), max(v)) for k, v in times.items()}


def profile_request(infer, batch) -> tuple:
    """(device activities a frame, kernels a frame, device-busy ms a frame,
    the ten kernels with the most device time [(name, launches a frame, ms a
    frame)]) over one request under torch.profiler, busy being the union of
    the device activities' spans; Nones when the profiler shows no device
    activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        frames = list(infer.forward_secc2video(batch, {"frames_per_dispatch": 8}))
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev_events:
        return None, None, None, []
    kernels = [e for e in dev_events if not e.name.lower().startswith(("memcpy", "memset"))]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev_events)
    busy_us, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy_us += cur_e - cur_s
    n = len(frames)
    by_name = {}
    for e in kernels:
        c, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, t + e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    top = [(name[:70], c / n, t / 1e3 / n) for name, (c, t) in top]
    return len(dev_events) / n, len(kernels) / n, busy_us / 1e3 / n, top


def phase_serve_full(dev):
    from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset, synthetic
    from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer
    from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF
    from genefaceplusplus_tpu_torch.models.radnerf_torso import TorsoField
    from genefaceplusplus_tpu_torch.models.superresolution import Superresolution, SynthesisLayer
    from genefaceplusplus_tpu_torch.ops import fused_field as ff
    from genefaceplusplus_tpu_torch.utils.audio_features import get_audio_features_batch
    from genefaceplusplus_tpu_torch.utils.rays import pixel_rays
    from genefaceplusplus_tpu_torch.utils.smoothing import mirror_index

    cfg, tcfg = sr_head_config(), torso_config()
    params = RADNeRF(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    torso_params = TorsoField(tcfg, generator=torch.Generator().manual_seed(1)).state_dict()
    sr = Superresolution(3, 256, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():  # noise_strength initialises to 0: exercise the const noise
        for i, layer in enumerate(m for m in sr.modules() if isinstance(m, SynthesisLayer)):
            layer.noise_strength.fill_(0.1 + 0.05 * i)
    ds = RADNeRFDataset(synthetic(num_frames=24, H=SIZE, W=SIZE, seed=0), smo_win_size=cfg.smo_win_size,
                        with_sr=True)
    kw = dict(torso_cfg=tcfg, torso_params=torso_params, sr_params=sr.state_dict(),
              torso_occupancy_2d=bench_torso_grid(tcfg.grid_size))
    infer = GeneFaceInfer(cfg, params, ds, bench_occupancy(cfg.grid_size), device=dev, **kw)
    H, W = ds.H, ds.W
    opts = infer.render_options({})
    rays = H * W if infer.head_crop is None else infer.head_crop[0] * infer.head_crop[1]
    print(f"[serve_full] raw {H}x{W} -> SR {2 * H}x{2 * W} ({infer.sr_model.block0.dtype}), grid {cfg.grid_size}, "
          f"{rays * opts.num_samples} field points per frame ({rays} rays x {opts.num_samples} samples)")
    print(f"[serve_full] crops engaged: head_crop {infer.head_crop is not None} ({infer.head_crop}), "
          f"torso_crop {infer.torso_crop is not None} ({infer.torso_crop}), sr_crop "
          f"{infer.sr_crop is not None} ({infer.sr_crop})")

    requests = [[mirror_index(r * FRAMES_PER_REQUEST + i, len(ds)) for i in range(FRAMES_PER_REQUEST)]
                for r in range(N_REQUESTS)]
    frames_all, ms_per_frame = [], []
    torch.cuda.synchronize()
    ff.fused_field.launches = 0  # count only the main path's launches
    for ids in requests:
        batch = infer.prepare_gt_batch(ids)
        t0 = time.perf_counter()
        frames = list(infer.forward_secc2video(batch, {"frames_per_dispatch": 8}))
        ms_per_frame.append((time.perf_counter() - t0) * 1e3 / len(frames))
        frames_all.append(frames)
    launches = ff.fused_field.launches
    n_frames = sum(len(f) for f in frames_all)

    for ids, frames in zip(requests, frames_all):
        check(len(frames) == len(ids), "frame count")
        for f in frames:
            check(f.shape == (2 * H, 2 * W, 3) and f.dtype == np.uint8, f"frame {f.shape} {f.dtype}")
        check(any(not np.array_equal(frames[0], f) for f in frames[1:]), "frames do not vary")
    check(launches >= n_frames, f"fused_field launched {launches} times for {n_frames} frames")
    timed = ms_per_frame[1:]  # the first request includes one-time set-up
    print(f"[serve_full] {len(requests)} requests x {FRAMES_PER_REQUEST} frames of {2 * H}x{2 * W}: {launches} "
          f"fused_field launches for {n_frames} frames")
    print(f"[serve_full] per-frame time (request wall / frames, requests 2..{len(requests)}): median "
          f"{statistics.median(timed):.3f} ms, min {min(timed):.3f}, max {max(timed):.3f}; first request "
          f"{ms_per_frame[0]:.3f} ms/frame")

    # the first request's first frame again: through the plain field; with
    # float32 SR, crops on and off; bf16 against float32 SR
    batch = infer.prepare_gt_batch(requests[0])
    infer32 = GeneFaceInfer(cfg, params, ds, bench_occupancy(cfg.grid_size), device=dev, sr_dtype=torch.float32,
                            **kw)
    with torch.no_grad():
        ro, rd = pixel_rays(torch.as_tensor(batch["poses"][:1], device=dev), ds.intrinsics, H, W)
        conds = torch.as_tensor(batch["cond"], device=dev)
        win = get_audio_features_batch(conds, torch.arange(batch["T"], device=dev), cfg.smo_win_size)[0]
        eye = torch.as_tensor(batch["eye_area_percent"][:1], device=dev)
        lm68 = torch.as_tensor(batch["lm68"][:1], device=dev)
        args = (ro[0], rd[0], win, eye, lm68)
        plain = infer.render_frame(*args, fused_fn=ff.fused_field_plain).sr_rgb_map
        plain = (torch.clamp(plain, 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()
        bf16 = infer.render_frame(*args).sr_rgb_map.cpu().numpy()
        f32_on = infer32.render_frame(*args).sr_rgb_map.cpu().numpy()
        f32_off = infer32.render_frame(*args, inp={"torso_crop": "off", "sr_crop": "off"}).sr_rgb_map.cpu().numpy()
    p_plain = psnr(plain, frames_all[0][0], 255.0)
    print(f"[serve_full] kernel frame vs plain-field frame: PSNR {p_plain:.2f} dB (>= {PLAIN_FRAME_MIN_PSNR}), "
          f"mean |d| {np.abs(plain.astype(np.int16) - frames_all[0][0]).mean():.5f}")
    check(p_plain >= PLAIN_FRAME_MIN_PSNR, "kernel frame vs plain-field frame")
    crop_err = float(np.abs(f32_on - f32_off).max())
    print(f"[serve_full] float32 SR, crops on (torso {infer32.torso_crop}, sr {infer32.sr_crop}) vs off: max |d| "
          f"{crop_err:.3e} (<= {CROP_MAX_ABS})")
    check(crop_err <= CROP_MAX_ABS, "crops on vs off")
    p_bf16 = psnr(bf16, f32_on, float(np.ptp(f32_on)))
    print(f"[serve_full] bf16 SR vs float32 SR: PSNR {p_bf16:.2f} dB (> {SR_BF16_MIN_PSNR}), max |d| "
          f"{np.abs(bf16 - f32_on).max():.4f}")
    check(p_bf16 > SR_BF16_MIN_PSNR, "bf16 SR vs float32 SR")
    del infer32

    split = stage_split(infer, dev, infer.prepare_gt_batch(requests[1]), FRAMES_PER_REQUEST)
    print(f"[serve_full] {card_line()}; stage split by CUDA events over {FRAMES_PER_REQUEST} frames (median, "
          "min, max ms): " + "; ".join(f"{k} {v[0]:.3f} ({v[1]:.3f}, {v[2]:.3f})" for k, v in split.items()))
    per_frame, kernels, busy, top = profile_request(infer, infer.prepare_gt_batch(requests[2]))
    if per_frame is None:
        print("[serve_full] profiler: no device activity recorded; launches a frame and the idle share "
              "not measured")
    else:
        served = statistics.median(timed)
        print(f"[serve_full] profiler over one request of {FRAMES_PER_REQUEST} frames: {per_frame:.1f} device "
              f"activities a frame ({kernels:.1f} kernels), device busy {busy:.3f} ms a frame; against the "
              f"{served:.3f} ms served frame without the profiler the device is idle "
              f"{100.0 * (1.0 - busy / served):.1f} %")
        for name, count, ms in top:
            print(f"[serve_full] profiler top kernel: {ms:.4f} ms a frame in {count:.1f} launches: {name}")
    return launches


def a2m_hparams() -> dict:
    from genefaceplusplus_tpu_torch.models.audio2motion.vae_model import MAY_AUDIO2MOTION_VAE

    return dict(MAY_AUDIO2MOTION_VAE)


def seeded_a2m_params(hp: dict, seed: int) -> dict:
    """The a2m's state_dict from `seed`: flax-style init, then every `post`
    conv of the prior flow (zero at init: the identity flow) and every
    BatchNorm's running statistics (0 and 1 at init) drawn non-trivial."""
    from genefaceplusplus_tpu_torch.models.audio2motion.vae_model import a2m_model_from_hparams

    model = a2m_model_from_hparams(hp, generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, m in model.named_modules():
            if name.endswith(".post"):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) * 0.05)
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.05)
            elif isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.1)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return model.state_dict()


def voiced_wav(seconds: float, f_start: float, f_end: float, seed: int) -> np.ndarray:
    """A harmonic tone at 16 kHz whose pitch glides from f_start to f_end Hz,
    with a little seeded noise."""
    t = np.arange(int(seconds * 16000)) / 16000.0
    phase = 2.0 * np.pi * np.cumsum(f_start + (f_end - f_start) * t / seconds) / 16000.0
    wav = 0.3 * sum(np.sin(k * phase) / k for k in (1, 2, 3))
    return (wav + 0.003 * np.random.RandomState(seed).randn(len(t))).astype(np.float32)


def phase_serve_audio(dev):
    import tempfile

    from genefaceplusplus_tpu_torch.data.audio import extract_f0
    from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset, synthetic
    from genefaceplusplus_tpu_torch.inference import pipeline
    from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer, default_inp
    from genefaceplusplus_tpu_torch.models.audio2motion.vae_model import a2m_batch, a2m_model_from_hparams
    from genefaceplusplus_tpu_torch.models.postnet import lle
    from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF
    from genefaceplusplus_tpu_torch.models.radnerf_torso import TorsoField
    from genefaceplusplus_tpu_torch.models.superresolution import Superresolution, SynthesisLayer
    from genefaceplusplus_tpu_torch.ops import fused_field as ff
    from genefaceplusplus_tpu_torch.utils.audio_features import get_audio_features_batch
    from genefaceplusplus_tpu_torch.utils.rays import pixel_rays

    cfg, tcfg, hp = sr_head_config(), torso_config(), a2m_hparams()
    params = RADNeRF(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    torso_params = TorsoField(tcfg, generator=torch.Generator().manual_seed(1)).state_dict()
    sr = Superresolution(3, 256, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        for i, layer in enumerate(m for m in sr.modules() if isinstance(m, SynthesisLayer)):
            layer.noise_strength.fill_(0.1 + 0.05 * i)
    a2m_params = seeded_a2m_params(hp, 3)
    ds = RADNeRFDataset(synthetic(num_frames=24, H=SIZE, W=SIZE, seed=0), smo_win_size=cfg.smo_win_size,
                        with_sr=True)
    infer = GeneFaceInfer(cfg, params, ds, bench_occupancy(cfg.grid_size), device=dev, torso_cfg=tcfg,
                          torso_params=torso_params, sr_params=sr.state_dict(),
                          torso_occupancy_2d=bench_torso_grid(tcfg.grid_size), a2m_hparams=hp,
                          a2m_params=a2m_params)
    H, W = ds.H, ds.W
    n_a2m = sum(t.numel() for k, t in a2m_params.items() if not k.endswith("num_batches_tracked"))
    print(f"[serve_audio] a2m {type(infer.a2m_model).__name__}, {n_a2m} variables; {N_AUDIO_REQUESTS} requests "
          f"of {AUDIO_SECONDS} s ({HUBERT_FRAMES} HuBERT frames x 1024 at 50 Hz, f0 from extract_f0 on a "
          f"gliding harmonic tone); frames {2 * H}x{2 * W} as serve_full")

    # host-wall time of each LLE call and of its two steps (neighbours; the
    # batched solve), synchronised (measuring shims)
    lle_ms, knn_ms, solve_ms = [], [], []
    plain_fns = {(pipeline, "compute_lle_projection"): (pipeline.compute_lle_projection, lle_ms),
                 (lle, "find_k_nearest_neighbors"): (lle.find_k_nearest_neighbors, knn_ms),
                 (lle, "solve_lle_projection_batch"): (lle.solve_lle_projection_batch, solve_ms)}

    def timed(fn, into):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            into.append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    a2m_events = []
    hooks = [infer.a2m_model.register_forward_pre_hook(lambda *_: a2m_events.append([cuda_event()])),
             infer.a2m_model.register_forward_hook(lambda *_: a2m_events[-1].append(cuda_event()))]
    work = tempfile.mkdtemp(prefix="chip_smoke_audio_")
    batches, frames_all, cond_ms, ttff_ms, frame_ms = [], [], [], [], []
    try:
        paths = []
        for r in range(N_AUDIO_REQUESTS):
            rs = np.random.RandomState(100 + r)
            wav = voiced_wav(AUDIO_SECONDS, 110.0 + 20 * r, 180.0 + 25 * r, seed=r)
            feats = {"hubert": rs.randn(HUBERT_FRAMES, 1024).astype(np.float32),
                     "f0": extract_f0(wav, mel_len=HUBERT_FRAMES)}
            paths.append(os.path.join(work, f"request{r}.npy"))
            np.save(paths[-1], feats, allow_pickle=True)
        for (mod, name), (fn, into) in plain_fns.items():
            setattr(mod, name, timed(fn, into))
        torch.cuda.synchronize()
        ff.fused_field.launches = 0  # count only the main path's launches
        for path in paths:
            inp = default_inp(drv_aud_features=path, frames_per_dispatch=8)
            t0 = time.perf_counter()
            batch = infer.forward_audio2secc(infer.prepare_batch_from_inp(inp), inp)
            t_cond = time.perf_counter()
            video = infer.forward_secc2video(batch, inp)
            frames = [next(video)]
            t_first = time.perf_counter()
            frames += list(video)
            t_end = time.perf_counter()
            cond_ms.append((t_cond - t0) * 1e3)
            ttff_ms.append((t_first - t0) * 1e3)
            frame_ms.append((t_end - t_cond) * 1e3 / len(frames))
            batches.append(batch)
            frames_all.append(frames)
        launches = ff.fused_field.launches
    finally:
        for (mod, name), (fn, _) in plain_fns.items():
            setattr(mod, name, fn)
        for h in hooks:
            h.remove()
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.synchronize()
    a2m_ms = [s.elapsed_time(e) for s, e in a2m_events]
    n_frames = sum(len(f) for f in frames_all)

    for batch, frames in zip(batches, frames_all):
        T = batch["T"]
        check(T == HUBERT_FRAMES // 2 and len(frames) == T, f"{len(frames)} frames for a motion of {T}")
        check(np.isfinite(batch["cond"]).all() and batch["cond"].shape == (T, 1, 204), "condition")
        check(np.isfinite(batch["lm68"]).all() and batch["lm68"].shape == (T, 68, 2), "torso landmarks")
        for f in frames:
            check(f.shape == (2 * H, 2 * W, 3) and f.dtype == np.uint8, f"frame {f.shape} {f.dtype}")
        check(any(not np.array_equal(frames[0], f) for f in frames[1:]), "frames do not vary")
    check(np.ptp(batches[0]["cond"], axis=0).max() > 0, "the condition does not vary over the request")
    check(launches >= n_frames, f"fused_field launched {launches} times for {n_frames} frames")
    print(f"[serve_audio] {N_AUDIO_REQUESTS} requests, {n_frames} frames of {2 * H}x{2 * W}: {launches} "
          f"fused_field launches; conditions finite; blinks in request 1 at eye areas "
          f"{batches[0]['eye_area_percent'].min():.4f}-{batches[0]['eye_area_percent'].max():.4f}")

    # the first request's a2m on the card against the same module on the CPU,
    # with the same weights and the same draw
    b0 = batches[0]
    cpu_model = a2m_model_from_hparams(hp)
    cpu_model.load_state_dict(a2m_params)
    with torch.no_grad():
        ref, _ = cpu_model.eval()(a2m_batch(b0["hubert"], b0["f0"], 0.4, "cpu"), train=False, temperature=0.2,
                                  noise=torch.from_numpy(b0["a2m_noise"]))
    ref = ref[0].numpy()
    a2m_err = float(np.abs(b0["a2m_out"] - ref).max())
    print(f"[serve_audio] a2m on the card vs the CPU (request 1, same weights and draw): max |d| {a2m_err:.3e} "
          f"(<= {A2M_CARD_MAX}) on outputs up to {np.abs(ref).max():.4f}")
    check(a2m_err <= A2M_CARD_MAX, "a2m on the card vs the CPU")

    # the rest of request 1's condition pipeline (3DMM algebra, LLE, torso
    # landmarks) again on the CPU, from the card's own a2m output
    class ReplayA2M(torch.nn.Module):
        def forward(self, *_, **__):
            return torch.from_numpy(b0["a2m_out"])[None], None

    cpu_infer = GeneFaceInfer(cfg, params, ds, bench_occupancy(cfg.grid_size), device="cpu", a2m_hparams=hp,
                              a2m_params=a2m_params)
    cpu_infer.a2m_model = ReplayA2M()
    keys = ("hubert", "f0", "wav16k", "T", "pose_idx", "poses", "eulers", "transs")
    cpu_b0 = cpu_infer.forward_audio2secc({k: b0[k] for k in keys}, default_inp(frames_per_dispatch=8),
                                          noise=torch.from_numpy(b0["a2m_noise"]))
    cond_err = float(np.abs(b0["cond"] - cpu_b0["cond"]).max())
    lm_err = np.abs(b0["lm68"].astype(np.float64) - cpu_b0["lm68"])
    lm_rel = float((lm_err / np.maximum(1.0, np.abs(cpu_b0["lm68"]))).max())
    print(f"[serve_audio] condition pipeline on the card vs the CPU (request 1, from the card's a2m output): "
          f"cond max |d| {cond_err:.3e} (<= {COND_CARD_MAX}); lm68 max |d| / max(1, |v|) {lm_rel:.3e} "
          f"(<= {LM68_CARD_REL}); eye areas equal: {np.array_equal(b0['eye_area_percent'], cpu_b0['eye_area_percent'])}")
    check(cond_err <= COND_CARD_MAX, "condition on the card vs the CPU")
    check(lm_rel <= LM68_CARD_REL, "torso landmarks on the card vs the CPU")
    check(np.array_equal(b0["eye_area_percent"], cpu_b0["eye_area_percent"]), "eye areas on the card vs the CPU")

    # the first audio-driven frame again, through the plain field
    with torch.no_grad():
        ro, rd = pixel_rays(torch.as_tensor(b0["poses"][:1], dtype=torch.float32, device=dev), ds.intrinsics, H, W)
        conds = torch.as_tensor(b0["cond"], device=dev)
        win = get_audio_features_batch(conds, torch.arange(b0["T"], device=dev), cfg.smo_win_size)[0]
        eye = torch.as_tensor(b0["eye_area_percent"][:1], device=dev)
        lm68 = torch.as_tensor(b0["lm68"][:1], device=dev)
        plain = infer.render_frame(ro[0], rd[0], win, eye, lm68, fused_fn=ff.fused_field_plain).sr_rgb_map
        plain = (torch.clamp(plain, 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()
    p_plain = psnr(plain, frames_all[0][0], 255.0)
    print(f"[serve_audio] audio-driven frame, kernel vs plain field: PSNR {p_plain:.2f} dB (>= "
          f"{PLAIN_FRAME_MIN_PSNR}), mean |d| {np.abs(plain.astype(np.int16) - frames_all[0][0]).mean():.5f}")
    check(p_plain >= PLAIN_FRAME_MIN_PSNR, "audio-driven kernel frame vs plain-field frame")

    def spread(v):
        return f"median {statistics.median(v):.3f} ms, min {min(v):.3f}, max {max(v):.3f}"

    card = card_line()
    print(f"[serve_audio] {card}; per request (1 first, 2..{N_AUDIO_REQUESTS} after): a2m by CUDA "
          f"events {', '.join(f'{x:.3f}' for x in a2m_ms)} ms; audio2secc host wall (features in -> "
          f"condition out, a2m included) {', '.join(f'{x:.3f}' for x in cond_ms)} ms; LLE host wall "
          f"(synchronised) {', '.join(f'{x:.3f}' for x in lle_ms)} ms, of which the neighbours "
          f"{', '.join(f'{x:.3f}' for x in knn_ms)} ms and the batched solve "
          f"{', '.join(f'{x:.3f}' for x in solve_ms)} ms")
    print(f"[serve_audio] {card}; time to first frame (features in -> first uint8 frame out of "
          f"forward_secc2video, one chunk of 8 frames): {', '.join(f'{x:.3f}' for x in ttff_ms)} ms")
    print(f"[serve_audio] {card}; per-frame time (forward_secc2video wall / frames, requests "
          f"2..{N_AUDIO_REQUESTS}): {spread(frame_ms[1:])}; first request {frame_ms[0]:.3f} ms/frame")
    return launches


def grad_stats(a, b):
    """(cosine, norm ratio, max |a - b| / max |b|) of two gradient blocks."""
    a, b = a.double().flatten(), b.double().flatten()
    na, nb = a.norm().item(), b.norm().item()
    if nb == 0.0:  # e.g. no point in the set
        return (1.0, 1.0, 0.0) if na == 0.0 else (0.0, math.inf, math.inf)
    cos = (a @ b).item() / max(na * nb, 1e-300)
    return cos, na / nb, (a - b).abs().max().item() / b.abs().max().item()


def backward_vs_plain(xyz, dirs, ab, cb, w, g_sigma, g_rgb, g_amb):
    """The backward kernel against its plain version over all points and
    over the clean points (FWD_CLEAN). Returns ({"all": stats, "clean":
    stats}, number of clean points), stats = [(block, cos, ratio, rel)]."""
    from genefaceplusplus_tpu_torch.ops import fused_field as ff

    fk, fp = ff.fused_field(xyz, dirs, ab, cb, w), ff.fused_field_plain(xyz, dirs, ab, cb, w)
    moved = torch.stack([(fk[0].log() - fp[0].log()).abs(), (fk[1] - fp[1]).abs().amax(-1),
                         (fk[2] - fp[2]).abs().amax(-1)], -1).amax(-1)
    clean = (moved <= FWD_CLEAN).nonzero().flatten()
    out = {}
    for key, sel in (("all", slice(None)), ("clean", clean)):
        x, d, gs, gr, ga = (t[sel].contiguous() for t in (xyz, dirs, g_sigma, g_rgb, g_amb))
        k = ff.fused_field_backward(x, d, ab, cb, w, gs, gr, ga)
        p = ff.fused_field_backward_plain(x, d, ab, cb, w, gs, gr, ga)
        check(all(bool(torch.isfinite(t).all()) for t in k), "non-finite backward gradient")
        out[key] = [(name, *grad_stats(a, b)) for (name, _, _), a, b in zip(ff.GRAD_BLOCKS, k, p)]
    return out, clean.numel()


def bwd_failures(stats) -> list:
    """Blocks outside BWD_ALL / BWD_CLEAN."""
    bad = []
    for key, (min_cos, max_dev, max_rel) in (("all", BWD_ALL), ("clean", BWD_CLEAN)):
        bad += [(key, name) for name, cos, ratio, rel in stats[key]
                if not (cos >= min_cos and abs(ratio - 1.0) <= max_dev and rel <= max_rel)]
    return bad


def phase_kernel_bwd(dev):
    from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF
    from genefaceplusplus_tpu_torch.ops import fused_field as ff

    cfg = head_config()
    model = RADNeRF(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    w = ff.weights_from_params(model, bound=cfg.bound)
    g = torch.Generator(device=dev).manual_seed(2)
    n = N_TRAIN_POINTS
    xyz = torch.rand((n, 3), generator=g, device=dev) * 2.0 - 1.0
    dirs = torch.randn((n, 3), generator=g, device=dev)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    g_sigma = torch.randn((n,), generator=g, device=dev) * 1e-2
    g_rgb = torch.randn((n, 3), generator=g, device=dev) * 1e-2
    g_amb = torch.randn((n, 3), generator=g, device=dev) * 1e-2
    cond = torch.randn((cfg.smo_win_size, cfg.cond_win_size, cfg.cond_in_dim), generator=g, device=dev)
    with torch.no_grad():
        cond_feat = model.cal_cond_feat(cond, torch.full((1, 1), 0.3, device=dev))
        ab, cb = ff.bias_rows(cond_feat, model.get_individual_code(0), w)
        args = (xyz, dirs, ab, cb, w, g_sigma, g_rgb, g_amb)
        kern = ff.fused_field_backward(*args)
        again = ff.fused_field_backward(*args)
        perm = torch.randperm(n, generator=g, device=dev)
        permuted = ff.fused_field_backward(*(t[perm].contiguous() for t in args[:2]), ab, cb, w,
                                           *(t[perm].contiguous() for t in args[5:]))
        plain = ff.fused_field_backward_plain(*args)
        stats, n_clean = backward_vs_plain(*args)
        torch.cuda.synchronize()
    worst = 0.0
    for (name, _, _), k, k2, kp, p in zip(ff.GRAD_BLOCKS, kern, again, permuted, plain):
        check(bool(torch.isfinite(k).all()), f"non-finite backward {name}")
        check(torch.equal(k, k2), f"backward {name} differs between two launches")
        check(grad_stats(kp, k)[2] <= BWD_PERMUTED_MAX_REL, f"backward {name} depends on the point order")
        worst = max(worst, (k - p).abs().max().item())
    print(f"[kernel_bwd] {n_clean} of {n} points clean (forward outputs within {FWD_CLEAN} of the plain "
          f"forward); bounds (cos, |r-1|, max|d|/max): all points {BWD_ALL}, clean points {BWD_CLEAN}")
    for (name, *s_all), (_, *s_clean) in zip(stats["all"], stats["clean"]):
        print(f"[kernel_bwd] {name:9s} all: cos {s_all[0]:.8f}, norm ratio {s_all[1]:.8f}, max|d|/max "
              f"{s_all[2]:.3e}; clean: cos {s_clean[0]:.8f}, norm ratio {s_clean[1]:.8f}, max|d|/max "
              f"{s_clean[2]:.3e}")
    bad = bwd_failures(stats)
    check(not bad, f"backward kernel vs plain: {bad}")
    print(f"[kernel_bwd] two launches: bit-identical gradients; permuted points: every block within "
          f"{BWD_PERMUTED_MAX_REL} of its largest entry")
    del kern, again, permuted, plain

    with torch.no_grad():
        # the weight-gradient kernel alone, on the chain's operands
        ops = ff.fused_field_bwd_chain(*args)
        unpacked = ff.unpack_operands(ops, n)
        wk, wp = ff.fused_field_wgrad(ops, n), ff.fused_field_wgrad_plain(unpacked)
        torch.cuda.synchronize()
        wgrad_err, wgrad_rel = 0.0, 0.0
        for (name, _, _), a, b in zip(ff.GRAD_BLOCKS, wk, wp):
            check(bool(torch.isfinite(a).all()), f"non-finite weight gradient {name}")
            d = (a - b).abs().max().item()
            rel = d / max(b.abs().max().item(), 1e-30)
            wgrad_err, wgrad_rel = max(wgrad_err, d), max(wgrad_rel, rel)
            check(rel <= WGRAD_MAX_REL, f"weight-gradient kernel vs plain {name}: {rel:.3e}")
        print(f"[kernel_bwd] weight-gradient kernel vs plain on the chain's operands: every block within "
              f"{wgrad_rel:.3e} of its largest entry (<= {WGRAD_MAX_REL}); operand buffer "
              f"{ops.numel() * 2 / 2 ** 30:.3f} GiB")
        del wk, wp

        # bf16 torch.matmul on the same operands (timed only; the port never calls it)
        X = torch.cat([unpacked[k] for k in ("x0", "x1", "x2", "x3", "xa")], dim=1)
        gc1 = torch.cat([unpacked["gc1a"], unpacked["gc1b"]], dim=1)
        u = unpacked

        def run_library():
            return (X.t() @ u["gs1"], X[:, :256].t() @ u["ga1"], u["a1"].t() @ u["ga2"],
                    u["s1"].t() @ u["gs2"], u["s2"].t() @ u["gsig"], u["g"].t() @ gc1,
                    u["a2"].t() @ u["gamb"], u["c1"].t() @ u["grgb"], u["apos"].t() @ u["gaproj"],
                    u["xyzb"].t() @ u["gproj"], u["ga1"].float().sum(0), gc1.float().sum(0))

        timings = {
            "chain": (lambda: ff.fused_field_bwd_chain(*args),
                      lambda: ff.pack_operands(ff.fused_field_bwd_operands_plain(*args))),
            "wgrad": (lambda: ff.fused_field_wgrad(ops, n), lambda: ff.fused_field_wgrad_plain(unpacked)),
            "backward": (lambda: ff.fused_field_backward(*args), lambda: ff.fused_field_backward_plain(*args)),
        }
        times = {}
        for key, (run_kernel, run_plain) in timings.items():
            for fn in (run_plain, run_kernel):
                cuda_ms(fn, 2)  # warm-up
            t_k, t_p = [], []
            for _ in range(3):  # in turns: plain, kernel, kernel, plain
                t_p += cuda_ms(run_plain, 1)
                t_k += cuda_ms(run_kernel, 2)
                t_p += cuda_ms(run_plain, 1)
            times[key] = (t_k, t_p)
        cuda_ms(run_library, 2)
        t_lib = []
        for _ in range(3):  # in turns with the kernel
            t_lib += cuda_ms(run_library, 1)
            times["wgrad"][0].extend(cuda_ms(timings["wgrad"][0], 1))
        del ops, unpacked, X, gc1, u
    print(f"[kernel_bwd] {card_line()}; times at {n} points, medians in turns with the plain versions:")
    for key, (t_k, t_p) in times.items():
        print(f"[kernel_bwd] {key}: kernel {statistics.median(t_k):.4f} ms (min {min(t_k):.4f}, max "
              f"{max(t_k):.4f}, n={len(t_k)}); plain {statistics.median(t_p):.4f} ms (min {min(t_p):.4f}, "
              f"max {max(t_p):.4f}, n={len(t_p)})")
    ms, plain_ms = statistics.median(times["backward"][0]), statistics.median(times["backward"][1])
    bound_ms, bound_by = kernel_bound(n, BWD_MACS, BWD_BYTES, 4 * ff.PACKED_SIZE)
    w_ms, w_plain_ms = statistics.median(times["wgrad"][0]), statistics.median(times["wgrad"][1])
    w_bound_ms, w_bound_by = kernel_bound(n, WGRAD_MACS, WGRAD_BYTES, 4 * ff.PACKED_SIZE)
    library_ms = statistics.median(t_lib)
    print(f"[kernel_bwd] backward bound {bound_ms:.4f} ms ({bound_by}): {100.0 * bound_ms / ms:.1f} % of the bound")
    c_ms = statistics.median(times["chain"][0])
    c_bound_ms, c_bound_by = kernel_bound(n, CHAIN_MACS, CHAIN_BYTES, 4 * ff.PACKED_SIZE)
    print(f"[kernel_bwd] chain bound {c_bound_ms:.4f} ms ({c_bound_by}; operations "
          f"{kernel_bound(n, CHAIN_MACS, 0)[0]:.4f} ms): {100.0 * c_bound_ms / c_ms:.1f} % of the bound")
    print(f"[kernel_bwd] weight-gradient kernel bound {w_bound_ms:.4f} ms ({w_bound_by}): "
          f"{100.0 * w_bound_ms / w_ms:.1f} % of the bound; bf16 torch.matmul on the same operands "
          f"{library_ms:.4f} ms (min {min(t_lib):.4f}, max {max(t_lib):.4f}, n={len(t_lib)})")
    return ({"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by},
            {"max_abs_err": wgrad_err, "ms": w_ms, "plain_ms": w_plain_ms, "bound_ms": w_bound_ms,
             "bound_by": w_bound_by, "library_ms": library_ms})


def phase_train(dev):
    import tempfile

    from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset, synthetic
    from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF
    from genefaceplusplus_tpu_torch.ops import fused_field as ff
    from genefaceplusplus_tpu_torch.training.tasks.head_task import HeadNeRFTask, HeadTaskConfig
    from genefaceplusplus_tpu_torch.training.trainer import Trainer

    cfg = head_config()
    ds = RADNeRFDataset(synthetic(num_frames=24, H=SIZE, W=SIZE, seed=0), smo_win_size=cfg.smo_win_size)
    task_cfg = HeadTaskConfig(n_rays=N_RAYS, num_samples=TRAIN_SAMPLES, max_steps=16,
                              update_extra_interval=16, lr=5e-4, use_fused_field=True)
    task = HeadNeRFTask(ds, cfg, task_cfg, seed=9999, device=dev)
    init = {k: v.detach().clone() for k, v in task.create_state().model.named_parameters()}
    print(f"[train] {SIZE}x{SIZE} synthetic identity, {len(ds)} train frames, {N_RAYS} rays x "
          f"{TRAIN_SAMPLES} samples = {N_TRAIN_POINTS} field points per step, grid {cfg.grid_size}")

    step_ms, losses, occ = [], [], []
    train_step, refresh = task.train_step, task.update_extra_state

    def timed_step(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["total_loss"]))
        return state, metrics

    def recorded_refresh(state):
        before = (task.occupancy.clone(), task.density_grid.clone())
        refresh(state)
        occ.append((before, (task.occupancy.clone(), task.density_grid.clone())))

    task.train_step, task.update_extra_state = timed_step, recorded_refresh
    work_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ff.fused_field.launches = ff.fused_field_bwd_chain.launches = ff.fused_field_wgrad.launches = 0
        ff.fused_field_backward.launches = 0  # the backward wrapper's calls (it launches nothing itself)
        trainer = Trainer(task, work_dir, max_updates=TRAIN_STEPS, val_check_interval=1000,
                          tb_log_interval=10, update_extra_interval=task_cfg.update_extra_interval)
        state = trainer.fit()
        torch.cuda.synchronize()
        fwd, chain, wgrad = ff.fused_field.launches, ff.fused_field_bwd_chain.launches, ff.fused_field_wgrad.launches
        bwd_calls = ff.fused_field_backward.launches
        peak = torch.cuda.max_memory_allocated(dev)

        check(len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses),
              f"train losses not all finite: {losses}")
        check(fwd == TRAIN_STEPS and chain == TRAIN_STEPS and wgrad == TRAIN_STEPS,
              f"{fwd} forward, {chain} backward-chain and {wgrad} weight-gradient kernel launches for "
              f"{TRAIN_STEPS} train steps")
        check(bwd_calls == TRAIN_STEPS, f"{bwd_calls} fused_field_backward calls for {TRAIN_STEPS} train steps")
        moved = {k: (v - init[k]).abs().max().item() for k, v in state.model.named_parameters()}
        for k in ("position_embedder.B", "ambient_embedder.B"):
            check(moved[k] > 0, f"{k} did not move")
        check(all(v > 0 for k, v in moved.items() if k.startswith(("ambient_net", "sigma_net", "color_net"))),
              "a field MLP parameter did not move")
        check(len(occ) == 2, f"{len(occ)} grid refreshes for {TRAIN_STEPS} steps")
        check(not torch.equal(occ[0][0][0], occ[0][1][0]), "the first refresh left the occupancy as it was")
        check(not torch.equal(occ[1][0][1], occ[1][1][1]), "the step-16 refresh left the density grid as it was")
        ckpts = sorted(f for f in os.listdir(work_dir) if f.endswith(".ckpt"))
        check(ckpts == [f"model_ckpt_steps_{TRAIN_STEPS}.ckpt"], f"checkpoints {ckpts}")
        resumed = Trainer(HeadNeRFTask(ds, cfg, task_cfg, seed=9999, device=dev), work_dir,
                          max_updates=TRAIN_STEPS + 2, val_check_interval=1000, tb_log_interval=10,
                          update_extra_interval=task_cfg.update_extra_interval).fit()
        check(resumed.global_step == TRAIN_STEPS + 2, f"resume reached step {resumed.global_step}")
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    timed = step_ms[1:]  # the first step includes one-time set-up
    print(f"[train] {TRAIN_STEPS} steps: losses finite ({losses[0]:.5f} -> {losses[-1]:.5f}); "
          f"{fwd} forward, {chain} backward-chain and {wgrad} weight-gradient kernel launches in "
          f"{bwd_calls} fused_field_backward calls (one each per step); occupancy "
          f"{occ[0][0][0].float().mean().item():.4f} -> {occ[0][1][0].float().mean().item():.4f} -> "
          f"{occ[1][1][0].float().mean().item():.4f} across the refreshes at steps 0 and 16; all field "
          f"parameters moved (position B by {moved['position_embedder.B']:.3e}, ambient B by "
          f"{moved['ambient_embedder.B']:.3e}); checkpoint written and resumed to step "
          f"{TRAIN_STEPS + 2}")
    print(f"[train] train step (host wall, synchronised, steps 2..{TRAIN_STEPS}): median "
          f"{statistics.median(timed):.3f} ms, min {min(timed):.3f}, max {max(timed):.3f}, n={len(timed)}; "
          f"first step {step_ms[0]:.3f} ms; peak allocated {peak / 2 ** 30:.3f} GiB")
    return fwd, chain, wgrad


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import genefaceplusplus_tpu_torch  # noqa: F401  (fails outside a checkout)

    # full float32 wherever a float32 product runs (the Fourier phase needs it)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    phase_build()
    k = phase_kernel(dev)
    kb, kw = phase_kernel_bwd(dev)
    serve_launches = phase_serve(dev)
    full_launches = phase_serve_full(dev)
    audio_launches = phase_serve_audio(dev)
    train_fwd, train_chain, train_wgrad = phase_train(dev)
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(f"[launches] fused_field: {serve_launches} head-only serving + {full_launches} full-frame serving + "
          f"{audio_launches} audio-driven serving + {train_fwd} training; "
          f"fused_field_bwd_chain: {train_chain} training; fused_field_wgrad: {train_wgrad} training")
    print(json.dumps({"kernels": [{
        "name": "fused_field", "route": "cuda",
        "source": "genefaceplusplus_tpu_torch/csrc/fused_field.cu",
        "replaces": "genefaceplusplus_tpu/ops/pallas/fused_field.py:156",
        "launches": serve_launches + full_launches + audio_launches + train_fwd, "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        "library_ms": None}, {
        # B2: launches of its source's kernel (the chain); times of the whole backward
        "name": "fused_field_backward", "route": "cuda",
        "source": "genefaceplusplus_tpu_torch/csrc/fused_field_bwd.cu",
        "replaces": "genefaceplusplus_tpu/ops/pallas/fused_field.py:278",
        "launches": train_chain, "max_abs_err": kb["max_abs_err"], "ms": kb["ms"],
        "plain_ms": kb["plain_ms"], "bound_ms": kb["bound_ms"], "bound_by": kb["bound_by"],
        "library_ms": None}, {  # no single PyTorch call computes the fused field or its backward
        "name": "fused_field_wgrad", "route": "cuda",
        "source": "genefaceplusplus_tpu_torch/csrc/fused_field_wgrad.cu",
        "replaces": "genefaceplusplus_tpu/ops/pallas/fused_field.py:347",
        "launches": train_wgrad, "max_abs_err": kw["max_abs_err"], "ms": kw["ms"],
        "plain_ms": kw["plain_ms"], "bound_ms": kw["bound_ms"], "bound_by": kw["bound_by"],
        "library_ms": kw["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
