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
  serve_cli   serve_audio's seeded weights written as three JAX-layout work
              dirs (a2m, head + SR, torso; flax msgpack checkpoints and the
              egs/datasets/May configs through the port's YAML writer) beside a
              synthetic 512^2 dataset; GeneFaceInfer.from_work_dirs checked
              bit for bit against the written tensors and a directly built
              GeneFaceInfer (grids, crops); the inference CLI on 4 s of
              features, its AVI read back (100 frames equal to the direct
              GeneFaceInfer's for the same draw, the PCM, one B1 launch a
              frame); stream_infer over 8 s in 2 s chunks (no drift, an exact
              resume tail); timed (load, CLI wall, time to first frame, ms a
              frame)
  serve_long  serve_cli's GeneFaceInfer: infer_once on 56 s of features, 1,400
              full frames at 512^2 with their audio, an AVI 2.0 (OpenDML) of
              1.10 GB in two RIFF segments; each rendered frame's sha256 held
              to the frame read back by data/video.py's read_avi, every sample
              to pcm16(wav16k), the segments and the dmlh total checked; ms a
              frame, the writer's and the reader's MB/s
  convert     a seeded fake of the reference's a2m checkpoint (legacy
              torch.save, its layout at full width) converted by
              tools/convert_ckpt.py and loaded on the card by from_work_dirs with
              serve_cli's torso dir: every a2m tensor equal to the mapping's, the
              temperature-0 a2m output held to the CPU's, 100 audio-driven frames
              served from it; timed (convert, load, serve)
  serve_app   inference/app.py's server on a loopback port over serve_cli's
              GeneFaceInfer: a raw-socket WebSocket client and a POST /stream
              (MJPEG) client each receive every frame of the 4 s request at
              temperature 0, each byte-equal to jpeg_bytes of a direct
              stream_infer's frame (a mismatch's decoded PSNR is printed
              before the check fails); GET /metrics parses, GET
              / is the form, POST /infer returns the AVI; time to first frame and
              frame cadence over both
  train      HeadNeRFTask + Trainer.fit at the same config with
              use_fused_field=True on a synthetic 512^2 identity: 20 steps of
              65,536 rays x 16 samples, grid refreshes at steps 0 and 16,
              validation, a checkpoint and a resume; checked and timed
  train_cli   the host image codec (csrc/image_codec.cpp, built here with the
              host compiler) decodes tests/torch_image_fixtures/ to the sha256
              of cv2's decodes recorded beside them, and its encoder's bytes
              for a seeded frame equal cv2.imencode's; then one identity in the
              binarizer's layout (16 synthetic 512^2 frames: gt as
              com_imgs/%08d.jpg written by the port's encoder at q95 4:2:0,
              head and torso as RGBA head_imgs/ and inpaint_torso_imgs/%08d.png;
              trainval_dataset.npy names the files and holds no image arrays;
              512^2 JPEG and PNG decode and JPEG encode timed, median of 24,
              and the frame store's load from the files) trained through the
              training CLI, each
              stage in a process of its own, 12 steps at the egs/datasets/May
              configs (their widths, 65,536-ray batches, full 256^2 frames):
              lm3d_radnerf (lip steps from step 5), lm3d_radnerf_sr (SR and
              perceptual terms from step 5; SIGTERM after step 4, exit 0 with a
              checkpoint, resumed to the end with every step logged once) and
              lm3d_radnerf_torso_sr from the SR dir; losses finite, checkpoints
              flax msgpack equal to the live state bit for bit, ms/step per
              stage; then GeneFaceInfer.from_work_dirs on the torso dir serves 8
              frames on the card (8 B1 launches) and its float32 frame is held
              to the CPU's
  train_audio an identity's tracks (1,000 motion frames at 25 fps: seeded
              HuBERT, a voiced f0 contour, exp and idexp_lm3d smooth in time)
              as trainval_dataset.npy; the training CLI trains the a2m
              (egs/datasets/May/audio2motion_vae.yaml, full width, 11,840,768
              variables, batch 8 x 64 frames; SIGTERM after step 20, exit 0 with
              a checkpoint, resumed) and then the postnet
              (egs/datasets/May/postnet.yaml, batch 4), 60 steps each with
              validation at 30 and 60, each in a process of its own with
              cuDNN's TF32 flag at the process default; losses finite, checkpoints
              flax msgpack equal to the live state bit for bit, every step logged
              once; one a2m and one postnet step on the card vs the CPU from the
              trained state with the TF32 flag on (losses 1e-5 relative, every
              updated tensor 1e-5 of its largest entry); then 2 requests of 4 s
              served from the trained a2m + postnet dirs with seeded head + SR
              and torso dirs (one B1 launch a frame), request 1's condition
              rerun on the CPU from the card's a2m output through the postnet;
              timed (ms/step, peak memory, the postnet by CUDA events,
              audio2secc with and without it, ms a frame)

Output: the card's name and power limit first; before serve_cli, whether
an `ffmpeg` binary is on the PATH (shutil.which); one JSON line
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
import socket
import statistics
import subprocess
import sys
import tempfile
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
# serve_cli: the stream's length and chunk (2 s of audio = 48 motion frames
# after the multiple-of-8 trim)
STREAM_SECONDS, STREAM_CHUNK_SECONDS = 8.0, 2.0
A2M_CARD_MAX = 1e-4
# the condition pipeline on the card against the CPU, from the same a2m
# output: the bounds of tests/test_torch_audio_drive.py (cond after the
# stored-std normalisation; lm68 relative to max(1, |value|))
COND_CARD_MAX, LM68_CARD_REL = 1e-4, 1e-3
# serve_long: a clip past AVI 1.0's 1 GiB, 56 s of the 512^2 full frame with
# its audio (1,102,894,194 bytes, two RIFF segments)
LONG_FRAMES = 1400

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


def profile_device(run) -> tuple:
    """(device activities a unit, kernels a unit, device-busy ms a unit, the
    ten kernels with the most device time [(name, launches a unit, ms a
    unit)]) over `run()` under torch.profiler, which returns the number of
    units it did (frames, steps); busy is the union of the device
    activities' spans. A `record_function` range (the optimizer's step) also
    shows on the device's timeline, spanning its kernels and the gaps
    between them: it is no activity of its own and is left out. Nones when
    the profiler shows no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        n = run()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False) and not e.name.startswith("Optimizer.")]
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
    by_name = {}
    for e in kernels:
        c, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, t + e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    top = [(name[:70], c / n, t / 1e3 / n) for name, (c, t) in top]
    return len(dev_events) / n, len(kernels) / n, busy_us / 1e3 / n, top


def profile_request(infer, batch) -> tuple:
    """`profile_device` a frame over one request."""
    return profile_device(lambda: len(list(infer.forward_secc2video(batch, {"frames_per_dispatch": 8}))))


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


def seeded_audio_models(cfg, tcfg, hp) -> dict:
    """serve_audio's seeded models: the head (seed 0), the torso (1), the SR
    (2, noise strengths 0.10-0.25) and the a2m (`seeded_a2m_params(hp, 3)`)."""
    from genefaceplusplus_tpu_torch.models.audio2motion.vae_model import a2m_model_from_hparams
    from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF
    from genefaceplusplus_tpu_torch.models.radnerf_torso import TorsoField
    from genefaceplusplus_tpu_torch.models.superresolution import Superresolution, SynthesisLayer

    sr = Superresolution(3, 256, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        for i, layer in enumerate(m for m in sr.modules() if isinstance(m, SynthesisLayer)):
            layer.noise_strength.fill_(0.1 + 0.05 * i)
    a2m = a2m_model_from_hparams(hp, generator=torch.Generator().manual_seed(3))
    a2m.load_state_dict(seeded_a2m_params(hp, 3))
    return {"head": RADNeRF(cfg, generator=torch.Generator().manual_seed(0)),
            "torso": TorsoField(tcfg, generator=torch.Generator().manual_seed(1)), "sr": sr, "a2m": a2m}


def voiced_wav(seconds: float, f_start: float, f_end: float, seed: int) -> np.ndarray:
    """A harmonic tone at 16 kHz whose pitch glides from f_start to f_end Hz,
    with a little seeded noise."""
    t = np.arange(int(seconds * 16000)) / 16000.0
    phase = 2.0 * np.pi * np.cumsum(f_start + (f_end - f_start) * t / seconds) / 16000.0
    wav = 0.3 * sum(np.sin(k * phase) / k for k in (1, 2, 3))
    return (wav + 0.003 * np.random.RandomState(seed).randn(len(t))).astype(np.float32)


def phase_serve_audio(dev):
    from genefaceplusplus_tpu_torch.data.audio import extract_f0
    from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset, synthetic
    from genefaceplusplus_tpu_torch.inference import pipeline
    from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer, default_inp
    from genefaceplusplus_tpu_torch.models.audio2motion.vae_model import a2m_batch, a2m_model_from_hparams
    from genefaceplusplus_tpu_torch.models.postnet import lle
    from genefaceplusplus_tpu_torch.ops import fused_field as ff
    from genefaceplusplus_tpu_torch.utils.audio_features import get_audio_features_batch
    from genefaceplusplus_tpu_torch.utils.rays import pixel_rays

    cfg, tcfg, hp = sr_head_config(), torso_config(), a2m_hparams()
    models = seeded_audio_models(cfg, tcfg, hp)
    params, torso_params, sr = models["head"].state_dict(), models["torso"].state_dict(), models["sr"]
    a2m_params = models["a2m"].state_dict()
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


def phase_serve_cli(dev, work: str):
    """serve_cli (module docstring) in `work`; returns (its B1 launches, what
    serve_long, convert and serve_app reuse: the card's GeneFaceInfer of the
    work dirs, the torso dir, the 4 s request's features file and its audio)."""
    import contextlib

    from genefaceplusplus_tpu_torch.config import load_config
    from genefaceplusplus_tpu_torch.data.audio import extract_f0, pcm16
    from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset, synthetic
    from genefaceplusplus_tpu_torch.data.video import read_avi
    from genefaceplusplus_tpu_torch.inference import cli
    from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer, default_inp
    from genefaceplusplus_tpu_torch.inference.serving import stream_infer
    from genefaceplusplus_tpu_torch.ops import fused_field as ff
    from genefaceplusplus_tpu_torch.utils.ckpt import save_flax_checkpoint
    from genefaceplusplus_tpu_torch.utils.convert_jax import export_flax_params

    repo = os.path.dirname(os.path.abspath(__file__))
    cfg, tcfg, hp = sr_head_config(), torso_config(), a2m_hparams()
    models = seeded_audio_models(cfg, tcfg, hp)
    written = {k: m.state_dict() for k, m in models.items()}
    occ, grid = bench_occupancy(cfg.grid_size), bench_torso_grid(tcfg.grid_size)

    @contextlib.contextmanager
    def in_repo():  # base_config paths are relative to the repository root
        cwd = os.getcwd()
        os.chdir(repo)
        try:
            yield
        finally:
            os.chdir(cwd)

    binary, vid = os.path.join(work, "binary"), "May"
    os.makedirs(os.path.join(binary, vid))
    np.save(os.path.join(binary, vid, "trainval_dataset.npy"), synthetic(num_frames=24, H=SIZE, W=SIZE, seed=0),
            allow_pickle=True)
    a2m_dir, head_dir, torso_dir = (os.path.join(work, d) for d in ("a2m", "head_sr", "torso"))
    with in_repo():
        a2m_yaml = load_config("egs/datasets/May/audio2motion_vae.yaml")
        head_yaml = load_config("egs/datasets/May/lm3d_radnerf_sr.yaml")
        torso_yaml = load_config("egs/datasets/May/lm3d_radnerf_torso_sr.yaml")
    t0 = time.perf_counter()
    save_flax_checkpoint(a2m_dir, 40000, {"state_dict": {"variables": export_flax_params(models["a2m"]),
                                                         "opt_state": {}}}, config=a2m_yaml)
    save_flax_checkpoint(head_dir, 250000, {
        "state_dict": {"params": {"head": export_flax_params(models["head"]), "sr": export_flax_params(models["sr"])},
                       "opt_state": {}},
        "extra_state": {"occupancy": occ}}, config=dict(head_yaml, binary_data_dir=binary, video_id=vid))
    save_flax_checkpoint(torso_dir, 200000, {
        "state_dict": {"torso_params": export_flax_params(models["torso"]), "opt_state": {}},
        "extra_state": {"torso_grid": grid}},
        config=dict(torso_yaml, head_model_dir=head_dir, binary_data_dir=binary, video_id=vid))
    write_ms = (time.perf_counter() - t0) * 1e3
    sizes = {d: sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)) for d in (a2m_dir, head_dir, torso_dir)}
    print(f"[serve_cli] wrote three JAX-layout work dirs ({', '.join(f'{os.path.basename(d)} {n / 2 ** 20:.1f} MiB' for d, n in sizes.items())}) "
          f"in {write_ms:.1f} ms; configs egs/datasets/May/{{audio2motion_vae,lm3d_radnerf_sr,"
          f"lm3d_radnerf_torso_sr}}.yaml resolved by the port's loader")

    # loading: every tensor as written; grids and crops as a directly built GeneFaceInfer's
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    infer = GeneFaceInfer.from_work_dirs(audio2secc_dir=a2m_dir, torso_model_dir=torso_dir, device=dev)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    for name, model in (("head", infer.head_model), ("torso", infer.torso_model), ("sr", infer.sr_model),
                        ("a2m", infer.a2m_model)):
        got = model.state_dict()
        check(set(got) == set(written[name]), f"{name}: loaded keys differ from the written ones")
        bad = [k for k in got if not torch.equal(got[k].cpu(), written[name][k])]
        check(not bad, f"{name}: {len(bad)} tensors differ from the written ones, e.g. {bad[:3]}")
    check(infer.head_cfg == cfg and infer.torso_cfg == tcfg, "head or torso config of the work dirs")
    check(all(infer.a2m_cfg.get(k) == v for k, v in hp.items()), "a2m config of the work dir")
    ds = RADNeRFDataset(synthetic(num_frames=24, H=SIZE, W=SIZE, seed=0), smo_win_size=cfg.smo_win_size,
                        with_sr=True)
    direct = GeneFaceInfer(cfg, written["head"], ds, occ, device=dev, torso_cfg=tcfg,
                           torso_params=written["torso"], sr_params=written["sr"], torso_occupancy_2d=grid,
                           a2m_hparams=hp, a2m_params=written["a2m"])
    check(torch.equal(infer.occupancy, direct.occupancy), "occupancy grid")
    check(torch.equal(infer.torso_occupancy_2d, direct.torso_occupancy_2d), "torso grid")
    check((infer.head_crop, infer.torso_crop, infer.sr_crop) == (direct.head_crop, direct.torso_crop,
                                                                direct.sr_crop), "crops")
    check((infer.sr_bg is None) == (direct.sr_bg is None)
          and (infer.sr_bg is None or torch.equal(infer.sr_bg, direct.sr_bg)), "SR background")
    print(f"[serve_cli] from_work_dirs(a2m, torso): {load_ms:.3f} ms; head, torso, SR and a2m tensors equal to "
          f"the written ones bit for bit; occupancy, torso grid and crops (head {infer.head_crop}, torso "
          f"{infer.torso_crop}, sr {infer.sr_crop}) equal to the direct GeneFaceInfer's")

    # the CLI: 4 s of features with their audio -> an AVI
    rs = np.random.RandomState(200)
    wav = voiced_wav(AUDIO_SECONDS, 130.0, 190.0, seed=7)
    feats = {"hubert": rs.randn(HUBERT_FRAMES, 1024).astype(np.float32),
             "f0": extract_f0(wav, mel_len=HUBERT_FRAMES), "wav16k": wav}
    fpath = os.path.join(work, "request.npy")
    np.save(fpath, feats, allow_pickle=True)
    torch.cuda.synchronize()
    ff.fused_field.launches = 0  # count only the main path's launches
    t0 = time.perf_counter()
    out = cli.main(["--a2m_ckpt", a2m_dir, "--torso_ckpt", torso_dir, "--drv_aud_features", fpath,
                    "--out_name", os.path.join(work, "out.mp4")])
    cli_ms = (time.perf_counter() - t0) * 1e3
    cli_launches = ff.fused_field.launches
    T = HUBERT_FRAMES // 2
    check(out == os.path.join(work, "out.avi"), f"the CLI wrote {out}")
    frames, pcm = read_avi(out)
    check(frames.shape == (T, 2 * ds.H, 2 * ds.W, 3), f"AVI frames {frames.shape}")
    check(np.array_equal(pcm, pcm16(wav)), "AVI audio vs pcm16(wav16k)")
    check(cli_launches == T, f"fused_field launched {cli_launches} times for {T} CLI frames")
    direct.generator.manual_seed(42)  # the CLI's GeneFaceInfer draws from a fresh generator seeded 42
    inp = default_inp(drv_aud_features=fpath)
    t0 = time.perf_counter()
    ref = np.stack(list(direct.forward_secc2video(direct.forward_audio2secc(direct.prepare_batch_from_inp(inp),
                                                                            inp), inp)))
    direct_ms = (time.perf_counter() - t0) * 1e3
    differ = [i for i in range(T) if not np.array_equal(frames[i], ref[i])]
    if differ:
        d = np.abs(frames[differ[0]].astype(np.int16) - ref[differ[0]])
        print(f"[serve_cli] AVI frames differing from the direct GeneFaceInfer's: {differ[:10]} "
              f"(frame {differ[0]}: max |d| {d.max()}, {int((d > 0).sum())} values)")
    check(not differ, "the CLI's frames vs the direct GeneFaceInfer's for the same input and draw")
    check(any(not np.array_equal(frames[0], f) for f in frames[1:]), "CLI frames do not vary")
    print(f"[serve_cli] {card_line()}; CLI (features -> {os.path.basename(out)}, "
          f"{os.path.getsize(out) / 2 ** 20:.1f} MiB): {T} frames of {2 * ds.H}x{2 * ds.W} equal to the direct "
          f"GeneFaceInfer's bit for bit, PCM equal to pcm16(wav16k) ({len(pcm)} samples), {cli_launches} "
          f"fused_field launches; wall {cli_ms:.1f} ms (work-dir load, audio2secc, render, AVI); the same request "
          f"through the direct GeneFaceInfer (audio2secc, render, no file) {direct_ms:.1f} ms, "
          f"{direct_ms / T:.3f} ms a frame")

    # the stream: 8 s in 2 s chunks, then a resume at the first chunk boundary
    swav = voiced_wav(STREAM_SECONDS, 110.0, 220.0, seed=9)
    sinp = {"hubert_full": rs.randn(int(STREAM_SECONDS * 50), 1024).astype(np.float32)}
    chunk_frames, launched_at = [], []
    launch = infer.launch_secc2video

    def counted(batch, *a, **kw):
        chunk_frames.append(int(batch["T"]))
        out = launch(batch, *a, **kw)
        launched_at.append(time.perf_counter())
        return out

    infer.launch_secc2video = counted
    infer.generator.manual_seed(42)
    torch.cuda.synchronize()
    ff.fused_field.launches = 0
    stamps, full = [], []
    t0 = time.perf_counter()
    for f in stream_infer(infer, swav, sinp, chunk_seconds=STREAM_CHUNK_SECONDS):
        stamps.append(time.perf_counter())
        full.append(f)
    n = len(full)
    k = chunk_frames[0]
    infer.generator.manual_seed(42)  # replay the draw of the first chunk
    torch.randn((1, infer.a2m_model.vae.latent_length(k), infer.a2m_model.vae.latent_size),
                generator=infer.generator, device=dev)
    resumed = list(stream_infer(infer, swav, dict(sinp, resume_from_frame=k), chunk_seconds=STREAM_CHUNK_SECONDS))
    stream_launches = ff.fused_field.launches
    infer.launch_secc2video = launch
    tail = len(swav) - n * 2 * 320
    check(0 <= tail < 16000 // 5, f"{n} frames for {len(swav)} samples: {tail} samples unconsumed (drift)")
    check(len(resumed) == n - k and all(np.array_equal(a, b) for a, b in zip(resumed, full[k:])),
          f"the stream resumed at frame {k} vs the uninterrupted stream's tail")
    check(stream_launches == n + len(resumed), f"fused_field launched {stream_launches} times for "
                                               f"{n + len(resumed)} streamed frames")
    ttff = (stamps[0] - t0) * 1e3
    ends = list(np.cumsum(chunk_frames))
    check(n in ends, f"{n} frames are not whole chunks {chunk_frames}")
    m = ends.index(n) + 1  # the uninterrupted stream's chunks
    # a chunk's cycle: from the last chunk's launch to its own (its a2m,
    # its render launched, the last chunk's frames drained), a frame
    per_chunk = [(launched_at[i] - launched_at[i - 1]) * 1e3 / chunk_frames[i]
                 for i in range(1, m) if chunk_frames[i] == k]
    print(f"[serve_cli] stream_infer over {STREAM_SECONDS} s in {STREAM_CHUNK_SECONDS} s chunks: {n} frames "
          f"(chunks {chunk_frames[:m]}), {tail} samples unconsumed (< 0.2 s: no drift); resumed at "
          f"frame {k}: {len(resumed)} frames equal to the uninterrupted tail bit for bit; {stream_launches} "
          f"fused_field launches for {n + len(resumed)} frames")
    print(f"[serve_cli] {card_line()}; stream: time to first frame {ttff:.3f} ms (the first chunk of {k} "
          f"frames rendered, the second launched); ms a frame by chunk cycle, full chunks 2..: "
          f"{', '.join(f'{x:.3f}' for x in per_chunk)} (median {statistics.median(per_chunk):.3f}); wall "
          f"{(stamps[-1] - t0) * 1e3:.1f} ms for {n} frames ({(stamps[-1] - t0) * 1e3 / n:.3f} ms a frame)")
    return cli_launches + stream_launches, {"infer": infer, "torso": torso_dir, "request": fpath, "wav": wav,
                                            "hp": hp, "work": work}


def phase_serve_long(dev, served) -> int:
    """serve_long (module docstring); returns its B1 launches."""
    import hashlib
    import struct

    from genefaceplusplus_tpu_torch.data.audio import pcm16
    from genefaceplusplus_tpu_torch.data.video import AVI_MAX_BYTES, StreamingVideoWriter, avi_bytes, read_avi
    from genefaceplusplus_tpu_torch.ops import fused_field as ff

    infer, work, T = served["infer"], served["work"], LONG_FRAMES
    H, W = 2 * infer.dataset.H, 2 * infer.dataset.W
    rs = np.random.RandomState(300)
    wav = voiced_wav(T / 25.0, 120.0, 200.0, seed=11)
    fpath = os.path.join(work, "long_request.npy")
    np.save(fpath, {"hubert": rs.randn(2 * T, 1024).astype(np.float32), "f0": voiced_f0(2 * T), "wav16k": wav},
            allow_pickle=True)
    digests = []
    forward = infer.forward_secc2video

    def hashed(*a, **kw):  # each rendered frame's sha256, as infer_once hands it to the writer
        for frame in forward(*a, **kw):
            digests.append(hashlib.sha256(np.ascontiguousarray(frame).tobytes()).digest())
            yield frame

    infer.forward_secc2video = hashed
    try:
        torch.cuda.synchronize()
        ff.fused_field.launches = 0  # count only the main path's launches
        t0 = time.perf_counter()
        path = infer.infer_once({"drv_aud_features": fpath, "out_name": os.path.join(work, "long.mp4")})
        wall = time.perf_counter() - t0
        launches = ff.fused_field.launches
    finally:
        del infer.forward_secc2video
    size = os.path.getsize(path)
    check(len(digests) == T and launches == T, f"{len(digests)} frames rendered, {launches} fused_field launches "
                                               f"for {T}")
    check(size == avi_bytes(T, H, W, len(wav)) and size > AVI_MAX_BYTES, f"AVI of {size} bytes")
    riffs, pos = [], 0  # the RIFF segments, walked by their headers
    with open(path, "rb") as f:
        while pos < size:
            f.seek(pos)
            ck, n, form = struct.unpack("<4sI4s", f.read(12))
            check(ck == b"RIFF", f"{ck!r} at {pos}, not a RIFF")
            riffs.append((form, 8 + n))
            pos += 8 + n + (n & 1)
        f.seek(0)
        head = f.read(1 << 16)
    dmlh = struct.unpack_from("<I", head, head.index(b"dmlh") + 8)[0]
    forms = [form for form, _ in riffs]
    check(pos == size and len(riffs) >= 2 and forms == [b"AVI "] + [b"AVIX"] * (len(riffs) - 1),
          f"RIFF segments {forms}")
    check(all(n <= AVI_MAX_BYTES for _, n in riffs), f"a RIFF past {AVI_MAX_BYTES} bytes: {riffs}")
    check(dmlh == T, f"dmlh total frames {dmlh}")
    t0 = time.perf_counter()
    frames, pcm = read_avi(path)
    read_s = time.perf_counter() - t0
    os.remove(path)
    check(frames.shape == (T, H, W, 3), f"read back {frames.shape}")
    bad = [i for i in range(T) if hashlib.sha256(frames[i].tobytes()).digest() != digests[i]]
    check(not bad, f"{len(bad)} frames read back differ from the rendered ones, e.g. {bad[:5]}")
    check(np.array_equal(pcm, pcm16(wav)), "the long clip's PCM vs pcm16(wav16k)")
    # the writer alone, on the same frames and audio
    t0 = time.perf_counter()
    writer = StreamingVideoWriter(os.path.join(work, "again.avi"), audio=wav)
    for frame in frames:
        writer.append(frame)
    again = writer.close()
    write_s = time.perf_counter() - t0
    check(os.path.getsize(again) == size, "the writer's second file differs in size")
    os.remove(again)
    print(f"[serve_long] infer_once over {T / 25.0:.0f} s of features: {T} frames of {H}x{W}, {launches} "
          f"fused_field launches, AVI 2.0 of {size:,} bytes in {len(riffs)} RIFF segments "
          f"({', '.join(f'{form.decode()} {n:,}' for form, n in riffs)}), dmlh {dmlh}; every frame's sha256 and "
          f"every sample ({len(pcm)}) read back equal")
    print(f"[serve_long] {card_line()}; infer_once wall {wall * 1e3:.1f} ms ({wall * 1e3 / T:.3f} ms a frame: "
          f"audio2secc, render, AVI); the writer alone {size / write_s / 1e6:.1f} MB/s ({write_s * 1e3:.1f} ms), "
          f"read_avi {size / read_s / 1e6:.1f} MB/s ({read_s * 1e3:.1f} ms), host disk under TMPDIR")
    return launches


def phase_convert(dev, served) -> int:
    """convert (module docstring); returns its B1 launches."""
    from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer, default_inp
    from genefaceplusplus_tpu_torch.models.audio2motion.vae_model import a2m_batch, a2m_model_from_hparams
    from genefaceplusplus_tpu_torch.ops import fused_field as ff
    from genefaceplusplus_tpu_torch.testing import reference_a2m_state, save_reference_ckpt
    from genefaceplusplus_tpu_torch.tools import convert_ckpt
    from genefaceplusplus_tpu_torch.utils import convert_torch_ckpt as cvt
    from genefaceplusplus_tpu_torch.utils.convert_jax import convert_flax_params

    hp, work = served["hp"], served["work"]
    src_dir, out_dir = os.path.join(work, "released"), os.path.join(work, "a2m_converted")
    os.makedirs(src_dir)
    state = reference_a2m_state(hp, seed=21)
    src = os.path.join(src_dir, "model_ckpt_steps_400000.ckpt")
    save_reference_ckpt(src, state)
    with open(os.path.join(src_dir, "config.yaml"), "w") as f:
        f.write("use_pitch: true\naudio_in_dim: 1024\n")
    t0 = time.perf_counter()
    path = convert_ckpt.main(["--input", src, "--type", "a2m", "--out", out_dir])
    convert_ms = (time.perf_counter() - t0) * 1e3
    expected = convert_flax_params(cvt.convert_pitch_contour_vae(state), a2m_model_from_hparams(hp))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    infer = GeneFaceInfer.from_work_dirs(audio2secc_dir=out_dir, torso_model_dir=served["torso"], device=dev)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    got = infer.a2m_model.state_dict()
    check(set(got) == set(expected), "the converted a2m's keys")
    bad = [k for k in got if not torch.equal(got[k].cpu(), expected[k])]
    check(not bad, f"{len(bad)} a2m tensors loaded on the card differ from the mapping's, e.g. {bad[:3]}")

    inp = default_inp(drv_aud_features=served["request"], temperature=0.0)
    torch.cuda.synchronize()
    ff.fused_field.launches = 0  # count only the main path's launches
    t0 = time.perf_counter()
    batch = infer.forward_audio2secc(infer.prepare_batch_from_inp(inp), inp)
    frames = np.stack(list(infer.forward_secc2video(batch, inp)))
    serve_ms = (time.perf_counter() - t0) * 1e3
    launches = ff.fused_field.launches
    T = int(batch["T"])
    check(launches == T and frames.shape == (T, 2 * infer.dataset.H, 2 * infer.dataset.W, 3),
          f"{launches} fused_field launches, frames {frames.shape}")
    check(any(not np.array_equal(frames[0], f) for f in frames[1:]), "frames served from the converted a2m do not vary")
    cpu_model = a2m_model_from_hparams(hp)
    cpu_model.load_state_dict(expected)
    with torch.no_grad():
        ref, _ = cpu_model.eval()(a2m_batch(batch["hubert"], batch["f0"], inp["mouth_amp"], "cpu"), train=False,
                                  temperature=0.0)
    err = float(np.abs(batch["a2m_out"] - ref[0].numpy()).max())
    check(err <= A2M_CARD_MAX, f"the converted a2m on the card vs the CPU at temperature 0: {err}")
    n = sum(t.numel() for k, t in expected.items() if not k.endswith("num_batches_tracked"))
    print(f"[convert] a fake reference a2m checkpoint (legacy torch.save, {len(state)} tensors, {n:,} variables, "
          f"weight-normed convs folded) -> tools/convert_ckpt.py --type a2m -> {os.path.basename(path)} "
          f"(flax msgpack, {os.path.getsize(path) / 2 ** 20:.1f} MiB); loaded on the card by from_work_dirs with the "
          f"serve_cli torso dir: every a2m tensor equal to the mapping's; temperature-0 a2m output on the card vs "
          f"the CPU max |d| {err:.3e} (<= {A2M_CARD_MAX}); {T} audio-driven frames served, {launches} fused_field "
          f"launches")
    print(f"[convert] {card_line()}; convert {convert_ms:.1f} ms (host), from_work_dirs {load_ms:.1f} ms, audio2secc "
          f"and {T} frames {serve_ms:.1f} ms ({serve_ms / T:.3f} ms a frame)")
    return launches


def _ws_stream(port: int, inp: dict):
    """A raw-socket WebSocket client: upgrade, one masked JSON text frame,
    then each binary message until the close frame. Returns (JPEGs, their
    arrival times, the time the request was sent)."""
    import base64
    import struct

    payload = json.dumps(inp).encode()
    mask = os.urandom(4)
    n = len(payload)
    check(n < 65536, "inp too long")
    frame = (bytes([0x81]) + (bytes([0x80 | n]) if n < 126 else bytes([0x80 | 126]) + struct.pack(">H", n)) + mask
             + bytes(b ^ mask[i % 4] for i, b in enumerate(payload)))
    key = base64.b64encode(os.urandom(16)).decode()
    request = (f"GET /ws HTTP/1.1\r\nHost: localhost\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
               f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n").encode()
    jpegs, times = [], []
    with socket.create_connection(("127.0.0.1", port), timeout=600) as sock, sock.makefile("rb") as f:
        t_sent = time.perf_counter()
        sock.sendall(request + frame)
        status = f.readline()
        check(b" 101 " in status, f"WebSocket upgrade answered {status!r}")
        while f.readline().strip():
            pass
        while True:
            h = f.read(2)
            check(len(h) == 2, "the server closed the WebSocket mid-frame")
            opcode, n = h[0] & 0x0F, h[1] & 0x7F
            if n == 126:
                n = struct.unpack(">H", f.read(2))[0]
            elif n == 127:
                n = struct.unpack(">Q", f.read(8))[0]
            data = f.read(n)
            if opcode == 0x8:
                return jpegs, times, t_sent
            check(opcode == 0x2, f"WebSocket message {opcode}: {data[:300]!r}")
            jpegs.append(data)
            times.append(time.perf_counter())


def _multipart(route: str, fields: dict, files: dict) -> bytes:
    boundary = "chipSmokeBoundary0x5f3759df"
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
             for k, v in fields.items()]
    parts += [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"; filename="{name}"\r\n'
              f"Content-Type: application/octet-stream\r\n\r\n".encode() + data + b"\r\n"
              for k, (name, data) in files.items()]
    body = b"".join(parts) + f"--{boundary}--\r\n".encode()
    return (f"POST {route} HTTP/1.1\r\nHost: localhost\r\nContent-Type: multipart/form-data; boundary={boundary}\r\n"
            f"Content-Length: {len(body)}\r\n\r\n").encode() + body


def _http(port: int, request: bytes):
    """(status line, headers, body) of one request, read to the close."""
    with socket.create_connection(("127.0.0.1", port), timeout=600) as sock:
        sock.sendall(request)
        chunks = []
        while True:
            b = sock.recv(1 << 20)
            if not b:
                break
            chunks.append(b)
    head, body = b"".join(chunks).split(b"\r\n\r\n", 1)
    lines = head.decode("latin-1").split("\r\n")
    return lines[0], dict(line.split(": ", 1) for line in lines[1:]), body


def _mjpeg_stream(port: int, request: bytes):
    """POST /stream: the JPEG parts of the multipart/x-mixed-replace reply
    as each arrives (a part ends at its JPEG's EOI and the part's CRLF).
    Returns (JPEGs, their arrival times, the time the request was sent)."""
    part = b"--frame\r\nContent-Type: image/jpeg\r\n\r\n"
    buf, jpegs, times, pos = bytearray(), [], [], None
    with socket.create_connection(("127.0.0.1", port), timeout=600) as sock:
        t_sent = time.perf_counter()
        sock.sendall(request)
        while True:
            b = sock.recv(1 << 20)
            if not b:
                break
            buf += b
            if pos is None:
                if b"\r\n\r\n" not in buf:
                    continue
                check(buf.startswith(b"HTTP/1.0 200"), f"POST /stream answered {bytes(buf[:80])!r}")
                pos = buf.index(b"\r\n\r\n") + 4
            while len(buf) >= pos + len(part):
                check(buf[pos:pos + len(part)] == part, f"MJPEG part header at {pos}: {bytes(buf[pos:pos + 60])!r}")
                end = buf.find(b"\xff\xd9\r\n", pos + len(part))
                if end < 0:
                    break
                jpegs.append(bytes(buf[pos + len(part):end + 2]))
                times.append(time.perf_counter())
                pos = end + 4
    check(pos == len(buf), f"{len(buf) - (pos or 0)} bytes after the last MJPEG part")
    return jpegs, times, t_sent


def phase_serve_app(dev, served) -> int:
    """serve_app (module docstring); returns its B1 launches."""
    import threading

    from genefaceplusplus_tpu_torch.data.audio import pcm16
    from genefaceplusplus_tpu_torch.data.image_io import jpeg_bytes, read_jpeg
    from genefaceplusplus_tpu_torch.data.video import read_avi
    from genefaceplusplus_tpu_torch.inference import app
    from genefaceplusplus_tpu_torch.inference.metrics import METRICS
    from genefaceplusplus_tpu_torch.inference.serving import stream_infer
    from genefaceplusplus_tpu_torch.ops import fused_field as ff

    infer, fpath = served["infer"], served["request"]
    inp = {"drv_aud_features": fpath, "temperature": 0.0}
    direct_inp = dict(inp)
    direct = [jpeg_bytes(f) for f in stream_infer(infer, app._load_stream_audio(direct_inp), direct_inp)]
    T = len(direct)
    with open(fpath, "rb") as f:
        upload = {"feats": ("request.npy", f.read())}
    server = app.make_server(infer, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    try:
        dropped = METRICS.snapshot()["frames"]["dropped"]
        torch.cuda.synchronize()
        ff.fused_field.launches = 0  # count only the main path's launches
        ws, ws_times, ws_sent = _ws_stream(port, dict(inp, push_queue_frames=4 * T))
        mj, mj_times, mj_sent = _mjpeg_stream(port, _multipart("/stream", {"temperature": "0"}, upload))
        t0 = time.perf_counter()
        status, headers, body = _http(port, _multipart("/infer", {"temperature": "0"}, upload))
        infer_ms = (time.perf_counter() - t0) * 1e3
        launches = ff.fused_field.launches
        _, _, metrics = _http(port, b"GET /metrics HTTP/1.1\r\nHost: localhost\r\n\r\n")
        metrics = json.loads(metrics)
        _, _, form = _http(port, b"GET / HTTP/1.1\r\nHost: localhost\r\n\r\n")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "the app's server thread did not stop")
    check(form == app.FORM.encode(), "GET / is not the form")
    check(len(ws) == len(mj) == T, f"{len(ws)} WebSocket and {len(mj)} MJPEG frames for {T}")
    check(metrics["frames"]["dropped"] == dropped, "the app dropped frames")
    out = os.path.join(served["work"], "reply.avi")
    with open(out, "wb") as f:
        f.write(body)
    frames, pcm = read_avi(out)
    os.remove(out)
    t_once = HUBERT_FRAMES // 2  # infer_once's frames: the whole clip, where the stream trims each chunk
    check(status == "HTTP/1.0 200 OK" and headers["Content-Type"] == "video/x-msvideo"
          and frames.shape == (t_once, 2 * infer.dataset.H, 2 * infer.dataset.W, 3)
          and np.array_equal(pcm, pcm16(served["wav"])), f"POST /infer: {status}, {frames.shape}")
    check(launches == 2 * T + t_once, f"{launches} fused_field launches for 2 x {T} + {t_once} frames")
    worst = math.inf
    for got in (ws, mj):
        for jpg, ref in zip(got, direct):
            if jpg != ref:
                worst = min(worst, psnr(read_jpeg(jpg), read_jpeg(ref), 255.0))
    equal = [sum(a == b for a, b in zip(got, direct)) for got in (ws, mj)]
    print(f"[serve_app] inference/app.py on 127.0.0.1:{port} over serve_cli's GeneFaceInfer, {AUDIO_SECONDS:g} s "
          f"request at temperature 0: WebSocket {len(ws)} and MJPEG {len(mj)} frames, byte-equal to jpeg_bytes of a direct "
          f"stream_infer's: {equal[0]}/{T} and {equal[1]}/{T}; the others decoded vs the direct ones' decodes: "
          f"worst PSNR {worst:.2f} dB; POST /infer: an AVI of {len(body):,} bytes, "
          f"{len(frames)} frames, the PCM; GET /metrics parses ({metrics['streams']['completed']} streams "
          f"completed, {metrics['frames']['pushed']} frames pushed); {launches} fused_field launches")
    check(equal == [T, T], f"the app's frames byte-equal to the direct stream's: {equal} of {T}")

    def cadence(times):
        gaps = np.diff(times) * 1e3
        return f"median {np.median(gaps):.3f} ms, p90 {np.percentile(gaps, 90):.3f}, max {gaps.max():.3f}"

    print(f"[serve_app] {card_line()}; time to first frame (request sent -> first JPEG received): WebSocket "
          f"{(ws_times[0] - ws_sent) * 1e3:.3f} ms, MJPEG {(mj_times[0] - mj_sent) * 1e3:.3f} ms; frame cadence "
          f"WebSocket {cadence(ws_times)}, MJPEG {cadence(mj_times)}; whole stream WebSocket "
          f"{(ws_times[-1] - ws_sent) * 1e3:.1f} ms, MJPEG {(mj_times[-1] - mj_sent) * 1e3:.1f} ms; POST /infer "
          f"{infer_ms:.1f} ms")
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


# ---- train_cli: one identity trained through the training CLI -------------

# the three stages of one identity, each through `python -m
# genefaceplusplus_tpu_torch.training.run` in a process of its own (the egs/
# configs at their widths, their 65,536-ray batches and full 256^2 frames;
# 16 frames of 512^2 with torso images); lip steps, the SR and perceptual
# terms start at step TRAIN_CLI_START; the SR stage is preempted by SIGTERM
# after step TRAIN_CLI_START and resumed
TRAIN_CLI_FRAMES, TRAIN_CLI_STEPS, TRAIN_CLI_START = 16, 12, 4
TRAIN_CLI_STAGES = {
    "head": ("egs/datasets/May/lm3d_radnerf.yaml", f"finetune_lips_start_iter={TRAIN_CLI_START}"),
    "sr": ("egs/datasets/May/lm3d_radnerf_sr.yaml", f"lpips_start_iters={TRAIN_CLI_START}"),
    "torso": ("egs/datasets/May/lm3d_radnerf_torso_sr.yaml", "lambda_torso_deform=0.01"),
}
TRAIN_CLI_METRICS = {"head": {"lpips_loss", "mse_loss", "weights_entropy_loss"},
                     "sr": {"sr_mse_loss", "lpips_loss", "sr_lpips_loss", "sr_lip_lpips_loss"},
                     "torso": {"torso_entropy", "deform_reg", "mse_loss"}}
SERVE_TRAINED_FRAMES = 8
# the binarizer's image files (genefaceplusplus_tpu/data/binarizer.py:121-123):
# kind -> (directory, extension)
BINARIZER_IMAGES = {"gt": ("com_imgs", "jpg"), "head": ("head_imgs", "png"), "torso": ("inpaint_torso_imgs", "png")}
CODEC_REPS = 24  # decodes and encodes timed per reading
# the trained dirs' float32 frames (the raw composite and the SR frame), card
# vs CPU: tests/test_torch_cuda.py's FULL_FRAME_MAX and FULL_FRAME_MEAN (the
# head's float32 products sum in another order on the card; measured 5.1e-4
# max on random weights, 2.6e-4 here). The torso alpha between them is
# printed, not held: the head-aware torso carries the head's differences
# into its deformation, which its 256-scale Fourier features magnify
# (measured 1.45e-3 to 1.69e-3 here with the 12-step weights)
TRAINED_CARD_MAX, TRAINED_CARD_MEAN = 2e-3, 1e-4
MSGPACK_MAP_FIRST_BYTES = {0xDE, 0xDF} | set(range(0x80, 0x90))


def _trees_equal(a, b) -> bool:
    if isinstance(b, dict):
        return isinstance(a, dict) and set(a) == set(b) and all(_trees_equal(a[k], b[k]) for k in b)
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def train_cli_stage(argv) -> int:
    """Run by phase_train_cli in a process of its own: the training CLI's
    `main(argv)` with each train step timed (synchronised), then the newest
    checkpoint read back and held to the final live state bit for bit;
    the readings go to chip_smoke_stage.json in the work dir."""
    from genefaceplusplus_tpu_torch.training import run
    from genefaceplusplus_tpu_torch.training.trainer import state_to_flax
    from genefaceplusplus_tpu_torch.utils.ckpt import get_last_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    step_ms = []
    build = run.build_task

    def timed_build(cfg, device=None):
        task = build(cfg, device)
        step = task.train_step

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*args, **kw)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        task.train_step = timed
        return task

    run.build_task = timed_build
    state = run.main(argv)
    work_dir = argv[argv.index("--work_dir") + 1]
    ckpt, path = get_last_checkpoint(work_dir)
    out = {"step_ms": step_ms, "global_step": int(state.global_step), "ckpt": os.path.basename(path),
           "ckpt_equal": _trees_equal(ckpt["state_dict"], state_to_flax(state)),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    with open(os.path.join(work_dir, "chip_smoke_stage.json"), "w") as f:
        json.dump(out, f)
    return 0


def _stage_metrics(work_dir: str) -> list:
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def run_until_sigterm(argv, work_dir: str, after_step: int, max_steps: int, log_path: str, what: str) -> int:
    """The training CLI module itself in a process of its own, sent SIGTERM
    once step `after_step` is logged: it must exit 0 with one checkpoint, at
    the step it stopped at (returned)."""
    import signal

    from genefaceplusplus_tpu_torch.utils.ckpt import get_all_ckpts

    repo = os.path.dirname(os.path.abspath(__file__))
    with open(log_path, "w") as log_file:  # a file: nothing reads a pipe while it runs
        proc = subprocess.Popen([sys.executable, "-m", "genefaceplusplus_tpu_torch.training.run", *argv],
                                cwd=repo, stdout=log_file, stderr=subprocess.STDOUT)
    try:
        metrics_path = os.path.join(work_dir, "metrics.jsonl")
        deadline = time.time() + 900
        while proc.poll() is None and time.time() < deadline:
            if os.path.exists(metrics_path) and any(
                    r.get("step", 0) >= after_step and "total_loss" in r for r in _stage_metrics(work_dir)):
                break
            time.sleep(0.05)
        signalled = proc.poll() is None
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(log_path) as f:
        log = f.read()
    check(signalled and proc.returncode == 0 and "checkpoint saved, exiting" in log,
          f"{what}: SIGTERM run exit {proc.returncode}\n{log[-3000:]}")
    preempted_at = int(re.findall(r"preempted at step (\d+)", log)[-1])
    check(after_step <= preempted_at < max_steps, f"{what}: preempted at step {preempted_at}")
    check([os.path.basename(p) for p in get_all_ckpts(work_dir)] == [f"model_ckpt_steps_{preempted_at}.ckpt"],
          f"{what}: the preempted run's checkpoint")
    return preempted_at


def host_cpu() -> str:
    """The host CPU's model name (or vendor, family and model) and count."""
    import platform

    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = fields.get("model name") or " ".join(
        f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model") if k in fields) or platform.machine()
    return f"{name} x{os.cpu_count()}"


def codec_check():
    """The host image codec, built on this machine from csrc/image_codec.cpp:
    tests/torch_image_fixtures/ decode to the sha256 of cv2's decodes
    recorded in its sha256.json, and the encoder's bytes for its seeded
    frame to the sha256 of cv2.imencode's at its defaults (q95, 4:2:0)."""
    import hashlib

    from genefaceplusplus_tpu_torch.data import image_io

    t0 = time.perf_counter()
    lib = image_io.build_codec()
    build_s = time.perf_counter() - t0
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "torch_image_fixtures")
    with open(os.path.join(fixtures, "sha256.json")) as f:
        want = json.load(f)
    for name, sha in want["decode"].items():
        got = image_io.read_image(os.path.join(fixtures, name))
        check(hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest() == sha,
              f"fixture {name} decodes to another image than cv2's")
    rgb = np.load(os.path.join(fixtures, want["encode"]["input"]))
    check(hashlib.sha256(image_io.jpeg_bytes(rgb)).hexdigest() == want["encode"]["sha256"],
          "encoder bytes differ from cv2.imencode's at q95 4:2:0")
    print(f"[train_cli] image codec built in {build_s:.1f} s ({os.path.basename(str(lib))}, "
          f"{image_io._find_cxx()}): {len(want['decode'])} fixtures decode to cv2's sha256, the encoder's bytes "
          "equal cv2.imencode's at q95 4:2:0")


def decode_readings(ds_dict: dict, dev) -> dict:
    """Host wall per 512^2 JPEG decode, RGBA PNG decode and JPEG encode
    (median of CODEC_REPS over the identity's files), and the frame store's
    load of the train split from the files, per frame."""
    from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset
    from genefaceplusplus_tpu_torch.data.image_io import jpeg_bytes, read_image
    from genefaceplusplus_tpu_torch.training.frame_store import base_device_frames

    samples = ds_dict["train_samples"] + ds_dict["val_samples"]

    def timed(fn, args):
        ms = []
        for k in range(CODEC_REPS):
            t0 = time.perf_counter()
            fn(args[k % len(args)])
            ms.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ms), min(ms)

    jpgs = [s["gt_img_fname"] for s in samples]
    pngs = [s["torso_img_fname"] for s in samples]
    frames = [read_image(p) for p in jpgs[:4]]
    for p in pngs[:2]:
        check(read_image(p).shape == (SIZE, SIZE, 4), f"{p}: not RGBA")
    out = {"jpeg_bytes": os.path.getsize(jpgs[0]), "png_bytes": os.path.getsize(pngs[0])}
    out["jpeg_decode_ms"], out["jpeg_decode_min"] = timed(read_image, jpgs)
    out["png_decode_ms"], out["png_decode_min"] = timed(read_image, pngs)
    out["jpeg_encode_ms"], out["jpeg_encode_min"] = timed(jpeg_bytes, frames)
    ds = RADNeRFDataset(ds_dict, with_sr=True)  # as training/run.py builds it
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store = base_device_frames(ds, dev)
    torch.cuda.synchronize()
    out["store_frames"] = len(ds)
    out["store_ms_per_frame"] = (time.perf_counter() - t0) * 1e3 / len(ds)
    check(tuple(store["gt"].shape) == (len(ds), SIZE // 2, SIZE // 2, 3), "frame store from the files")
    return out


def phase_train_cli(dev):
    from genefaceplusplus_tpu_torch.data.dataset import synthetic
    from genefaceplusplus_tpu_torch.data.image_io import write_jpeg, write_png
    from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer
    from genefaceplusplus_tpu_torch.models.full_renderer import render_full_frame
    from genefaceplusplus_tpu_torch.models.superresolution import Superresolution
    from genefaceplusplus_tpu_torch.ops import fused_field as ff
    from genefaceplusplus_tpu_torch.utils.audio_features import get_audio_features_batch
    from genefaceplusplus_tpu_torch.utils.ckpt import get_all_ckpts
    from genefaceplusplus_tpu_torch.utils.rays import pixel_rays

    repo = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="chip_smoke_train_cli_")
    try:
        codec_check()
        # the binarizer's layout: the record names the image files and holds
        # no image arrays
        ds_dict = synthetic(num_frames=TRAIN_CLI_FRAMES, H=SIZE, W=SIZE, seed=0)
        processed = os.path.join(root, "processed", "syn")
        rs = np.random.RandomState(1)
        for s in ds_dict["train_samples"] + ds_dict["val_samples"]:
            torso = np.round(rs.rand(SIZE, SIZE, 4) * 255).astype(np.uint8)
            torso[..., 3] = (torso[..., 3] > 127) * 255
            gt = np.round(s.pop("gt_img") * 255).astype(np.uint8)
            head = np.concatenate([gt, ((rs.rand(SIZE, SIZE, 1) > 0.5) * 255).astype(np.uint8)], -1)
            for kind, img in (("gt", gt), ("head", head), ("torso", torso)):
                sub, ext = BINARIZER_IMAGES[kind]
                path = os.path.join(processed, sub, f"{s['idx']:08d}.{ext}")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                if ext == "jpg":
                    write_jpeg(path, img)  # q95 4:2:0, cv2.imwrite's defaults
                else:
                    write_png(path, img)
                s[f"{kind}_img_fname"] = path
        check(not any(k.endswith("_img") for s in ds_dict["train_samples"] for k in s), "record holds images")
        binary = os.path.join(root, "binary")
        os.makedirs(os.path.join(binary, "syn"))
        np.save(os.path.join(binary, "syn", "trainval_dataset.npy"), ds_dict, allow_pickle=True)
        codec = decode_readings(ds_dict, dev)
        del ds_dict
        print(f"[train_cli] {card_line()}; host {host_cpu()}; image codec (host wall, median of "
              f"{CODEC_REPS}): {SIZE}x{SIZE} JPEG decode {codec['jpeg_decode_ms']:.3f} ms (min "
              f"{codec['jpeg_decode_min']:.3f}), RGBA PNG decode {codec['png_decode_ms']:.3f} ms (min "
              f"{codec['png_decode_min']:.3f}), JPEG encode q95 4:2:0 {codec['jpeg_encode_ms']:.3f} ms (min "
              f"{codec['jpeg_encode_min']:.3f}); frame store from the files {codec['store_ms_per_frame']:.3f} ms "
              f"a frame ({codec['store_frames']} gt frames decoded and resized to {SIZE // 2}^2, then on the card); "
              f"JPEG {codec['jpeg_bytes']} bytes, PNG {codec['png_bytes']} bytes a frame (noise: entropy "
              f"decoding's worst case)")
        dirs = {s: os.path.join(root, s) for s in TRAIN_CLI_STAGES}
        common = (f"binary_data_dir={binary},video_id=syn,max_updates={TRAIN_CLI_STEPS},val_check_interval=6,"
                  f"update_extra_interval={TRAIN_CLI_START},tb_log_interval=1")

        def argv(stage):
            cfg, extra = TRAIN_CLI_STAGES[stage]
            if stage == "torso":
                extra += f",head_model_dir={dirs['sr']}"
            return ["--config", os.path.join(repo, cfg), "--exp_name", f"chip_smoke_{stage}",
                    "--work_dir", dirs[stage], "--hparams", f"{common},{extra}"]

        def stage(name):
            out = subprocess.run([sys.executable, "-c", "import sys, chip_smoke; "
                                  "sys.exit(chip_smoke.train_cli_stage(sys.argv[1:]))", *argv(name)],
                                 cwd=repo, capture_output=True, text=True, timeout=900)
            check(out.returncode == 0, f"train_cli {name}: exit {out.returncode}\n{out.stdout[-3000:]}\n"
                                       f"{out.stderr[-3000:]}")
            with open(os.path.join(dirs[name], "chip_smoke_stage.json")) as f:
                return json.load(f)

        t0 = time.perf_counter()
        res = {"head": stage("head")}
        # the SR stage: the CLI module itself, SIGTERM once step TRAIN_CLI_START is logged
        preempted_at = run_until_sigterm(argv("sr"), dirs["sr"], TRAIN_CLI_START, TRAIN_CLI_STEPS,
                                         os.path.join(root, "sr_sigterm.log"), "train_cli sr")
        res["sr"] = stage("sr")
        res["torso"] = stage("torso")
        wall = time.perf_counter() - t0

        for name, r in res.items():
            recs = _stage_metrics(dirs[name])
            steps = [x for x in recs if "total_loss" in x]
            check([x["step"] for x in steps] == list(range(1, TRAIN_CLI_STEPS + 1)),
                  f"train_cli {name}: steps logged {[x['step'] for x in steps]}")
            check(all(math.isfinite(v) for x in steps for k, v in x.items() if k.endswith("loss")),
                  f"train_cli {name}: a loss is not finite")
            keys = set().union(*steps)
            check(TRAIN_CLI_METRICS[name] <= keys, f"train_cli {name}: metrics {sorted(keys)}")
            check(any("val_psnr" in x for x in recs), f"train_cli {name}: no validation")
            check(r["global_step"] == TRAIN_CLI_STEPS and r["ckpt_equal"],
                  f"train_cli {name}: final step {r['global_step']}, checkpoint equals the live state "
                  f"{r['ckpt_equal']}")
            for p in get_all_ckpts(dirs[name]):
                with open(p, "rb") as f:
                    check(f.read(1)[0] in MSGPACK_MAP_FIRST_BYTES, f"{p} is not flax msgpack")
        lip_steps = sum("lpips_loss" in x for x in _stage_metrics(dirs["head"]))
        print(f"[train_cli] {TRAIN_CLI_FRAMES} frames of {SIZE}x{SIZE} as image files (gt JPEG q95 4:2:0, head and "
              f"torso RGBA PNG); three stages through "
              f"the training CLI, {TRAIN_CLI_STEPS} steps each, {wall:.1f} s of wall: every loss finite, each "
              f"checkpoint flax msgpack and equal to the live state bit for bit; head: {lip_steps} lip steps "
              f"from step {TRAIN_CLI_START + 1}; sr: SR and perceptual terms from step {TRAIN_CLI_START + 1}, "
              f"SIGTERM after step {TRAIN_CLI_START}: checkpoint at step {preempted_at}, exit 0, resumed to "
              f"step {TRAIN_CLI_STEPS}, every step logged once; torso: from the sr dir")
        for name, r in res.items():
            # this process's steps; the first includes one-time set-up; the
            # head's lip steps (a 64^2 window of rays) apart from its full steps
            first = TRAIN_CLI_STEPS - len(r["step_ms"]) + 1
            lip = {x["step"] for x in _stage_metrics(dirs[name]) if "lpips_loss" in x} if name == "head" else set()
            kinds = {"full": [ms for s, ms in enumerate(r["step_ms"], first) if s > first and s not in lip],
                     "lip": [ms for s, ms in enumerate(r["step_ms"], first) if s > first and s in lip]}
            print(f"[train_cli] {card_line()}; {name} ms/step (host wall, synchronised, steps {first + 1}.."
                  f"{TRAIN_CLI_STEPS}): " + "; ".join(
                      f"{k} steps median {statistics.median(v):.3f}, min {min(v):.3f}, max {max(v):.3f}, "
                      f"n={len(v)}" for k, v in kinds.items() if v)
                  + f"; step {first} (set-up) {r['step_ms'][0]:.3f} ms; peak allocated {r['peak_gib']:.3f} GiB")

        # serving from the trained dirs: the card, B1 counted; then the float32
        # full frame against the CPU's
        infer = GeneFaceInfer.from_work_dirs(torso_model_dir=dirs["torso"], device=dev)
        ids = list(range(SERVE_TRAINED_FRAMES))
        batch = infer.prepare_gt_batch(ids)
        torch.cuda.synchronize()
        ff.fused_field.launches = 0  # count only the main path's launches
        t0 = time.perf_counter()
        frames = list(infer.forward_secc2video(batch, {"frames_per_dispatch": SERVE_TRAINED_FRAMES}))
        serve_ms = (time.perf_counter() - t0) * 1e3
        launches = ff.fused_field.launches
        H = infer.dataset.H
        check(len(frames) == SERVE_TRAINED_FRAMES and all(f.shape == (2 * H, 2 * H, 3) and f.dtype == np.uint8
                                                          for f in frames), "frames from the trained dirs")
        check(any(not np.array_equal(frames[0], f) for f in frames[1:]), "frames do not vary")
        check(launches == SERVE_TRAINED_FRAMES, f"fused_field launched {launches} times for "
                                                f"{SERVE_TRAINED_FRAMES} frames")
        cpu = GeneFaceInfer.from_work_dirs(torso_model_dir=dirs["torso"], device="cpu")
        outs = {}
        for inf in (cpu, infer):
            d = inf.device
            sr32 = Superresolution(3, inf.sr_model.block0.conv0.noise_const.shape[0]).to(d)  # float32
            sr32.load_state_dict(inf.sr_model.state_dict())
            with torch.no_grad():
                ro, rd = pixel_rays(torch.as_tensor(batch["poses"][:1], device=d), inf.dataset.intrinsics, H, H)
                win = get_audio_features_batch(torch.as_tensor(batch["cond"], device=d),
                                               torch.arange(1, device=d), inf.head_cfg.smo_win_size)[0]
                out = render_full_frame(
                    inf.head_model, ro[0], rd[0], win, inf.occupancy, inf.bg_color, inf.render_options({}),
                    (H, H), eye_area_percent=torch.as_tensor(batch["eye_area_percent"][:1], device=d),
                    torso_model=inf.torso_model, bg_coords=inf.bg_coords,
                    lm68=torch.as_tensor(batch["lm68"][:1], device=d), occupancy_2d=inf.torso_occupancy_2d,
                    sr_model=sr32, torso_crop=inf.torso_crop)
            outs[str(d)] = {k: getattr(out, k).cpu() for k in ("rgb_map", "torso_alpha", "sr_rgb_map")}
        errs = {}
        for k, ref in outs["cpu"].items():
            e = (outs[str(infer.device)][k] - ref).abs()
            errs[k] = (e.max().item(), e.mean().item())
        print(f"[train_cli] served from the trained dirs (torso -> sr head): {SERVE_TRAINED_FRAMES} frames of "
              f"{2 * H}x{2 * H} in {serve_ms:.1f} ms ({serve_ms / SERVE_TRAINED_FRAMES:.3f} ms a frame, first "
              f"request, host wall), {launches} fused_field launches; float32 frame card vs CPU: "
              + ", ".join(f"{k} max |d| {m:.3e} mean {a:.3e}" for k, (m, a) in errs.items())
              + f" (frames <= {TRAINED_CARD_MAX}, {TRAINED_CARD_MEAN})")
        for k in ("rgb_map", "sr_rgb_map"):
            m, a = errs[k]
            check(m <= TRAINED_CARD_MAX and a <= TRAINED_CARD_MEAN, f"trained dirs card vs CPU {k}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


# train_audio: an identity's tracks of TRAIN_AUDIO_FRAMES motion frames at 25
# fps (40 s; held-out split 90 frames), the a2m (audio2motion_vae.yaml, batch
# 8 x 64 frames) and then the postnet (postnet.yaml, batch 4) through the
# training CLI, TRAIN_AUDIO_STEPS steps each with validation every
# TRAIN_AUDIO_VAL; the a2m is preempted by SIGTERM once step
# TRAIN_AUDIO_SIGTERM is logged and resumed. Then TRAIN_AUDIO_REQUESTS
# requests of 4 s served from the trained dirs through the refiner.
TRAIN_AUDIO_FRAMES, TRAIN_AUDIO_STEPS, TRAIN_AUDIO_VAL, TRAIN_AUDIO_SIGTERM = 1000, 60, 30, 20
TRAIN_AUDIO_REQUESTS = 2
TRAIN_AUDIO_STAGES = {"a2m": "egs/datasets/May/audio2motion_vae.yaml", "postnet": "egs/datasets/May/postnet.yaml"}
TRAIN_AUDIO_VAL_KEYS = {"a2m": ("val_recon_mse", "val_gen_l1", "val_kl"),
                        "postnet": ("val_l1_refined", "val_l1_raw", "val_lmd")}
# one train step on the card against the CPU from the same state, batch and
# noise, with cuDNN's TF32 flag on: losses (relative) and every updated
# tensor, BatchNorm statistics included (of its largest entry)
STEP_LOSS_RTOL, STEP_TENSOR_REL = 1e-5, 1e-5


def audio_tracks(frames: int, seed: int) -> dict:
    """An identity's record with `frames` motion frames: synthetic's record
    at 16^2 (its per-frame samples; the tasks read no image), HuBERT [2T,
    1024] and a voiced f0 contour [2T] (`voiced_f0`),
    exp [T, 64] and idexp_lm3d [T, 204] smooth in time and partly driven by
    the audio, with their mean and std."""
    from genefaceplusplus_tpu_torch.data.dataset import synthetic

    d = synthetic(num_frames=frames, H=16, W=16, seed=seed)
    rs = np.random.RandomState(seed + 1)
    hubert = rs.randn(2 * frames, 1024).astype(np.float32)
    kern = np.ones(9) / 9.0

    def smooth(x):
        return np.stack([np.convolve(c, kern, mode="same") for c in x.T], 1)

    drive = hubert[::2, :64]
    exp = (0.3 * smooth(rs.randn(frames, 64)) + 0.05 * drive).astype(np.float32)
    lm = (smooth(rs.randn(frames, 204)) + 0.05 * np.tile(drive, (1, 4))[:, :204]).astype(np.float32)
    d.update(hubert=hubert, f0=voiced_f0(2 * frames), exp=exp, idexp_lm3d=lm, idexp_lm3d_mean=lm.mean(0),
             idexp_lm3d_std=lm.std(0) + 1e-3)
    return d


def voiced_f0(n: int, start_s: float = 0.0) -> np.ndarray:
    """A voiced f0 contour of n frames at 50 Hz from `start_s` seconds in: a
    pitch gliding around 150 Hz, with unvoiced (0) stretches."""
    t = start_s + np.arange(n) / 50.0
    f0 = 150.0 + 40.0 * np.sin(2 * np.pi * t / 3.0) + 15.0 * np.sin(2 * np.pi * t / 0.7)
    f0[np.sin(2 * np.pi * t / 5.0) > 0.8] = 0.0
    return f0.astype(np.float32)


def step_card_vs_cpu(cfg, ckpt, dev, what: str):
    """One train step of the task `cfg` names, on the card and on the CPU,
    from the checkpoint's state, one batch and one posterior draw, with
    cuDNN's TF32 flag on: (worst loss rtol, worst tensor error of its
    largest entry, its name); fails past STEP_LOSS_RTOL / STEP_TENSOR_REL."""
    from genefaceplusplus_tpu_torch.training import run
    from genefaceplusplus_tpu_torch.training.trainer import load_flax_state

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    try:
        out, batch, noise = {}, None, None
        for d in ("cpu", dev):
            task = run.build_task(cfg, device=d)
            state = load_flax_state(task.create_state(), ckpt["state_dict"])
            if batch is None:
                batch = {k: v.cpu() for k, v in task.sample_train_batch().items()}
                if what == "a2m":
                    c = task.cfg
                    noise = torch.randn((c.batch_size, state.model.vae.latent_length(c.seq_len), 16),
                                        generator=torch.Generator().manual_seed(7))
            kw = {"noise": noise} if what == "a2m" else {}
            state, metrics = task.train_step(state, {k: v.to(d) for k, v in batch.items()}, **kw)
            out[str(d)] = ({k: float(v) for k, v in metrics.items()},
                           {k: v.detach().cpu() for k, v in state.model.state_dict().items() if v.is_floating_point()})
        check(torch.backends.cudnn.allow_tf32, "the TF32 flag was changed")
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    (m_c, t_c), (m_g, t_g) = out["cpu"], out[str(dev)]
    loss_rel = max(abs(m_g[k] - m_c[k]) / max(abs(m_c[k]), 1e-30) for k in m_c)
    worst = max(((t_g[k] - t_c[k]).abs().max().item() / max(t_c[k].abs().max().item(), 1e-30), k) for k in t_c)
    print(f"[train_audio] {what} step on the card vs the CPU (the trained state, one batch and draw, "
          f"cudnn.allow_tf32=True): losses {', '.join(f'{k} {m_g[k]:.6g} vs {m_c[k]:.6g}' for k in m_c)}, worst "
          f"relative {loss_rel:.3e} (<= {STEP_LOSS_RTOL}); updated tensors (BatchNorm statistics included) max "
          f"|d| / max |v| {worst[0]:.3e} at {worst[1]} (<= {STEP_TENSOR_REL})")
    check(all(math.isfinite(v) for v in m_g.values()), f"{what}: a loss on the card is not finite")
    check(loss_rel <= STEP_LOSS_RTOL, f"{what} step card vs CPU: losses")
    check(worst[0] <= STEP_TENSOR_REL, f"{what} step card vs CPU: {worst[1]}")
    return loss_rel, worst


def profile_train_steps(cfg, ckpt, dev, what: str, steps: int = 5):
    """Where a train step's time goes: the task `cfg` names on the card from
    the checkpoint's state, 3 warm steps, then `steps` timed steps (host
    wall, synchronised) and `steps` more under the profiler; prints the
    kernels a step, the device-busy ms a step, the idle share of the wall
    and the kernels with the most device time."""
    from genefaceplusplus_tpu_torch.training import run
    from genefaceplusplus_tpu_torch.training.trainer import load_flax_state

    task = run.build_task(cfg, device=dev)
    state = load_flax_state(task.create_state(), ckpt["state_dict"])

    def run_steps():
        for _ in range(steps):
            task.train_step(state, task.sample_train_batch())
        return steps

    for _ in range(3):
        task.train_step(state, task.sample_train_batch())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_steps()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    acts, kernels, busy, top = profile_device(run_steps)
    check(busy is not None, f"{what}: the profiler saw no device activity")
    print(f"[train_audio] {card_line()}; {what} step under torch.profiler ({steps} steps after 3 warm): "
          f"{kernels:.1f} kernels ({acts:.1f} device activities) a step, device busy {busy:.3f} ms a step against "
          f"{wall:.3f} ms of host wall a step without the profiler: the device is idle {100 * (1 - busy / wall):.1f} %; "
          f"most device time: " + "; ".join(f"{t:.3f} ms in {c:.0f} launches {name[:48]}" for name, c, t in top[:4]))
    return wall, busy, kernels


def phase_train_audio(dev):
    from genefaceplusplus_tpu_torch.config import load_config, set_hparams
    from genefaceplusplus_tpu_torch.data.dataset import synthetic
    from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer, default_inp
    from genefaceplusplus_tpu_torch.models.audio2motion.vae_model import a2m_model_from_hparams
    from genefaceplusplus_tpu_torch.ops import fused_field as ff
    from genefaceplusplus_tpu_torch.utils.ckpt import get_last_checkpoint, save_flax_checkpoint
    from genefaceplusplus_tpu_torch.utils.convert_jax import export_flax_params

    repo = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="chip_smoke_train_audio_")
    try:
        binary = os.path.join(root, "binary")
        os.makedirs(os.path.join(binary, "tracks"))
        os.makedirs(os.path.join(binary, "May"))
        np.save(os.path.join(binary, "tracks", "trainval_dataset.npy"), audio_tracks(TRAIN_AUDIO_FRAMES, 0),
                allow_pickle=True)
        dirs = {s: os.path.join(root, s) for s in TRAIN_AUDIO_STAGES}

        def argv(stage):
            return ["--config", os.path.join(repo, TRAIN_AUDIO_STAGES[stage]), "--exp_name", f"chip_smoke_{stage}",
                    "--work_dir", dirs[stage], "--hparams",
                    f"binary_data_dir={binary},video_id=tracks,max_updates={TRAIN_AUDIO_STEPS},"
                    f"val_check_interval={TRAIN_AUDIO_VAL},tb_log_interval=1"]

        def stage(name):
            out = subprocess.run([sys.executable, "-c", "import sys, chip_smoke; "
                                  "sys.exit(chip_smoke.train_cli_stage(sys.argv[1:]))", *argv(name)],
                                 cwd=repo, capture_output=True, text=True, timeout=900)
            check(out.returncode == 0, f"train_audio {name}: exit {out.returncode}\n{out.stdout[-3000:]}\n"
                                       f"{out.stderr[-3000:]}")
            with open(os.path.join(dirs[name], "chip_smoke_stage.json")) as f:
                return json.load(f)

        t0 = time.perf_counter()
        preempted_at = run_until_sigterm(argv("a2m"), dirs["a2m"], TRAIN_AUDIO_SIGTERM, TRAIN_AUDIO_STEPS,
                                         os.path.join(root, "a2m_sigterm.log"), "train_audio a2m")
        res = {"a2m": stage("a2m"), "postnet": stage("postnet")}
        wall = time.perf_counter() - t0
        vals = {}
        for name, r in res.items():
            recs = _stage_metrics(dirs[name])
            steps = [x for x in recs if "total_loss" in x]
            check([x["step"] for x in steps] == list(range(1, TRAIN_AUDIO_STEPS + 1)),
                  f"train_audio {name}: steps logged {[x['step'] for x in steps]}")
            check(all(math.isfinite(v) for x in steps for k, v in x.items() if k.endswith("loss")),
                  f"train_audio {name}: a loss is not finite")
            vals[name] = {x["step"]: {k: x[k] for k in TRAIN_AUDIO_VAL_KEYS[name]}
                          for x in recs if TRAIN_AUDIO_VAL_KEYS[name][0] in x}
            check(sorted(vals[name]) == [TRAIN_AUDIO_VAL, TRAIN_AUDIO_STEPS]
                  and all(math.isfinite(v) for m in vals[name].values() for v in m.values()),
                  f"train_audio {name}: validations {vals[name]}")
            check(r["global_step"] == TRAIN_AUDIO_STEPS and r["ckpt_equal"],
                  f"train_audio {name}: final step {r['global_step']}, checkpoint equals the live state "
                  f"{r['ckpt_equal']}")
            with open(get_last_checkpoint(dirs[name])[1], "rb") as f:
                check(f.read(1)[0] in MSGPACK_MAP_FIRST_BYTES, f"{name}: not flax msgpack")
        a2m_cfg, pn_cfg = set_hparams(work_dir=dirs["a2m"]), set_hparams(work_dir=dirs["postnet"])
        n_a2m = sum(np.asarray(x).size for x in _leaves(get_last_checkpoint(dirs["a2m"])[0]["state_dict"]["variables"]))
        check(n_a2m == 11_840_768, f"the trained a2m has {n_a2m} variables")
        print(f"[train_audio] tracks of {TRAIN_AUDIO_FRAMES} frames (40 s at 25 fps; held out 90); the a2m "
              f"({TRAIN_AUDIO_STAGES['a2m']}, {n_a2m} variables, batch {a2m_cfg['batch_size']} x "
              f"{a2m_cfg['seq_len']} frames) and then the postnet ({TRAIN_AUDIO_STAGES['postnet']}, hidden "
              f"{pn_cfg['postnet_hidden']}, {pn_cfg['postnet_layers']} layers, batch {pn_cfg['batch_size']}) "
              f"through the training CLI, {TRAIN_AUDIO_STEPS} steps each with cuDNN's TF32 flag at the process "
              f"default, {wall:.1f} s of wall: every loss finite, each checkpoint flax msgpack and equal to the "
              f"live state bit for bit; a2m: SIGTERM after step {TRAIN_AUDIO_SIGTERM}: checkpoint at step "
              f"{preempted_at}, exit 0, resumed to step {TRAIN_AUDIO_STEPS}, every step logged once")
        for name, r in res.items():
            first = TRAIN_AUDIO_STEPS - len(r["step_ms"]) + 1
            rest = r["step_ms"][1:]
            print(f"[train_audio] {card_line()}; {name} ms/step (host wall, synchronised, steps {first + 1}.."
                  f"{TRAIN_AUDIO_STEPS}): median {statistics.median(rest):.3f}, min {min(rest):.3f}, max "
                  f"{max(rest):.3f}, n={len(rest)}; step {first} (set-up) {r['step_ms'][0]:.3f} ms; peak allocated "
                  f"{r['peak_gib']:.3f} GiB; validation " + "; ".join(
                      f"@{s}: " + ", ".join(f"{k} {v:.5g}" for k, v in m.items()) for s, m in vals[name].items()))

        # one step of each on the card against the CPU, from the trained state
        for name in TRAIN_AUDIO_STAGES:
            cfg_, ckpt = set_hparams(work_dir=dirs[name]), get_last_checkpoint(dirs[name])[0]
            step_card_vs_cpu(cfg_, ckpt, dev, name)
            profile_train_steps(cfg_, ckpt, dev, name)

        # serving through the refiner: the trained a2m and postnet dirs, with
        # serve_audio's seeded head + SR and torso written as work dirs
        cfg, tcfg, hp = sr_head_config(), torso_config(), a2m_hparams()
        models = seeded_audio_models(cfg, tcfg, hp)
        np.save(os.path.join(binary, "May", "trainval_dataset.npy"), synthetic(num_frames=24, H=SIZE, W=SIZE, seed=0),
                allow_pickle=True)
        cwd = os.getcwd()
        os.chdir(repo)  # base_config paths are relative to the repository root
        try:
            head_yaml = load_config("egs/datasets/May/lm3d_radnerf_sr.yaml")
            torso_yaml = load_config("egs/datasets/May/lm3d_radnerf_torso_sr.yaml")
        finally:
            os.chdir(cwd)
        head_dir, torso_dir = os.path.join(root, "head_sr"), os.path.join(root, "torso")
        params = {"head": export_flax_params(models["head"]), "sr": export_flax_params(models["sr"])}
        save_flax_checkpoint(head_dir, 1, {
            "state_dict": {"params": params, "opt_state": {}},
            "extra_state": {"occupancy": bench_occupancy(cfg.grid_size)}},
            config=dict(head_yaml, binary_data_dir=binary, video_id="May"))
        save_flax_checkpoint(torso_dir, 1, {
            "state_dict": {"torso_params": export_flax_params(models["torso"]), "opt_state": {}},
            "extra_state": {"torso_grid": bench_torso_grid(tcfg.grid_size)}},
            config=dict(torso_yaml, head_model_dir=head_dir, binary_data_dir=binary, video_id="May"))
        infer = GeneFaceInfer.from_work_dirs(audio2secc_dir=dirs["a2m"], postnet_dir=dirs["postnet"],
                                             torso_model_dir=torso_dir, device=dev)
        check(infer.postnet_model is not None, "no postnet loaded")
        rs = np.random.RandomState(300)
        paths = []
        for r in range(TRAIN_AUDIO_REQUESTS):
            f0 = voiced_f0(HUBERT_FRAMES, start_s=7.0 * r + 1.0)
            paths.append(os.path.join(root, f"request{r}.npy"))
            np.save(paths[-1], {"hubert": rs.randn(HUBERT_FRAMES, 1024).astype(np.float32), "f0": f0},
                    allow_pickle=True)
        pn_events = []
        hooks = [infer.postnet_model.register_forward_pre_hook(lambda *_: pn_events.append([cuda_event()])),
                 infer.postnet_model.register_forward_hook(lambda *_: pn_events[-1].append(cuda_event()))]
        batches, frames_all, cond_ms, frame_ms = [], [], [], []
        torch.cuda.synchronize()
        ff.fused_field.launches = 0  # count only the main path's launches
        try:
            for path in paths:
                inp = default_inp(drv_aud_features=path, frames_per_dispatch=8)
                t0 = time.perf_counter()
                batch = infer.forward_audio2secc(infer.prepare_batch_from_inp(inp), inp)
                t_cond = time.perf_counter()
                frames = list(infer.forward_secc2video(batch, inp))
                t_end = time.perf_counter()
                cond_ms.append((t_cond - t0) * 1e3)
                frame_ms.append((t_end - t_cond) * 1e3 / len(frames))
                batches.append(batch)
                frames_all.append(frames)
            launches = ff.fused_field.launches
        finally:
            for h in hooks:
                h.remove()
        torch.cuda.synchronize()
        pn_ms = [a.elapsed_time(b) for a, b in pn_events]
        n_frames = sum(len(f) for f in frames_all)
        H = infer.dataset.H
        for batch, frames in zip(batches, frames_all):
            T = batch["T"]
            check(len(frames) == T == HUBERT_FRAMES // 2, f"{len(frames)} frames for a motion of {T}")
            check(np.isfinite(batch["cond"]).all() and batch["cond"].shape == (T, 1, 204), "condition")
            check(np.isfinite(batch["lm68"]).all() and batch["lm68"].shape == (T, 68, 2), "torso landmarks")
            check(all(f.shape == (2 * H, 2 * H, 3) and f.dtype == np.uint8 for f in frames), "frames")
            check(any(not np.array_equal(frames[0], f) for f in frames[1:]), "frames do not vary")
        check(len(pn_ms) == TRAIN_AUDIO_REQUESTS, f"the postnet ran {len(pn_ms)} times")
        check(launches >= n_frames, f"fused_field launched {launches} times for {n_frames} frames")

        # audio2secc without the refiner, same requests and draws (host wall)
        plain_ms = []
        postnet, infer.postnet_model = infer.postnet_model, None
        try:
            for path, b in zip(paths, batches):
                inp = default_inp(drv_aud_features=path)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                unrefined = infer.forward_audio2secc(infer.prepare_batch_from_inp(inp), inp,
                                                     noise=torch.from_numpy(b["a2m_noise"]))
                plain_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            infer.postnet_model = postnet
        moved = float(np.abs(unrefined["cond"] - batches[-1]["cond"]).max())
        check(moved > 0.0, "the postnet did not change the condition")

        # request 1's condition again on the CPU from the card's a2m output, the postnet included
        b0 = batches[0]

        class ReplayA2M(torch.nn.Module):
            def forward(self, *_, **__):
                return torch.from_numpy(b0["a2m_out"])[None], None

        cpu_infer = GeneFaceInfer(infer.head_cfg, {k: v.cpu() for k, v in infer.head_model.state_dict().items()},
                                  infer.dataset, infer.occupancy.cpu(), device="cpu", a2m_hparams=infer.a2m_cfg,
                                  a2m_params=a2m_model_from_hparams(infer.a2m_cfg).state_dict(),
                                  postnet_hparams=pn_cfg.to_dict(),
                                  postnet_params={k: v.cpu() for k, v in postnet.state_dict().items()})
        cpu_infer.a2m_model = ReplayA2M()
        keys = ("hubert", "f0", "wav16k", "T", "pose_idx", "poses", "eulers", "transs")
        cpu_b0 = cpu_infer.forward_audio2secc({k: b0[k] for k in keys}, default_inp(frames_per_dispatch=8),
                                              noise=torch.from_numpy(b0["a2m_noise"]))
        cond_err = float(np.abs(b0["cond"] - cpu_b0["cond"]).max())
        lm_rel = float((np.abs(b0["lm68"].astype(np.float64) - cpu_b0["lm68"])
                        / np.maximum(1.0, np.abs(cpu_b0["lm68"]))).max())
        print(f"[train_audio] served from the trained a2m + postnet dirs (with seeded head + SR and torso "
              f"dirs): {TRAIN_AUDIO_REQUESTS} requests of {AUDIO_SECONDS} s, {n_frames} frames of {2 * H}x{2 * H}, "
              f"{launches} fused_field launches; the refiner moves the condition by up to {moved:.4f}; request 1's "
              f"condition on the CPU from the card's a2m output, postnet included: cond max |d| {cond_err:.3e} "
              f"(<= {COND_CARD_MAX}), lm68 max |d| / max(1, |v|) {lm_rel:.3e} (<= {LM68_CARD_REL})")
        check(cond_err <= COND_CARD_MAX, "condition through the postnet on the card vs the CPU")
        check(lm_rel <= LM68_CARD_REL, "torso landmarks through the postnet on the card vs the CPU")
        card = card_line()
        print(f"[train_audio] {card}; per request (1 first): postnet by CUDA events "
              f"{', '.join(f'{x:.3f}' for x in pn_ms)} ms; audio2secc host wall with the postnet "
              f"{', '.join(f'{x:.3f}' for x in cond_ms)} ms, without it (synchronised) "
              f"{', '.join(f'{x:.3f}' for x in plain_ms)} ms; per-frame time (forward_secc2video wall / frames) "
              f"{', '.join(f'{x:.3f}' for x in frame_ms)} ms")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


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
    print(f"ffmpeg: {shutil.which('ffmpeg')}")
    work = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        cli_launches, served = phase_serve_cli(dev, work)
        long_launches = phase_serve_long(dev, served)
        convert_launches = phase_convert(dev, served)
        app_launches = phase_serve_app(dev, served)
        del served
    finally:
        shutil.rmtree(work, ignore_errors=True)
    train_fwd, train_chain, train_wgrad = phase_train(dev)
    trained_launches = phase_train_cli(dev)
    refined_launches = phase_train_audio(dev)
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(f"[launches] fused_field: {serve_launches} head-only serving + {full_launches} full-frame serving + "
          f"{audio_launches} audio-driven serving + {cli_launches} CLI and streaming + {long_launches} long clip + "
          f"{convert_launches} from the converted a2m + {app_launches} web app + {train_fwd} training + "
          f"{trained_launches} serving from CLI-trained dirs + {refined_launches} serving through the trained "
          f"postnet; fused_field_bwd_chain: {train_chain} training; fused_field_wgrad: {train_wgrad} training")
    print(json.dumps({"kernels": [{
        "name": "fused_field", "route": "cuda",
        "source": "genefaceplusplus_tpu_torch/csrc/fused_field.cu",
        "replaces": "genefaceplusplus_tpu/ops/pallas/fused_field.py:156",
        "launches": (serve_launches + full_launches + audio_launches + cli_launches + long_launches + convert_launches
                     + app_launches + train_fwd + trained_launches + refined_launches),
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
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
