#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on an NVIDIA GPU.

Run from the repository root, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):
  build       compile genefaceplusplus_tpu_torch/csrc/fused_field.cu,
              fused_field_bwd.cu, fused_field_wgrad.cu and h264_intra.cu into
              build/kernels/ (four nvcc, in parallel); print each ptxas report
              (0 spills; h264_intra also 0 bytes of stack)
  kernel      the fused-field forward kernel (B1) vs its plain PyTorch version and
              vs the float32 model field, at the 512^2 x 10-sample serving
              size (2,621,440 points), with seeded weights and inputs; its
              serving outputs held bit for bit to the parent tree's
              (PARENT_REFERENCE); its train mode's outputs equal to serving's
              at 2,621,440 and 1,048,576 points, and its activation operands,
              ReLU masks and sigma gate vs fused_field_train_plain at
              1,048,576; both modes timed at both sizes in turns with their
              plain versions, against their bounds, beside the ptxas report
  kernel_bwd  the fused-field backward (train mode + tile chain + weight-gradient
              kernel) vs its plain PyTorch version at the training size (65,536
              rays x 16 samples = 1,048,576 points), all 14 gradient blocks,
              twice (bit-identical), on permuted points, and against the parent
              tree's gradients (bit for bit, or how far apart); the chain's
              gradient operands vs fused_field_chain_plain, and a second chain
              launch on the same buffer; the weight-gradient kernel vs its
              plain version on the operands; the chain (from a prepared
              buffer), the weight-gradient kernel and the whole backward each
              timed in turns with its plain version, and bf16 torch.matmul on
              the same operands beside the weight-gradient kernel; the chain's
              layout from its library (consumer warpgroups, ring stages,
              shared memory, registers) beside its ptxas report (0 spills)
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
  serve_mesh  serve_full's identity over a mesh (parallel/mesh.py): the first
              min(cards, 4) cards, or [cuda:0, cuda:0] (two shards on two
              streams of the one card; the copies between cards are then not
              exercised, which the script says); 8 GT-driven frames each with
              the default options, compact_frac 'auto' + color_topk 4,
              compact_frac 0.5 without the head crop, and a head crop of 3/4
              of the raw side, sharded and unsharded:
              uint8 frames within one level, head-crop flags equal, frame 0's
              float32 raw composite within 3e-4; B1 launched once a shard a
              frame on each device (fused_field.device_launches); a tiledgrid
              head (the May head's widths, seeded) on 512^2 head-only frames
              sharded vs unsharded; ms a frame single and sharded, in turns.
              After serve_cli: the CLI with --n_devices 2 (several cards: its
              AVI within one level of serve_cli's, B1 once a card a frame; one
              card: the refusal naming both counts)
  serve_compact serve_full's GeneFaceInfer with live-sample compaction: the
              budget that compact_frac 'auto' measures on each request's
              poses (the largest live fraction x 1.25, in 512-slot steps;
              off for all four: the head's box covers 66-100 % of the rays);
              then with a head of half the bench's radii, uncropped: 8
              frames with the measured budget held to the frames without it
              (one level of 255; B1 on M points, not R x S, one launch a
              frame),
              frame 1's float32 raw and SR frames to 1e-4, color_topk = S
              equal to the full frame and color_topk 4 read out (max, mean
              |d|); the head stage by CUDA events, compacted and full in turns
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
              features to out.mp4 (each 8-frame chunk encoded on the card by
              h264_intra: 13 launches; every video sample equal to the
              kernel's encode of the direct GeneFaceInfer's frames for the
              same draw, the PCM, one B1 launch a frame), to out.avi (100
              frames equal to the direct GeneFaceInfer's bit for bit; the
              wall beside the mp4's), and to an AVI with --compact_frac auto
              (its frames within one level of 255 of the plain CLI's);
              stream_infer over 8 s in 2 s chunks (no drift, an exact
              resume tail); timed (load, CLI wall, time to first frame, ms a
              frame); the CLI's mp4 wall split by one more run (render, the
              render's device tail, encode, copy, framing, mux, file write,
              the rest)
  h264        the H.264 intra kernel (csrc/h264_intra.cu) vs its plain
              versions, byte for byte: its framed NAL units, compacted and
              split by frame, vs access_units' of data/h264.py:encode_plain's
              RBSPs, and each slice without its emulation prevention vs that
              RBSP, on serve_cli's 8-frame 512^2 chunk, 8 of its
              1536x512 --debug panels, a 504x500 crop (frame cropping), 8
              synthetic_face frames of 512^2, noise at QP 4 (the I_PCM escape),
              flat frames at QP 0 (levels past Baseline's limit: the escape)
              testing.emulation_prevention_frames (the card inserts
              emulation-prevention bytes) and testing.wide_frames at QP 4
              (4,096 wide: the slice words past shared memory, kept in the
              output's rows); decode_own of the kernel's stream
              equal to the plain reconstruction; the synthetic_face luma PSNR
              >= 40 dB; bytes a frame against the AVI's 786,432; the kernel's
              median ms a chunk at 512^2 and 1536x512 by CUDA events, calls
              timed alone in turns with the plain version, beside its bound
              (bytes), and launches back to back as a second reading; one
              encode's device activities under torch.profiler
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
              / is the form, POST /infer returns the mp4 (video/mp4: 100
              frames, the PCM, 13 h264_intra launches); time to first frame
              and frame cadence over both
  serve_grid  a head as the reference trains it: testing.reference_head_state's
              seeded fake of its checkpoint (legacy torch.save, the May head's
              widths with grid_type tiledgrid: 16 levels x 2 a grid, 13,000 x 4
              individual codes, grid 128, its density_bitfield the bench's
              ellipsoid in morton order) converted by tools/convert_ckpt.py
              --type head (the occupancy equal to the ellipsoid exactly) and
              loaded on the card by from_work_dirs with serve_cli's a2m: 32
              GT-driven 512^2 head-only frames, one 4 s request through
              infer_once (an mp4 whose samples equal the kernel's encode of
              the direct frames) and
              one through stream_infer; the same head as hashgrid (8 frames);
              the torso_sr frame with a tiledgrid head and torso (8 frames);
              one grid-mode marching frame (48 lattice points, 16 samples;
              the share of rays whose sample masks agree card vs CPU); each
              held card vs CPU (a band of 128 rows through the head for the
              512^2 frames, the whole torso_sr frame in float32 SR) to 2e-3
              max and 1e-4 mean; timed (convert, load, ms a frame beside the
              Fourier frame of the serve phase, the grid encoders by CUDA
              events, kernels a frame, peak memory). The grid heads run the
              float32 field: neither B1 nor B2 is launched
  hubert      HuBERT on the card (models/hubert.py): a seeded full-width
              fake of facebook/hubert-large-ls960-ft (1024 wide, 24 layers,
              16 heads, FFN 4096, conv_dim 512 x 7, positional kernel 128 in
              16 groups, layer-norm extractor, stable LayerNorm; 315 M
              parameters) written as the released checkpoint lays it out
              (pytorch_model.bin with hubert. keys, lm_head, weight_g /
              weight_v, config.json, preprocessor_config.json) into a
              temporary Hugging Face hub cache and read by the port's own
              reader; a 2 s wav card vs CPU (each against a CPU float64 run:
              the card within 4x the CPU float32's distance + 1e-5 of the
              largest feature); a 45 s wav (two window seams and a tail: T as
              expected, finite, each window's rows equal to the window run
              alone); serve_cli's work dirs: the CLI on a bare 4 s wav
              (--drv_aud; frames equal to the direct GeneFaceInfer's for the
              same draw, one B1 launch a frame, frame 1 vs the plain field)
              and stream_infer on a bare 6 s wav (HuBERT per chunk, no
              drift); step_audio writes aud_hubert.npy; timed (ms a 2 s
              chunk and a 20 s window by CUDA events beside the bound at the
              float32 peak, the CPU's float32, kernels a chunk, peak memory)
  quality     the quality instruments on serve_full's 32 served frames of
              512^2: the v1 and v2 landmark detectors (metrics/lmd.py, seeded
              weights) card vs CPU (landmarks 1e-4 of the largest, v2's peak
              probabilities 1e-5), detect_lmd against the detector's own
              landmarks (<= 1e-3 px) and a 1/512 shift of them (1 px); the
              sync scorer (metrics/sync_scorer.py) trained on the card, 500
              steps of batch 48 on a seeded clip at HuBERT's width (1024),
              held by its three controls (aligned high at offset 0, shuffled
              audio and a frozen mouth under half of it) and its offset sweep
              card vs CPU; ms for the frames' detection, the scorer's ms/step
  train      HeadNeRFTask + Trainer.fit at the same config with
              use_fused_field=True on a synthetic 512^2 identity: 20 steps of
              65,536 rays x 16 samples, grid refreshes at steps 0 and 16,
              validation, a checkpoint and a resume; one train-mode forward,
              one chain and one weight-gradient launch a step; checked, ms a
              step (host wall) beside the step's span on the device and the
              field's backward (CUDA events), 3 more steps' device busy time
              and kernels (torch.profiler), and peak memory; then train-side
              compaction: a HeadNeRFTask with train_compact_start 1 on a
              head of half the bench's radii takes 3 steps (the switch, its probe
              telemetry, B1's train mode, the chain and the weight gradients
              on the compact buffer), and one compacted loss and backward
              from the trained state is held to the full-slot one on the same
              batch and noise (ray 0's first sample live, pad slots in the
              budget: loss 1e-5 relative, each gradient 1e-4 of its largest
              entry)
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
              training CLI in three processes (the head stage; the SR stage,
              SIGTERM'd; its resume and the torso stage), 12 steps at the egs/datasets/May
              configs (their widths, 65,536-ray batches, full 256^2 frames):
              lm3d_radnerf (lip steps from step 5, train_compact_start 8:
              its compact/* telemetry printed), lm3d_radnerf_sr (SR and
              perceptual terms from step 5; SIGTERM after step 4, exit 0 with a
              checkpoint, resumed to the end with every step logged once) and
              lm3d_radnerf_torso_sr from the SR dir; losses finite, checkpoints
              flax msgpack equal to the live state bit for bit, ms/step per
              stage; then GeneFaceInfer.from_work_dirs on the torso dir serves 8
              frames on the card (8 B1 launches) and its float32 frame is held
              to the CPU's
  train_grid  grid heads as the reference trains them, on train_cli's
              identity, through the training CLI at the May widths (tables of
              903,480 rows, grid 128, 65,536 rays x 16 samples), the stages one
              after another in one process: a tiledgrid head (lip steps from step 5,
              grid refreshes, validation), head + SR and a tiledgrid torso over
              it, and a hashgrid head, 12 steps each; a full-width fake of the
              reference's tiledgrid head converted by tools/convert_ckpt.py
              --type head at step 250,000 and fine-tuned 8 steps from a fresh
              optimizer (lip and full steps alternate); losses finite,
              checkpoints equal to the live state; the tiledgrid head's step
              read out (host wall, the grid encoders' forward and backward and
              the float32 MLPs' device ms by CUDA events, kernels and idle
              share by torch.profiler, peak memory through GridEncodeFunction
              and through the plain encoder) and its gradients on the card held
              to the CPU step's sums redone in float64 (each entry within
              1e-5 of its terms' absolute sum + 1e-4 of the largest; the
              old card-vs-CPU reading printed beside it); 8 frames
              served from the torso dir, each float32 frame held to the CPU's,
              and the hashgrid and converted heads on a band; ms/step per stage.
              Neither B1 nor B2 runs: grid heads train and serve with the
              float32 field, as in JAX
  train_disc  the SR stage's frozen dual discriminator: a full-width seeded fake
              of the reference's `disc` sub-model (512^2, channel_base 32768,
              channel_max 512, 8 mapping layers) converted by
              tools/convert_ckpt.py --type disc; the discriminator alone at
              512^2, batch 2, card vs CPU (logits and the seven feature maps
              within 1e-4 of their largest; the feature-matching loss's
              input gradients against the CPU's float64 ones, within 4x the
              CPU float32's distance + 1e-4); the CLI's head + SR stage on train_cli's
              identity with lambda_dual_fm 0.1 from step 1 and that
              disc_model_dir, 12 steps (the loss in every step, the
              discriminator bit-equal after, no discriminator leaf in the
              checkpoint; ms/step beside train_cli's head + SR, the
              discriminator's passes by CUDA events, peak memory); one SR +
              FM step card vs CPU (losses 1e-5; the gradients of the head's
              nn.Linear layers, Fourier projections and the SR's noise
              strengths against the CPU step's float64 sums as in
              train_grid, the rest within 1e-4 of their largest; the card's
              Adam step against the CPU's Adam on the card's gradients, 4
              ulps + 1e-6 of the update); 8 frames served from the trained
              dir (one B1 launch each)
  train_audio an identity's tracks (1,000 motion frames at 25 fps: seeded
              HuBERT, a voiced f0 contour, exp and idexp_lm3d smooth in time)
              as trainval_dataset.npy; the training CLI trains the a2m
              (egs/datasets/May/audio2motion_vae.yaml, full width, 11,840,768
              variables, batch 8 x 64 frames; SIGTERM after step 20, exit 0 with
              a checkpoint, resumed) and then the postnet
              (egs/datasets/May/postnet.yaml, batch 4), 60 steps each with
              validation at 30 and 60, in two processes (the a2m, SIGTERM'd;
              its resume and the postnet) with
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
  onboard     a new identity from video to served frames without JAX: a
              512^2 synthetic identity (data/synthetic_face.py, ONBOARD_FRAMES
              frames) written as raw/videos/Onboard.mp4 by the port's
              Mp4Writer on the card (h264_intra), which the frames step
              decodes on the host (csrc/h264_decode.cpp; its first and last
              frames equal decode_own's and the encoder's reconstruction),
              with a voiced aud.wav, segmaps/ from the render's own head and
              torso masks and lms_2d.npy from its 68 landmarks (mediapipe is
              absent); data/process.py's frames, audio, segment, fit (on the
              card), debug_fit (debug_fit.mp4 encoded on the card) and
              binarize; every file JAX's binarize reads
              and each sample's images exist, the fit's mean landmark error
              under ONBOARD_FIT_PX; the same fit on the CPU in float32 and
              float64: the card within FIT_ORDER_K x the CPU's float32
              distance from float64 (losses, reprojected landmarks, and
              exp through its reprojection; the id and euler coefficients
              too, trans loosely: it lies on flat directions); training/fleet.py trains the head + SR and torso
              stages (egs/datasets/May/lm3d_radnerf{,_torso}_sr.yaml, full
              width, ONBOARD_STEPS steps each) on the card, then skips both on a
              second run; inference/cli.py serves ONBOARD_SERVE_FRAMES frames
              from the fleet's dirs (a seeded full-width a2m), plain and with
              --debug to AVIs: the debug frames 512 x 1536, their first panel
              the plain frame bit for bit, one B1 launch a frame; --debug
              again to an mp4 (the panels uploaded and encoded on the card,
              its samples equal to the kernel's encode of the AVI's panels);
              each step's wall; then the H.264 decode reading: host ms a
              512^2 frame of the port's own 100-frame mp4 and of
              tools/h264_streams.py's seeded CABAC B stream (I P B B), whose
              luma digest must equal FFmpeg's (DIGEST_LUMA_SHA256)
  fit         the 3DMM fit at a real identity's size (FIT_T = 6,000 frames, a
              4-minute video, x FIT_K = 468 mediapipe key points on the
              stand-in basis, 200 + 200 iterations) on the card: wall, ms an
              iteration, kernels and device busy an iteration (torch.profiler),
              peak memory; the CPU's first FIT_CPU_ITERS iterations at the same
              size as a yardstick; card vs CPU (and CPU float64) on the first
              FIT_SLICE frames at the defaults

`python3 chip_smoke.py --reference PATH` writes PARENT_REFERENCE's contents
for the tree it sits in (run it from a copy of an older tree to compare
with that tree).

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
TRAIN_PROFILE_STEPS = 3  # steps after the counted run, under torch.profiler
# train-side compaction: HeadNeRFTask steps with train_compact_start at this
# step, over a head of half the bench's radii (SMALL_HEAD_R2: the
# random-init grid of the counted run is dense, and the bench head's box
# covers 66-100 % of the synthetic identity's rays, so either budget would
# keep the full-slot step); the compacted step against the full-slot step
# from one state, batch and noise: the same sums over the same live points,
# in other float32 orders (the weight-gradient kernel's chunks fall
# elsewhere). The
# backward's 14 float32 gradient blocks: each within COMPACT_ORDER_K times
# the most that the full-slot step's blocks move on the same rays in
# another order, or BWD_PERMUTED_MAX_REL of its largest entry. The
# parameters' gradients pass through the blocks' cast to bf16 (the VJP's
# weight dtypes), so one flipped rounding moves an entry by one bf16 step,
# 2^-8 to 2^-7 of itself: each within COMPACT_PARAM_REL of its largest
# entry. A pad slot's write
# counted as sample 0's gradient moves both far more.
TRAIN_COMPACT_STEPS, TRAIN_COMPACT_START = 3, 1
COMPACT_LOSS_REL, COMPACT_ORDER_K, COMPACT_PARAM_REL = 1e-5, 4.0, 2.0 ** -7
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
# the chain's and the train mode's operands vs their plain versions
# (tests/test_torch_cuda.py::test_chain_operands_match_plain): on the clean
# points whose five ReLU masks agree (at least CHAIN_MASKS_AGREE of them),
# every operand within CHAIN_MAX_REL of its largest entry
CHAIN_MASKS_AGREE, CHAIN_MAX_REL = 0.99, 1e-2
# B1's serving outputs at the kernel phase's inputs (sha256 of sigma, rgb,
# amb as float32 bytes) and B2's 14 gradient blocks at the kernel_bwd
# phase's (their live regions, and the sha256 of the padded blocks), as the
# port computed them before B1 had a train mode: commit 222a275 on an
# NVIDIA H100 80GB HBM3, written by `python3 chip_smoke.py --reference
# PATH` run from a copy of that tree
PARENT_REFERENCE = "tests/torch_fixtures/field_reference_222a275.npz"

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
# B1's train mode: B1's products, against B1's point traffic plus what it
# writes for the backward: the activation operands (1,184 bf16 a point),
# the five hidden layers' ReLU masks (80 bytes) and the sigma gate (1 byte)
TRAIN_BYTES = FWD_BYTES + 2 * 1184 + 80 + 1
# B2's tile chain alone: the input gradients only (the forward is the train
# mode's), against the gradient operands it writes (984 bf16 a point), the
# masks and gate it reads and its point data (xyz, sigma, rgb, amb and the
# three output gradients in: 68 bytes)
CHAIN_MACS = FWD_MACS - 16 * 128 + 64 * AMB_OUT  # 148,544
CHAIN_BYTES = 2 * 984 + 80 + 1 + 68
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


# a head of half the bench's radii: the interval marcher's live samples are
# those of the rays through the occupied box, which for the bench's head
# covers 66-100 % of the synthetic identity's 256^2 and 512^2 frames
SMALL_HEAD_R2 = 0.04


def bench_occupancy(grid: int = GRID, r2: float = 0.16) -> np.ndarray:
    """The bench's head-sized occupancy (bench.py): an ellipsoid spanning
    about half the frame (`r2` a smaller head's)."""
    xx, yy, zz = np.meshgrid(*([np.linspace(-1, 1, grid)] * 3), indexing="ij")
    return (xx ** 2 + (2.2 * yy) ** 2 + (1.4 * zz) ** 2) < r2


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
    from genefaceplusplus_tpu_torch.data import h264_decode as hd
    from genefaceplusplus_tpu_torch.ops import fused_field as ff
    from genefaceplusplus_tpu_torch.ops import h264_encode as he
    from genefaceplusplus_tpu_torch.utils.build import compile_libraries

    t0 = time.perf_counter()
    libs = {name: ff._library_path(name) for name in ff.SOURCES}
    libs["h264_intra"] = he.library_path()
    nvcc = ff._find_nvcc("the kernels")
    jobs = {ff._library_path(name): [nvcc, *ff.NVCC_FLAGS, str(src)] for name, src in ff.SOURCES.items()}
    jobs[he.library_path()] = [nvcc, *ff.NVCC_FLAGS, str(he.SOURCE)]
    decoder, cmd = hd.decoder_job()  # the host H.264 decoder (onboard), compiled beside the kernels
    jobs[decoder] = cmd
    compile_libraries(jobs, keep_log=True)  # one compiler a source, all started together
    print(f"[build] {len(libs)} kernels and the host H.264 decoder ({decoder.name}) in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        print(f"[build] {name}: {lib.relative_to(os.getcwd()) if lib.is_relative_to(os.getcwd()) else lib}")
        for line in ptxas_report(lib):
            print(f"[build] {name} ptxas: {line}")
        spills = [int(v) for x in ptxas_report(lib) for v in re.findall(r"(\d+) bytes spill", x)]
        check(not any(spills), f"{name} spills registers")
    stack = [int(v) for x in ptxas_report(libs["h264_intra"]) for v in re.findall(r"(\d+) bytes stack frame", x)]
    check(stack and not any(stack), "h264_intra keeps per-lane arrays on the stack")


def kernel_inputs(dev):
    """The kernel phase's seeded model, weights and N_POINTS points: (model,
    w, xyz, dirs, cond_feat, ind, amb_bias, col_bias)."""
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
    return model, w, xyz, dirs, cond_feat, ind, ab, cb


def bwd_inputs(dev):
    """The kernel_bwd phase's seeded weights, N_TRAIN_POINTS points and
    output gradients: (xyz, dirs, amb_bias, col_bias, w, g_sigma, g_rgb,
    g_amb), fused_field_backward's arguments."""
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
    return xyz, dirs, ab, cb, w, g_sigma, g_rgb, g_amb


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order (float32, on the host)."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def write_reference(dev, path: str):
    """PARENT_REFERENCE's contents for this tree: the digest of B1's serving
    outputs at kernel_inputs, B2's gradient blocks at bwd_inputs (live
    regions, float32) and their digest."""
    from genefaceplusplus_tpu_torch.ops import fused_field as ff

    with torch.no_grad():
        _, w, xyz, dirs, _, _, ab, cb = kernel_inputs(dev)
        out = {"fused_field": np.array(digest(ff.fused_field(xyz, dirs, ab, cb, w)))}
        del xyz, dirs
        grads = ff.fused_field_backward(*bwd_inputs(dev))
    out["fused_field_backward"] = np.array(digest(grads))
    for (name, _, (r, c)), g in zip(ff.GRAD_BLOCKS, grads):
        out[name] = g[:r, :c].cpu().numpy()
    np.savez_compressed(path, **out)
    print(json.dumps({k: str(out[k]) for k in ("fused_field", "fused_field_backward")}))


def parent_reference() -> dict:
    with np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), PARENT_REFERENCE)) as z:
        return {k: z[k] for k in z.files}


def operand_witness(kernel_ops: dict, plain_ops: dict, names, clean, kernel_relu, plain_relu) -> tuple:
    """tests/test_torch_cuda.py::test_chain_operands_match_plain's witness:
    on the clean points whose five ReLU masks (bool [n, 5, 128]) agree in
    the kernel's and the plain run, each named operand's largest |kernel -
    plain| over its largest plain entry. Returns (clean points, agreeing
    points, {name: rel}, {name: share of clean entries that differ}, the
    largest |kernel - plain| there over all the operands)."""
    agree = clean & (kernel_relu == plain_relu).flatten(1).all(-1)
    n_clean, n_agree = int(clean.sum()), int(agree.sum())
    worst, share, worst_abs = {}, {}, 0.0
    for name in names:
        a, b = kernel_ops[name].float(), plain_ops[name].float()
        check(bool(torch.isfinite(a).all()), f"non-finite operand {name}")
        share[name] = (a != b)[clean].float().mean().item() if n_clean else 0.0
        if n_agree:
            d = (a - b).abs()[agree].max().item()
            worst[name] = d / max(b.abs().max().item(), 1e-30)
            worst_abs = max(worst_abs, d)
    return n_clean, n_agree, worst, share, worst_abs


def clean_points(fk, fp):
    """Points whose forward outputs from the kernel agree with the plain
    forward's to FWD_CLEAN (log sigma, rgb, ambient)."""
    moved = torch.stack([(fk[0].log() - fp[0].log()).abs(), (fk[1] - fp[1]).abs().amax(-1),
                         (fk[2] - fp[2]).abs().amax(-1)], -1).amax(-1)
    return moved <= FWD_CLEAN


def timed_in_turns(run_kernel, run_plain, rounds: int) -> tuple:
    """(kernel ms, plain ms) lists, in turns: plain, kernel, kernel, plain."""
    for fn in (run_plain, run_kernel):
        cuda_ms(fn, 2)  # warm-up
    t_k, t_p = [], []
    for _ in range(rounds):
        t_p += cuda_ms(run_plain, 1)
        t_k += cuda_ms(run_kernel, 2)
        t_p += cuda_ms(run_plain, 1)
    return t_k, t_p


def med(xs) -> str:
    return f"median {statistics.median(xs):.4f} ms (min {min(xs):.4f}, max {max(xs):.4f}, n={len(xs)})"


def phase_kernel(dev):
    from genefaceplusplus_tpu_torch.ops import fused_field as ff

    model, w, xyz, dirs, cond_feat, ind, ab, cb = kernel_inputs(dev)
    with torch.no_grad():
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

        # serving, bit for bit as before the train mode existed
        now = digest(kern)
        parent = str(parent_reference()["fused_field"])
        print(f"[kernel] serving outputs sha256 {now}; before the train mode ({parent}): "
              f"{'bit-identical' if now == parent else 'DIFFERENT'}")
        check(now == parent, "B1's serving outputs differ from the parent tree's")

        # the train mode: the serving outputs bit for bit, at both sizes
        fwd = ff.fused_field_forward_train(xyz, dirs, ab, cb, w)
        check(all(torch.equal(a, b) for a, b in zip(fwd[:3], kern)),
              f"train-mode outputs differ from serving at {N_POINTS} points")
        del fwd
        n = N_TRAIN_POINTS
        xs, ds = xyz[:n].contiguous(), dirs[:n].contiguous()
        fwd = ff.fused_field_forward_train(xs, ds, ab, cb, w)
        check(all(torch.equal(a, b[:n]) for a, b in zip(fwd[:3], kern)),
              f"train-mode outputs differ from serving at {n} points")
        # its operands, masks and gate vs fused_field_train_plain
        plain_fwd = ff.fused_field_train_plain(xs, ds, ab, cb, w)
        k_ops = ff.unpack_operands(fwd.ops, n)
        k_relu = ff.unpack_relu_masks(fwd.relu, n)
        clean = clean_points(fwd[:3], plain_fwd[:3])
        n_clean, n_agree, worst, share, worst_abs = operand_witness(
            k_ops, plain_fwd.ops, ff.OPERAND_WRITERS["fused_field"], clean, k_relu, plain_fwd.relu)
        gate_agree = (fwd.gate.bool() == plain_fwd.gate).float().mean().item()
        mask_share = (k_relu == plain_fwd.relu).float().mean().item()
        padded = ff.unpack_operands(fwd.ops, ff.operand_points(n))
        tail_zero = all(not padded[k][n:].float().any() for k in ff.OPERAND_WRITERS["fused_field"])
        print(f"[kernel] train mode at {n} points: outputs equal serving's at {N_POINTS} and {n} points; "
              f"{n_clean} clean points, {n_agree} with the plain version's ReLU masks; share of mask bits equal "
              f"{mask_share:.6f}, of gates equal {gate_agree:.6f}; max |kernel - plain| / max |plain| there: "
              + ", ".join(f"{k_}={v:.2e}" for k_, v in worst.items())
              + "; share of clean entries that differ: " + ", ".join(f"{k_}={v:.4f}" for k_, v in share.items()))
        check(n_agree >= CHAIN_MASKS_AGREE * n_clean and all(v <= CHAIN_MAX_REL for v in worst.values()),
              "train-mode operands vs plain")
        check(torch.equal(k_ops["xyzb"].float(), plain_fwd.ops["xyzb"]), "train-mode bf16(xyz)")
        check(tail_zero, "train-mode operands past n are not zero")
        del fwd, plain_fwd, k_ops, k_relu, padded

        sizes = {N_POINTS: (xyz, dirs), n: (xs, ds)}
        times = {}
        for size, (x, d) in sizes.items():
            times[("serve", size)] = timed_in_turns(lambda: ff.fused_field(x, d, ab, cb, w),
                                                    lambda: ff.fused_field_plain(x, d, ab, cb, w), 4)
            times[("train", size)] = timed_in_turns(lambda: ff.fused_field_forward_train(x, d, ab, cb, w),
                                                    lambda: ff.fused_field_train_plain(x, d, ab, cb, w), 3)
    tile, step, smem = ff.fwd_config(ff._library("fused_field"))
    print(f"[kernel] {card_line()}; ptxas: " + "; ".join(
        x for x in ptxas_report(ff.build_kernels(["fused_field"])["fused_field"]) if "Compiling" not in x)
          + f"; {smem} bytes of dynamic shared memory a block; {tile} points a consumer tile, {step} a block step")
    rows = {}
    for (mode, size), (t_k, t_p) in times.items():
        ms, plain_ms = statistics.median(t_k), statistics.median(t_p)
        bound_ms, bound_by = kernel_bound(size, FWD_MACS, FWD_BYTES if mode == "serve" else TRAIN_BYTES)
        print(f"[kernel] {mode} mode at {size} points: kernel {med(t_k)}; plain {med(t_p)}; "
              f"{2.0 * FWD_MACS * size / ms / 1e9:.1f} TFLOP/s; bound {bound_ms:.4f} ms ({bound_by}; operations "
              f"{kernel_bound(size, FWD_MACS, 0)[0]:.4f} ms): {100.0 * bound_ms / ms:.1f} % of the bound")
        rows[(mode, size)] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
    extra = rows[("train", n)]["ms"] - rows[("serve", n)]["ms"]
    print(f"[kernel] train mode's extra over serving at {n} points: {extra:.4f} ms")
    serve = {"max_abs_err": max(e["rgb"][0], e["amb"][0]), **rows[("serve", N_POINTS)]}
    train = {"max_abs_err": worst_abs, **rows[("train", n)], "extra_ms": extra}
    return serve, train


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
    return launches, statistics.median(timed)


def stage_split(infer, dev, batch, frames: int, inp=None) -> dict:
    """CUDA-event times of each stage of `frames` served frames (median, min,
    max ms), rendered with the request options `inp`: the head (condition +
    march + field + composite) until the torso field starts, the torso
    (field, 2D-occupancy mask, composite) until the SR starts, the SR (with
    its paste into SR(bg)), and the uint8 quantise and copy to the host.
    Events come from hooks on the torso and SR modules."""
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
                out = infer.render_frame(ro[i], rd[i], wins[i], eyes[i], lm68[i][None], inp)
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
    return launches, infer, requests, [f for frames in frames_all for f in frames]


MESH_MAX_CARDS = 4  # serve_mesh's mesh: the first min(cards, 4) cards
MESH_MAX_ABS = 3e-4  # a sharded float frame vs the unsharded one (tests/test_serving_parallel.py's atol)
MESH_MAX_LEVELS = 1  # a sharded uint8 frame vs the unsharded one
MESH_CASES = (("plain", {}), ("compact_frac auto + color_topk 4", {"compact_frac": "auto", "color_topk": 4}),
              ("compact_frac 0.5, head crop off", {"compact_frac": 0.5, "head_crop": "off"}))
MESH_B1_CASES = 3  # mesh_cases that run B1 (the top-K path runs the float32 split field)
MESH_GRID_FRAMES = 3


def serve_mesh_mesh(dev):
    """(serve_mesh's mesh, whether it spans several cards): the first
    min(cards, MESH_MAX_CARDS) cards, or two shards on two streams of the
    one card."""
    from genefaceplusplus_tpu_torch.parallel.mesh import Mesh, make_mesh

    count = torch.cuda.device_count()
    if count >= 2:
        return make_mesh(min(count, MESH_MAX_CARDS), dev), True
    return Mesh([dev, dev]), False


def mesh_cases(infer) -> tuple:
    """MESH_CASES and a head crop of 3/4 of the raw frame's side (the
    identity's own crop declines: its head box covers most of the frame),
    whose window moves with each frame's pose."""
    side = [3 * infer.dataset.H // 4, 3 * infer.dataset.W // 4]
    return MESH_CASES + ((f"head crop {side[0]}x{side[1]}", {"head_crop": side}),)


def mesh_chunk(infer, batch, inp) -> tuple:
    """(uint8 frames [T, H, W, 3], head-crop flags or None) of `batch` as
    one chunk through `launch_all` (which resolves "auto")."""
    (imgs, fits, _), = infer.launch_all(batch, dict(inp, frames_per_dispatch=batch["T"]))
    return imgs, fits


def mesh_differences(single, sharded) -> tuple:
    """(max |d| in levels, crop flags equal) of two `mesh_chunk`s."""
    (a, fa), (b, fb) = single, sharded
    same = (fa is None and fb is None) or (fa is not None and fb is not None and torch.equal(fa, fb))
    return int((a.to(torch.int16) - b.to(torch.int16)).abs().max()), same


def phase_serve_mesh(dev, infer, requests) -> int:
    """serve_mesh (module docstring), on serve_full's GeneFaceInfer; returns
    B1's launches on the mesh's main path."""
    from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset, synthetic
    from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer
    from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF, RADNeRFConfig
    from genefaceplusplus_tpu_torch.ops import fused_field as ff

    mesh, cards = serve_mesh_mesh(dev)
    card = card_line()
    if not cards:
        print(f"[serve_mesh] one card: the mesh is {mesh}, two shards on two streams of the one card; the copies "
              "between cards were not exercised")
    sharded = GeneFaceInfer(infer.head_cfg, infer.head_model.state_dict(), infer.dataset, infer.occupancy,
                            device=dev, torso_cfg=infer.torso_cfg, torso_params=infer.torso_model.state_dict(),
                            torso_occupancy_2d=infer.torso_occupancy_2d, sr_params=infer.sr_model.state_dict(),
                            mesh=mesh)
    batch = infer.prepare_gt_batch(requests[1])
    T = batch["T"]
    cases = mesh_cases(infer)
    singles = [mesh_chunk(infer, batch, inp) for _, inp in cases]
    for _, inp in cases:  # warm-up: each path's first call on each device
        mesh_chunk(sharded, batch, inp)
    torch.cuda.synchronize()
    ff.fused_field.launches = 0  # count only the main path's launches
    ff.fused_field.device_launches.clear()
    shards = [mesh_chunk(sharded, batch, inp) for _, inp in cases]
    torch.cuda.synchronize()
    launches, by_device = ff.fused_field.launches, dict(ff.fused_field.device_launches)
    for (name, inp), one, many in zip(cases, singles, shards):
        d, same_flags = mesh_differences(one, many)
        check(isinstance(inp.get("head_crop"), str) or "head_crop" not in inp or one[1] is not None,
              f"serve_mesh {name}: no head-crop flags")
        print(f"[serve_mesh] {name}: {T} full frames of {one[0].shape[1]}x{one[0].shape[2]}, sharded vs "
              f"unsharded max |d| {d} levels of 255 (<= {MESH_MAX_LEVELS}); head-crop flags equal: {same_flags}")
        check(d <= MESH_MAX_LEVELS and same_flags, f"serve_mesh {name}: sharded vs unsharded frames")
    want = {str(d): MESH_B1_CASES * T * mesh.devices.count(d) for d in set(mesh.devices)}
    print(f"[serve_mesh] fused_field launches by device: {by_device} (expected {want}: one a shard a frame); "
          f"{launches} in all")
    check(by_device == want and launches == sum(want.values()), "serve_mesh: B1's launches by device")

    # float frames: frame 0 of the batch, the raw composite and the bf16 SR
    from genefaceplusplus_tpu_torch.utils.audio_features import get_audio_features_batch
    from genefaceplusplus_tpu_torch.utils.rays import pixel_rays

    ds = infer.dataset
    with torch.no_grad():
        ro, rd = pixel_rays(torch.as_tensor(batch["poses"][:1], device=dev), ds.intrinsics, ds.H, ds.W)
        win = get_audio_features_batch(torch.as_tensor(batch["cond"], device=dev), torch.arange(T, device=dev),
                                       infer.head_cfg.smo_win_size)[0]
        args = (ro[0], rd[0], win, torch.as_tensor(batch["eye_area_percent"][:1], device=dev),
                torch.as_tensor(batch["lm68"][:1], device=dev))
        for name, inp in cases:
            a, b = infer.render_frame(*args, inp=inp), sharded.render_frame(*args, inp=inp)
            raw = float((a.rgb_map - b.rgb_map).abs().max())
            sr = float((a.sr_rgb_map.float() - b.sr_rgb_map.float()).abs().max())
            print(f"[serve_mesh] {name}: frame 0's float32 raw composite sharded vs unsharded max |d| {raw:.3e} "
                  f"(<= {MESH_MAX_ABS}), its bf16 SR {sr:.3e}")
            check(raw <= MESH_MAX_ABS, f"serve_mesh {name}: the float frame sharded vs unsharded")

    # ms a frame, single and sharded in turns (plain options), 2 rounds
    times = {"single": [], "sharded": []}
    for _ in range(2):
        for key, x in (("single", infer), ("sharded", sharded)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (imgs, _, _), = x.launch_secc2video(batch, {"frames_per_dispatch": T})
            imgs.cpu()
            times[key].append((time.perf_counter() - t0) * 1e3 / T)
    del sharded

    # a tiledgrid head's 512^2 head-only frame (float32 RADNeRF.field: no B1)
    gcfg = RADNeRFConfig.from_hparams(grid_head_hparams("tiledgrid"))
    gparams = RADNeRF(gcfg, generator=torch.Generator().manual_seed(5)).state_dict()
    gds = RADNeRFDataset(synthetic(num_frames=24, H=SIZE, W=SIZE, seed=0), smo_win_size=gcfg.smo_win_size)
    occ = bench_occupancy(gcfg.grid_size)
    grid1 = GeneFaceInfer(gcfg, gparams, gds, occ, device=dev)
    gridk = GeneFaceInfer(gcfg, gparams, gds, occ, device=dev, mesh=mesh)
    gbatch = grid1.prepare_gt_batch(list(range(MESH_GRID_FRAMES)))
    grid_ms = {"single": [], "sharded": []}
    for key, x in (("single", grid1), ("sharded", gridk)):
        torch.cuda.synchronize()
        stamps = [time.perf_counter()]
        for i in range(MESH_GRID_FRAMES):
            x.launch_secc2video(gbatch, {"frames_per_dispatch": 1}, i, i + 1)[0][0].cpu()
            stamps.append(time.perf_counter())
        grid_ms[key] = [(b - a) * 1e3 for a, b in zip(stamps[1:-1], stamps[2:])]
    gd, _ = mesh_differences(mesh_chunk(grid1, gbatch, {}), mesh_chunk(gridk, gbatch, {}))
    with torch.no_grad():
        gargs = frame_inputs(grid1, dev)
        graw = float((grid1.render_frame(*gargs).rgb_map - gridk.render_frame(*gargs).rgb_map).abs().max())
    print(f"[serve_mesh] tiledgrid head (the May head's widths, seeded tables, grid {gcfg.grid_size}), "
          f"{MESH_GRID_FRAMES} head-only frames of {SIZE}x{SIZE}: sharded vs unsharded max |d| {gd} levels "
          f"(<= {MESH_MAX_LEVELS}); frame 0's float32 frame max |d| {graw:.3e} (<= {MESH_MAX_ABS})")
    check(gd <= MESH_MAX_LEVELS and graw <= MESH_MAX_ABS, "serve_mesh tiledgrid: sharded vs unsharded")
    del grid1, gridk
    print(f"[serve_mesh] {card}; mesh {mesh} ({'several cards' if cards else 'one card, two streams'}); ms a "
          f"frame (host wall of a chunk of {T}, synchronised, in turns, 2 rounds): torso_sr full frame single "
          f"{', '.join(f'{x:.3f}' for x in times['single'])}, sharded "
          f"{', '.join(f'{x:.3f}' for x in times['sharded'])}; tiledgrid head-only frame (frames 2..) single "
          f"{', '.join(f'{x:.3f}' for x in grid_ms['single'])}, sharded "
          f"{', '.join(f'{x:.3f}' for x in grid_ms['sharded'])}")
    return launches


def phase_serve_mesh_cli(dev, served) -> int:
    """serve_mesh's CLI part, on serve_cli's work dirs: with several cards
    the CLI with --n_devices 2 (its AVI within one level of serve_cli's
    out.avi, B1 once a shard a frame); with one, --n_devices 2 refused
    naming both counts. Returns the B1 launches of the first."""
    from genefaceplusplus_tpu_torch.data.video import read_avi
    from genefaceplusplus_tpu_torch.inference import cli
    from genefaceplusplus_tpu_torch.ops import fused_field as ff

    argv = ["--a2m_ckpt", served["a2m"], "--torso_ckpt", served["torso"], "--drv_aud_features", served["request"],
            "--n_devices", "2", "--out_name", os.path.join(served["work"], "mesh.avi")]
    count = torch.cuda.device_count()
    if count < 2:
        try:
            cli.main(argv)
        except RuntimeError as e:
            print(f"[serve_mesh] the CLI with --n_devices 2 on {count} card: {e}")
            check("2 CUDA devices asked for, 1 found" in str(e), "the refusal names both counts")
            return 0
        check(False, "the CLI with --n_devices 2 on one card did not raise")
    torch.cuda.synchronize()
    ff.fused_field.launches = 0  # count only the main path's launches
    ff.fused_field.device_launches.clear()
    t0 = time.perf_counter()
    out = cli.main(argv)
    ms = (time.perf_counter() - t0) * 1e3
    launches, by_device = ff.fused_field.launches, dict(ff.fused_field.device_launches)
    got, want = read_avi(out)[0], read_avi(os.path.join(served["work"], "out.avi"))[0]
    d = int(np.abs(got.astype(np.int16) - want).max())
    T = len(want)
    print(f"[serve_mesh] the CLI with --n_devices 2: {len(got)} frames, max |d| {d} levels from serve_cli's "
          f"out.avi (<= {MESH_MAX_LEVELS}), fused_field launches by device {by_device}, wall {ms:.1f} ms")
    check(got.shape == want.shape and d <= MESH_MAX_LEVELS, "the CLI's --n_devices 2 frames")
    check(by_device == {"cuda:0": T, "cuda:1": T}, "the CLI's B1 launches by device")
    return launches


def phase_serve_compact(dev, infer, requests) -> int:
    """serve_compact (module docstring), on serve_full's GeneFaceInfer: the
    main path's B1 launches (with the budget "auto" measures)."""
    from genefaceplusplus_tpu_torch.ops import fused_field as ff
    from genefaceplusplus_tpu_torch.utils.audio_features import get_audio_features_batch
    from genefaceplusplus_tpu_torch.utils.rays import pixel_rays

    ds = infer.dataset
    H, W = ds.H, ds.W
    opts = infer.render_options({})
    S = opts.num_samples
    R = H * W if infer.head_crop is None else infer.head_crop[0] * infer.head_crop[1]
    N = R * S
    # each request's budget: the interval marcher's mask is the occupied box,
    # and this identity's head box covers 66-100 % of the frame's rays over
    # its poses, so 'auto' keeps every request full (no tenth of the slots
    # free); a smaller head (SMALL_HEAD_R2), uncropped, leaves most slots dead
    for r, ids in enumerate(requests):
        poses = infer.prepare_gt_batch(ids)["poses"]
        t0 = time.perf_counter()
        counts = infer.live_sample_counts(poses, opts, (H, W))
        budget = infer._auto_compact_frac(poses, opts, (H, W), infer.head_crop)
        probe_ms = (time.perf_counter() - t0) * 1e3 / 2
        print(f"[serve_compact] compact_frac 'auto' on request {r + 1}'s {len(poses)} poses: max live fraction "
              f"{counts.max() / N:.4f} of the head render's {N} slots ({R} rays x {S} samples; {counts.max()} live "
              f"samples, min {counts.min()}): budget {budget} (0 = off at 0.9 or more); the live counts took "
              f"{probe_ms:.1f} ms")
    infer.occupancy = torch.from_numpy(bench_occupancy(infer.head_cfg.grid_size, SMALL_HEAD_R2)).to(dev)
    base = {"head_crop": "off"}
    R, N = H * W, H * W * S
    batch = infer.prepare_gt_batch(requests[0])
    counts = infer.live_sample_counts(batch["poses"], opts, (H, W))
    budget = infer._auto_compact_frac(batch["poses"], opts, (H, W), None)
    M = round(budget * N)
    print(f"[serve_compact] the same identity with a head of half the bench's radii, uncropped, request 1: max live "
          f"fraction {counts.max() / N:.4f} ({counts.max()} live samples, min {counts.min()}), budget {budget} = M {M} "
          f"of {N} slots (x1.25, in 512s)")
    check(0.0 < budget < 0.9 and M % 512 == 0 and counts.max() <= M, f"budget {budget} for {counts.max()} live")

    frames = {}
    launches = {}
    for name, inp in (("full", base), ("compact", {**base, "compact_frac": "auto"})):
        torch.cuda.synchronize()
        ff.fused_field.launches = 0  # count only the main path's launches
        frames[name] = np.stack(list(infer.forward_secc2video(batch, {"frames_per_dispatch": 8, **inp})))
        launches[name] = ff.fused_field.launches
    n = len(frames["full"])
    check(launches["compact"] == n, f"fused_field launched {launches['compact']} times for {n} compacted frames")
    d = np.abs(frames["compact"].astype(np.int16) - frames["full"])
    print(f"[serve_compact] {n} full frames of {2 * H}x{2 * W} with the budget vs without: max |d| {d.max()} "
          f"levels of 255, {int((d > 0).sum())} values differ; {launches['compact']} fused_field launches")
    check(d.max() <= 1, "compacted frames vs full frames (one level of 255)")

    with torch.no_grad():
        ro, rd = pixel_rays(torch.as_tensor(batch["poses"][:1], device=dev), ds.intrinsics, H, W)
        conds = torch.as_tensor(batch["cond"], device=dev)
        win = get_audio_features_batch(conds, torch.arange(batch["T"], device=dev), infer.head_cfg.smo_win_size)[0]
        args = (ro[0], rd[0], win, torch.as_tensor(batch["eye_area_percent"][:1], device=dev),
                torch.as_tensor(batch["lm68"][:1], device=dev))
        points = []

        def counted(xyz, *a, **kw):
            points.append(xyz.shape[0])
            return ff.fused_field(xyz, *a, **kw)

        out = {name: infer.render_frame(*args, inp={**base, **inp}, fused_fn=counted)
               for name, inp in (("full", {}), ("compact", {"compact_frac": budget}), ("topk_s", {"color_topk": S}),
                                 ("topk", {"color_topk": 4}))}
    check(points == [N, M, N], f"B1 ran on {points} points (full, compacted, color_topk = S), expected {[N, M, N]}")
    print(f"[serve_compact] B1 points a frame: {points[0]} full, {points[1]} compacted "
          f"({100.0 * points[1] / points[0]:.1f} %); color_topk = S is the full path (B1 on {points[2]}), "
          f"color_topk 4 runs the float32 split field (no B1 launch)")
    for key in ("rgb_map", "sr_rgb_map"):
        e = (getattr(out["compact"], key) - getattr(out["full"], key)).abs().max().item()
        print(f"[serve_compact] frame 1's float32 {key}, compacted vs full: max |d| {e:.3e} (<= 1e-4)")
        check(e <= 1e-4, f"compacted vs full {key}")
    e = (out["topk_s"].sr_rgb_map - out["full"].sr_rgb_map).abs().max().item()
    print(f"[serve_compact] color_topk = S = {S}: the full path, max |d| {e:.3e} (== 0)")
    check(e == 0.0, "color_topk = S vs the uncompacted frame")
    tk = (out["topk"].sr_rgb_map - out["full"].sr_rgb_map).abs()
    check(bool(torch.isfinite(out["topk"].sr_rgb_map).all()), "top-K frame not finite")
    print(f"[serve_compact] color_topk 4 of {S} (float32 split field) vs the B1 frame: max |d| {tk.max().item():.4f}, "
          f"mean |d| {tk.mean().item():.3e}")

    split = [(name, stage_split(infer, dev, batch, FRAMES_PER_REQUEST, {**base, **inp})["head"])
             for name, inp in (("full", {}), ("compacted", {"compact_frac": budget})) * 2]
    print(f"[serve_compact] {card_line()}; the head stage by CUDA events over {FRAMES_PER_REQUEST} frames, in turns "
          "(median, min, max ms): " + "; ".join(f"{k} {v[0]:.3f} ({v[1]:.3f}, {v[2]:.3f})" for k, v in split))
    return launches["compact"]


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


def plain_first_frame(infer, batch, dev) -> np.ndarray:
    """The batch's first frame through the plain field (uint8)."""
    from genefaceplusplus_tpu_torch.ops import fused_field as ff
    from genefaceplusplus_tpu_torch.utils.audio_features import get_audio_features_batch
    from genefaceplusplus_tpu_torch.utils.rays import pixel_rays

    ds = infer.dataset
    with torch.no_grad():
        ro, rd = pixel_rays(torch.as_tensor(batch["poses"][:1], dtype=torch.float32, device=dev), ds.intrinsics,
                            ds.H, ds.W)
        conds = torch.as_tensor(batch["cond"], device=dev)
        win = get_audio_features_batch(conds, torch.arange(batch["T"], device=dev), infer.head_cfg.smo_win_size)[0]
        eye = torch.as_tensor(batch["eye_area_percent"][:1], device=dev)
        lm68 = torch.as_tensor(batch["lm68"][:1], device=dev)
        plain = infer.render_frame(ro[0], rd[0], win, eye, lm68, fused_fn=ff.fused_field_plain).sr_rgb_map
        return (torch.clamp(plain, 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()


def phase_serve_audio(dev):
    from genefaceplusplus_tpu_torch.data.audio import extract_f0
    from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset, synthetic
    from genefaceplusplus_tpu_torch.inference import pipeline
    from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer, default_inp
    from genefaceplusplus_tpu_torch.models.audio2motion.vae_model import a2m_batch, a2m_model_from_hparams
    from genefaceplusplus_tpu_torch.models.postnet import lle
    from genefaceplusplus_tpu_torch.ops import fused_field as ff

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
    plain = plain_first_frame(infer, b0, dev)
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
    from genefaceplusplus_tpu_torch.data.mp4 import read_mp4_track
    from genefaceplusplus_tpu_torch.data.video import read_avi
    from genefaceplusplus_tpu_torch.inference import cli
    from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer, default_inp
    from genefaceplusplus_tpu_torch.inference.serving import stream_infer
    from genefaceplusplus_tpu_torch.ops import fused_field as ff
    from genefaceplusplus_tpu_torch.ops import h264_encode as he
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

    # the CLI: 4 s of features with their audio -> an H.264 mp4, each chunk encoded on the card
    rs = np.random.RandomState(200)
    wav = voiced_wav(AUDIO_SECONDS, 130.0, 190.0, seed=7)
    feats = {"hubert": rs.randn(HUBERT_FRAMES, 1024).astype(np.float32),
             "f0": extract_f0(wav, mel_len=HUBERT_FRAMES), "wav16k": wav}
    fpath = os.path.join(work, "request.npy")
    np.save(fpath, feats, allow_pickle=True)
    T = HUBERT_FRAMES // 2

    def run_cli(name: str):
        torch.cuda.synchronize()
        ff.fused_field.launches = he.h264_intra.launches = 0  # count only the main path's launches
        t0 = time.perf_counter()
        out = cli.main(["--a2m_ckpt", a2m_dir, "--torso_ckpt", torso_dir, "--drv_aud_features", fpath,
                        "--out_name", os.path.join(work, name)])
        ms = (time.perf_counter() - t0) * 1e3
        check(out == os.path.join(work, name), f"the CLI wrote {out}")
        check(ff.fused_field.launches == T, f"fused_field launched {ff.fused_field.launches} times for {T} CLI frames")
        return out, ms, ff.fused_field.launches, he.h264_intra.launches

    out, cli_ms, cli_launches, cli_h264 = run_cli("out.mp4")
    track = read_mp4_track(out)
    check((len(track.samples), track.height, track.width, track.fps) == (T, 2 * ds.H, 2 * ds.W, 25.0),
          f"the CLI's mp4: {len(track.samples)} frames of {track.height}x{track.width} at {track.fps} fps")
    check(np.array_equal(track.pcm, pcm16(wav)), "mp4 audio vs pcm16(wav16k)")
    check(cli_h264 == -(-T // 8), f"h264_intra launched {cli_h264} times for {T} CLI frames in chunks of 8")
    out_avi, avi_ms, n, _ = run_cli("out.avi")
    cli_launches += n
    frames, pcm = read_avi(out_avi)
    check(frames.shape == (T, 2 * ds.H, 2 * ds.W, 3), f"AVI frames {frames.shape}")
    check(np.array_equal(pcm, pcm16(wav)), "AVI audio vs pcm16(wav16k)")
    direct.generator.manual_seed(42)  # the CLI's GeneFaceInfer draws from a fresh generator seeded 42
    inp = default_inp(drv_aud_features=fpath)
    t0 = time.perf_counter()
    batch = direct.forward_audio2secc(direct.prepare_batch_from_inp(inp), inp)
    ref = np.stack(list(direct.forward_secc2video(batch, inp)))
    direct_ms = (time.perf_counter() - t0) * 1e3
    differ = [i for i in range(T) if not np.array_equal(frames[i], ref[i])]
    if differ:
        d = np.abs(frames[differ[0]].astype(np.int16) - ref[differ[0]])
        print(f"[serve_cli] AVI frames differing from the direct GeneFaceInfer's: {differ[:10]} "
              f"(frame {differ[0]}: max |d| {d.max()}, {int((d > 0).sum())} values)")
    check(not differ, "the CLI's frames vs the direct GeneFaceInfer's for the same input and draw")
    check(any(not np.array_equal(frames[0], f) for f in frames[1:]), "CLI frames do not vary")
    encoded = [au for s in range(0, T, 8) for au in he.encode_access_units(torch.from_numpy(ref[s:s + 8]).to(dev), s)]
    bad = [i for i in range(T) if encoded[i] != track.samples[i]]
    check(not bad, f"the CLI's mp4 samples vs the kernel's encode of the direct frames: {bad[:10]}")
    split = mp4_wall_split(lambda: run_cli("out_split.mp4"))
    with open(out, "rb") as f, open(split["out"][0], "rb") as g:
        check(f.read() == g.read(), "the split run's mp4 vs the CLI's")
    parts = ", ".join(f"{k} {v:.1f}" for k, v in split["ms"].items() if k != "encode_device")
    print(f"[serve_cli] {card_line()}; the CLI's {T}-frame mp4 wall split (one more run, the same file; a "
          f"synchronise after each rendered chunk and each encode): {split['wall']:.1f} ms = {parts} ms; the "
          f"{split['encodes']} encodes' device time {split['ms']['encode_device']:.3f} ms by CUDA events")
    mp4_size, avi_size = os.path.getsize(out), os.path.getsize(out_avi)
    print(f"[serve_cli] {card_line()}; CLI (features -> {os.path.basename(out)}, {mp4_size:,} bytes, "
          f"{(mp4_size - 2 * len(wav)) / T:,.0f} bytes a frame of video): {T} frames of {2 * ds.H}x{2 * ds.W}, each "
          f"sample equal to the kernel's encode of the direct GeneFaceInfer's frame for the same input and draw, "
          f"PCM equal to pcm16(wav16k) ({len(track.pcm)} samples), {T} fused_field and {cli_h264} "
          f"h264_intra launches; wall {cli_ms:.1f} ms (work-dir load, audio2secc, render, encode, mp4); the same "
          f"CLI to out.avi ({avi_size:,} bytes, frames equal to the direct GeneFaceInfer's bit for bit) "
          f"{avi_ms:.1f} ms; the same request through the direct GeneFaceInfer (audio2secc, render, no file) "
          f"{direct_ms:.1f} ms, {direct_ms / T:.3f} ms a frame")
    # the same request with the head field on a measured budget of live samples
    torch.cuda.synchronize()
    ff.fused_field.launches = 0
    t0 = time.perf_counter()
    out_c = cli.main(["--a2m_ckpt", a2m_dir, "--torso_ckpt", torso_dir, "--drv_aud_features", fpath,
                      "--out_name", os.path.join(work, "out_compact.avi"), "--compact_frac", "auto"])
    compact_ms = (time.perf_counter() - t0) * 1e3
    cli_launches += ff.fused_field.launches
    check(ff.fused_field.launches == T, f"fused_field launched {ff.fused_field.launches} times for {T} CLI frames")
    d = np.abs(read_avi(out_c)[0].astype(np.int16) - frames)
    print(f"[serve_cli] CLI with --compact_frac auto (the budget is on its '| render:' line): {T} frames, max |d| "
          f"{d.max()} levels of 255 from the plain CLI's ({int((d > 0).sum())} values differ), wall "
          f"{compact_ms:.1f} ms")
    check(d.max() <= 1, "the CLI's --compact_frac auto frames vs its plain frames")

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
    return cli_launches + stream_launches, cli_h264, {
        "infer": infer, "torso": torso_dir, "request": fpath, "wav": wav, "hp": hp, "work": work, "a2m": a2m_dir,
        "binary": binary, "frames": ref[:8], "batch": batch}


class _TimedFile:
    """A file whose writes add their host time to `ms["write"]`."""

    def __init__(self, f, ms: dict):
        self._f, self._ms = f, ms

    def write(self, b):
        t0 = time.perf_counter()
        n = self._f.write(b)
        self._ms["write"] += (time.perf_counter() - t0) * 1e3
        return n

    def __getattr__(self, name):
        return getattr(self._f, name)


def mp4_wall_split(run) -> dict:
    """`run()` (the CLI to an mp4) once more with its wall split, in ms of
    host time: render (the frame generator's host time), wait (a
    synchronise after each chunk: the render's device tail, which the
    unsplit run waits out at the first copy), encode (the kernel wrapper
    and a synchronise; its device time alone by CUDA events as
    encode_device), copy (copy_units: the gather and the device-to-host
    copy), framing (the rest of encode_access_units), mux
    (Mp4Muxer's append and close but their file writes), write (the file
    writes) and other (the wall less all of these: work-dir load,
    audio2secc, the writer's set-up). Returns the buckets, the wall and
    run()'s result."""
    from genefaceplusplus_tpu_torch.data import mp4 as mp4_mod
    from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer
    from genefaceplusplus_tpu_torch.ops import h264_encode as he

    ms = dict.fromkeys(("render", "wait", "encode", "encode_device", "copy", "framing", "mux", "write"), 0.0)
    saved = (GeneFaceInfer.launch_all, he.encode_access_units, he.h264_intra, he.copy_units, mp4_mod.Mp4Muxer.open,
             mp4_mod.Mp4Muxer.append, mp4_mod.Mp4Muxer.close)
    launch_all, encode, kernel, copy, opened, append, close = saved
    events = []

    def timed_launch_all(self, *a, **kw):
        it = launch_all(self, *a, **kw)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            ms["render"] += (t1 - t0) * 1e3
            ms["wait"] += (time.perf_counter() - t1) * 1e3
            yield item

    def timed(fn, key):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                ms[key] += (time.perf_counter() - t0) * 1e3
        return wrapped

    def timed_kernel(*a, **kw):  # the wrapper counts its launches on whatever `he.h264_intra` is
        t0 = time.perf_counter()
        e0 = cuda_event()
        out = kernel(*a, **kw)
        events.append((e0, cuda_event()))
        torch.cuda.synchronize()
        ms["encode"] += (time.perf_counter() - t0) * 1e3
        return out

    def timed_open(self, *a, **kw):
        opened(self, *a, **kw)
        self._f = _TimedFile(self._f, ms)

    timed_kernel.launches = kernel.launches
    GeneFaceInfer.launch_all, he.h264_intra, mp4_mod.Mp4Muxer.open = timed_launch_all, timed_kernel, timed_open
    he.encode_access_units, he.copy_units = timed(encode, "framing"), timed(copy, "copy")
    mp4_mod.Mp4Muxer.append, mp4_mod.Mp4Muxer.close = timed(append, "mux"), timed(close, "mux")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        (GeneFaceInfer.launch_all, he.encode_access_units, he.h264_intra, he.copy_units, mp4_mod.Mp4Muxer.open,
         mp4_mod.Mp4Muxer.append, mp4_mod.Mp4Muxer.close) = saved
    kernel.launches = timed_kernel.launches
    ms["encode_device"] = sum(a.elapsed_time(b) for a, b in events)
    ms["framing"] -= ms["encode"] + ms["copy"]
    ms["mux"] -= ms["write"]
    ms["other"] = wall - sum(v for k, v in ms.items() if k != "encode_device")
    return {"ms": ms, "wall": wall, "encodes": len(events), "out": out}


# h264: the H.264 intra kernel (csrc/h264_intra.cu) against its plain
# versions on serve_cli's frames: its framed NAL units, compacted and split by
# frame as the mp4 writer takes them, equal to data/h264.py:access_units' of
# encode_plain's RBSPs, and each slice, its emulation prevention removed,
# equal to that RBSP (integer arithmetic throughout), at 512^2, on 1536x512 --debug panels, on a size that is not
# whole macroblocks, on noise at a low QP (the I_PCM escape) and on
# testing.emulation_prevention_frames (slices that hold 00 00 0x, so the
# card's emulation prevention inserts bytes) and on testing.wide_frames
# (4,096 wide: the slice words past shared memory, in the output's rows);
# decode_own of the kernel's
# stream equal to the plain reconstruction; the luma PSNR of synthetic_face
# frames at the default QP at least H264_MIN_PSNR (tests/test_torch_h264.py's
# bound). The bound counts the frames' RGB bytes read once and the framed
# slices' bytes written once, at the HBM rate (no operation count: the work is
# integer and serial per row).
H264_MIN_PSNR = 40.0
H264_REPS = 10  # kernel launches timed a turn
H264_BATCH = 10  # launches back to back a sample of the second reading (the host's launch hidden)
HBM_BYTES_PER_S = 3.35e12


def phase_h264(dev, served) -> dict:
    """h264 (the comment above); returns the kernels line's readings."""
    from genefaceplusplus_tpu_torch.data import h264
    from genefaceplusplus_tpu_torch.data.synthetic_face import synthetic_face
    from genefaceplusplus_tpu_torch.ops import h264_encode as he
    from genefaceplusplus_tpu_torch.testing import EP_QP, WIDE, emulation_prevention_frames, wide_frames

    infer, batch, chunk = served["infer"], served["batch"], served["frames"]
    t0 = time.perf_counter()
    panels = np.stack([infer.debug_panel(batch, i, f) for i, f in enumerate(chunk)])
    panel_s = time.perf_counter() - t0
    faces = synthetic_face(num_frames=8, size=SIZE, seed=2)
    faces = np.stack([s["gt_img"] for s in faces["train_samples"] + faces["val_samples"]])[:8]
    noise = np.random.RandomState(21).randint(0, 256, (2, 136, 200, 3)).astype(np.uint8)
    flat = np.full((1, 32, 48, 3), 255, np.uint8)
    flat[:, :, 16:32] = 0  # at QP 0 its DC levels exceed Baseline's level_prefix: the escape, short as it codes
    # (frames, QP, decode frame 0 with decode_own): the plain decoder takes ~1.4 s a 512^2 frame
    cases = {"served chunk": (chunk, h264.QP, True), "--debug panel": (panels[:1], h264.QP, False),
             "served crop": (chunk[:1, :500, :504], h264.QP, True), "synthetic_face": (faces, h264.QP, False),
             "noise at QP 4": (noise, 4, True), "levels past the limit at QP 0": (flat, 0, True),
             "emulation prevention": (emulation_prevention_frames(), EP_QP, True),
             f"{WIDE} wide at QP 4": (wide_frames(), 4, True)}
    readings, call_ms, batch_ms = {}, [], []
    for name, (frames, qp, decode) in cases.items():
        B, H, W, _ = frames.shape
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(dev)
        if name == "served chunk":  # the kernel's timed launches before and after the plain version's run
            call_ms += timed_h264(x, qp)
            batch_ms += timed_h264(x, qp, H264_BATCH)
        e0, e1 = cuda_event(), cuda_event()
        e0.record()
        plain = h264.encode_plain(x, 0, qp)
        h264.frame_slices(plain.rows, plain.bits)
        e1.record()
        torch.cuda.synchronize()
        plain_ms = [e0.elapsed_time(e1)]
        if name == "served chunk":
            call_ms += timed_h264(x, qp)
            batch_ms += timed_h264(x, qp, H264_BATCH)
        units, lengths = he.h264_intra(x, 0, qp)
        if W == WIDE:  # the slice words past shared memory: kept in the units' own rows
            check(units.stride(0) > units.shape[1], f"h264: frames {W} wide kept their words in shared memory")
        aus = he.split_access_units(he.copy_units(units, lengths), B)
        nbytes = ((plain.bits + 7) // 8).tolist()
        slices = [h264.remove_emulation_prevention(unit[1:]) for au in aus for unit in h264.split_avcc(au)]
        check(slices == [plain.rows[s, :n].cpu().numpy().tobytes() for s, n in enumerate(nbytes)],
              f"h264: {name}: the kernel's slices vs the plain version's RBSPs")
        want = h264.access_units(plain.rows, plain.bits, B)
        check(aus == want, f"h264: {name}: the kernel's framed access units vs access_units' of the plain RBSPs")
        inserted = sum(len(a) for a in want) - sum(nbytes) - 5 * len(nbytes)
        if name == "emulation prevention":
            check(inserted > 0, "h264: the emulation-prevention frames' slices hold no 00 00 0x")
        note = ""
        if decode:
            dec = h264.decode_own(aus[0], *h264.sps_pps(H, W))
            check(np.array_equal(dec.y, plain.recon[0][0, :H, :W].cpu().numpy())
                  and np.array_equal(dec.cb, plain.recon[1][0, :H // 2, :W // 2].cpu().numpy())
                  and np.array_equal(dec.cr, plain.recon[2][0, :H // 2, :W // 2].cpu().numpy()),
                  f"h264: {name}: decode_own of the kernel's frame 0 vs the plain reconstruction")
            note = f"; decode_own of its frame 0 equal to the reconstruction ({int(dec.pcm.sum())} of {dec.pcm.size} " \
                   "macroblocks I_PCM)"
            if name == "noise at QP 4":
                check(dec.pcm.any(), "h264: no I_PCM escape on noise at QP 4")
            if name == "levels past the limit at QP 0":
                check(dec.pcm.all(), "h264: a level past the limit without the I_PCM escape")
            if W == WIDE:
                check(dec.pcm.any() and not dec.pcm.all(), "h264: the wide frame is not part I_PCM, part coded")
        src = h264.luma(frames)
        rec = plain.recon[0][:, :H, :W].cpu().numpy()
        luma_psnr = min(psnr(rec[i], src[i], 255.0) for i in range(B))
        per_frame = sum(len(a) for a in aus) / B
        readings[name] = {"plain_ms": statistics.median(plain_ms), "bytes_per_frame": per_frame, "psnr": luma_psnr,
                          "moved": x.numel() + per_frame * B}  # RGB read once, the framed slices written once
        print(f"[h264] {card_line()}; {name}: {B} x {H}x{W} at QP {qp}: the kernel's slices equal to the plain "
              f"version's RBSPs and its framed access units to access_units' ({inserted} emulation-prevention bytes "
              f"inserted){note}; {per_frame:,.0f} bytes a frame ({H * W * 3 / per_frame:.1f}x under its AVI "
              f"frame); luma PSNR min {luma_psnr:.2f} dB; plain {', '.join(f'{v:.1f}' for v in plain_ms)} ms")
    check(readings["synthetic_face"]["psnr"] >= H264_MIN_PSNR,
          f"h264: synthetic_face luma PSNR {readings['synthetic_face']['psnr']:.2f} dB")
    x = torch.from_numpy(panels).to(dev)
    panel_ms, panel_batch_ms = timed_h264(x, h264.QP), timed_h264(x, h264.QP, H264_BATCH)
    _, lengths = he.h264_intra(x, 0, h264.QP)
    r = readings["served chunk"]
    bound = {"chunk": r["moved"] / HBM_BYTES_PER_S * 1e3,
             "panels": (x.numel() + int(lengths.sum())) / HBM_BYTES_PER_S * 1e3}
    chunk_x = torch.from_numpy(np.ascontiguousarray(chunk)).to(dev)

    def encodes(n=4):
        for _ in range(n):
            he.encode_access_units(chunk_x, 0)
        return n

    encodes(1)
    activities, kernels, busy, top = profile_device(encodes)
    ms, panel = statistics.median(call_ms), statistics.median(panel_ms)
    print(f"[h264] {card_line()}; the kernel a chunk of 8 (median of {len(call_ms)} calls, each timed alone by "
          f"CUDA events, its host launch included, in turns with the plain version): {SIZE}^2 {ms:.4f} ms (plain "
          f"{r['plain_ms']:.1f} ms; bound {bound['chunk']:.5f} ms by bytes, {bound['chunk'] / ms:.2%}), --debug "
          f"panels {x.shape[1]}x{x.shape[2]} {panel:.4f} ms (one panel plain "
          f"{readings['--debug panel']['plain_ms']:.1f} ms; bound {bound['panels']:.5f} ms, "
          f"{bound['panels'] / panel:.2%}); the served frames {r['bytes_per_frame']:,.0f} bytes a frame against the "
          f"AVI's {SIZE * SIZE * 3:,}; 8 --debug panels composed on the host in {panel_s:.2f} s")
    print(f"[h264] {card_line()}; a second reading, launches back to back (median of {len(batch_ms)} samples of "
          f"{H264_BATCH} by CUDA events, the host's launch hidden), ms a launch: {SIZE}^2 "
          f"{statistics.median(batch_ms):.4f}, --debug panels {statistics.median(panel_batch_ms):.4f}")
    print(f"[h264] {card_line()}; encode_access_units of the served chunk under torch.profiler, a call: "
          f"{activities} device activities, {kernels} of them kernels, busy {busy} ms: "
          + ", ".join(f"{n} x{c:g} {ms:.4f} ms" for n, c, ms in top))
    return {"max_abs_err": 0, "ms": ms, "plain_ms": r["plain_ms"],
            "bound_ms": bound["chunk"], "bound_by": "bytes", "library_ms": None}


def timed_h264(x, qp: int, batch: int = 1) -> list:
    """H264_REPS samples of `batch` launches of the kernel on `x` as the mp4
    writer launches it (framed units), each sample timed by CUDA events:
    ms a launch."""
    from genefaceplusplus_tpu_torch.ops import h264_encode as he

    out = []
    for _ in range(H264_REPS):
        e0, e1 = cuda_event(), cuda_event()
        e0.record()
        for _ in range(batch):
            he.h264_intra(x, 0, qp)
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1) / batch)
    return out


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
        path = infer.infer_once({"drv_aud_features": fpath, "out_name": os.path.join(work, "long.avi")})
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


# serve_grid: a head as the reference trains it (tiledgrid, the May head's
# widths, 13,000 x 4 individual codes, grid 128) converted from the
# reference's checkpoint layout; frames at 512^2 (head-only) and the
# torso_sr frame with grid head and torso. Card against CPU: the full
# frame's bar (tests/test_torch_cuda.py::test_full_frame_on_card_matches_cpu),
# on a band of rays through the head where the whole 512^2 frame would take
# the host too long.
GRID_FRAMES, GRID_SIDE_FRAMES = 32, 8
GRID_BAND_ROWS = 128
GRID_CARD_MAX, GRID_CARD_MEAN = 2e-3, 1e-4
GRID_MARCH = {"march_mode": "grid", "num_coarse": 48, "num_samples": 16}


def grid_head_hparams(grid_type: str, sr: bool = False) -> dict:
    from genefaceplusplus_tpu_torch.models.radnerf import MAY_LM3D_RADNERF, MAY_LM3D_RADNERF_SR

    return dict(MAY_LM3D_RADNERF_SR if sr else dict(MAY_LM3D_RADNERF, with_sr=False), grid_type=grid_type)


def timed_frames(infer, ids) -> tuple:
    """(frames, ms of each frame after the first): GT-driven, one frame a
    dispatch, each drained to the host before the next starts."""
    batch = infer.prepare_gt_batch(ids)
    frames, stamps = [], []
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    for f in infer.forward_secc2video(batch, {"frames_per_dispatch": 1}):
        frames.append(f)
        stamps.append(time.perf_counter())
    return frames, [(b - a) * 1e3 for a, b in zip(stamps[1:-1], stamps[2:])]


def p90(xs) -> float:
    return float(np.percentile(xs, 90))


def frame_inputs(infer, dev) -> tuple:
    """(rays_o, rays_d, cond window, eye area, lm68) of dataset frame 0, on dev."""
    from genefaceplusplus_tpu_torch.utils.audio_features import get_audio_features_batch
    from genefaceplusplus_tpu_torch.utils.rays import pixel_rays

    ds = infer.dataset
    batch = infer.prepare_gt_batch([0])
    ro, rd = pixel_rays(torch.as_tensor(batch["poses"], device=dev), ds.intrinsics, ds.H, ds.W)
    win = get_audio_features_batch(torch.as_tensor(batch["cond"], device=dev), torch.arange(1, device=dev),
                                   infer.head_cfg.smo_win_size)[0]
    return (ro[0], rd[0], win, torch.as_tensor(batch["eye_area_percent"][:1], device=dev),
            torch.as_tensor(batch["lm68"][:1], device=dev))


def cpu_twin(module):
    twin = type(module)(module.cfg)
    twin.load_state_dict({k: v.cpu() for k, v in module.state_dict().items()})
    return twin.eval()


def band_card_vs_cpu(infer, dev, opts, what: str) -> tuple:
    """The head-only frame of dataset frame 0 on a band of GRID_BAND_ROWS
    rows through the middle of the frame, rendered by `render_full_frame`
    with the same rays on the card and on the CPU: (max, mean) |d| of the
    band's rgb, and its largest weights sum."""
    from genefaceplusplus_tpu_torch.models.full_renderer import render_full_frame

    ds = infer.dataset
    r0 = (ds.H - GRID_BAND_ROWS) // 2
    ro, rd, win, eye, _ = frame_inputs(infer, dev)
    rows = slice(r0 * ds.W, (r0 + GRID_BAND_ROWS) * ds.W)
    outs = {}
    for where, d, model in (("card", dev, infer.head_model), ("cpu", "cpu", cpu_twin(infer.head_model))):
        with torch.no_grad():
            out = render_full_frame(model, ro[rows].to(d), rd[rows].to(d), win.to(d), infer.occupancy.to(d),
                                    infer.bg_color[rows].to(d), opts, (GRID_BAND_ROWS, ds.W),
                                    eye_area_percent=eye.to(d))
        outs[where] = (out.rgb_map.cpu(), out.weights_sum.cpu())
    e = (outs["card"][0] - outs["cpu"][0]).abs()
    m, a, ws = e.max().item(), e.mean().item(), outs["cpu"][1].max().item()
    print(f"[serve_grid] {what}: card vs CPU over rows {r0}..{r0 + GRID_BAND_ROWS - 1} ({GRID_BAND_ROWS * ds.W} rays, "
          f"largest weights sum {ws:.3f}): max |d| {m:.3e} (<= {GRID_CARD_MAX}), mean {a:.3e} (<= {GRID_CARD_MEAN})")
    check(ws > 0.1, f"{what}: the band misses the head")
    check(m <= GRID_CARD_MAX and a <= GRID_CARD_MEAN, f"{what}: card vs CPU")
    return m, a


def encoder_device_ms(infer, frames) -> tuple:
    """CUDA-event ms a frame of the position and ambient grid encoders (hooks
    on the modules; each span runs from its first kernel's launch to its last
    one's end, so a host that launches slower than the card runs adds its
    gaps) over `frames` GT-driven frames, and the frames' own ms."""
    model = infer.head_model
    spans = {"position": [], "ambient": []}
    hooks = []
    for name, enc in (("position", model.position_embedder), ("ambient", model.ambient_embedder)):
        def pre(_, __, name=name):
            spans[name].append([cuda_event()])

        def post(_, __, ___, name=name):
            spans[name][-1].append(cuda_event())
        hooks += [enc.register_forward_pre_hook(pre), enc.register_forward_hook(post)]
    try:
        torch.cuda.synchronize()
        start = cuda_event()
        list(infer.forward_secc2video(infer.prepare_gt_batch(list(range(frames))), {"frames_per_dispatch": 8}))
        end = cuda_event()
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    out = {k: sum(a.elapsed_time(b) for a, b in v) / frames for k, v in spans.items()}
    return out["position"], out["ambient"], start.elapsed_time(end) / frames


def phase_serve_grid(dev, served, fourier_ms: float):
    """serve_grid (module docstring)."""
    import dataclasses

    from genefaceplusplus_tpu_torch.config import save_config
    from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset, synthetic
    from genefaceplusplus_tpu_torch.data.mp4 import read_mp4_track
    from genefaceplusplus_tpu_torch.ops import h264_encode as he
    from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer, default_inp
    from genefaceplusplus_tpu_torch.inference.serving import stream_infer
    from genefaceplusplus_tpu_torch.models.full_renderer import render_full_frame
    from genefaceplusplus_tpu_torch.models.radnerf import MAY_LM3D_RADNERF_TORSO_SR, RADNeRF, RADNeRFConfig
    from genefaceplusplus_tpu_torch.models.radnerf_torso import TorsoConfig, TorsoField
    from genefaceplusplus_tpu_torch.models.renderer import make_aabb
    from genefaceplusplus_tpu_torch.models.superresolution import Superresolution
    from genefaceplusplus_tpu_torch.ops import fused_field as ff
    from genefaceplusplus_tpu_torch.ops import raymarch
    from genefaceplusplus_tpu_torch.testing import reference_head_state, save_reference_ckpt
    from genefaceplusplus_tpu_torch.tools import convert_ckpt
    from genefaceplusplus_tpu_torch.utils import convert_torch_ckpt as cvt
    from genefaceplusplus_tpu_torch.utils.ckpt import get_last_checkpoint
    from genefaceplusplus_tpu_torch.utils.convert_jax import convert_flax_params

    work, card = served["work"], card_line()
    occ = bench_occupancy(GRID)
    ff.fused_field.launches = 0  # the grid heads run the float32 field: B1 stays idle

    # the reference's head checkpoint, converted and loaded
    hp = grid_head_hparams("tiledgrid")
    src_dir, out_dir = os.path.join(work, "released_head"), os.path.join(work, "head_converted")
    os.makedirs(src_dir)
    state = reference_head_state(hp, seed=31, occupancy=occ)
    src = os.path.join(src_dir, "model_ckpt_steps_250000.ckpt")
    save_reference_ckpt(src, state, global_step=250_000)
    save_config(dict(hp, binary_data_dir=served["binary"], video_id="May"), src_dir)
    t0 = time.perf_counter()
    path = convert_ckpt.main(["--input", src, "--type", "head", "--grid_size", str(GRID), "--out", out_dir])
    convert_ms = (time.perf_counter() - t0) * 1e3
    extra = get_last_checkpoint(out_dir)[0]["extra_state"]
    check(np.array_equal(np.asarray(extra["occupancy"]), occ), "the converted occupancy vs the ellipsoid packed "
                                                               "into the checkpoint's bitfield")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    infer = GeneFaceInfer.from_work_dirs(audio2secc_dir=served["a2m"], head_model_dir=out_dir, device=dev)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    cfg = infer.head_cfg
    expected = convert_flax_params(cvt.convert_radnerf_grid(state, GRID)["params"], RADNeRF(cfg))
    got = infer.head_model.state_dict()
    check(set(got) == set(expected) and all(torch.equal(got[k].cpu(), expected[k]) for k in got),
          "the converted head's tensors on the card vs the mapping's")
    check(cfg.grid_type == "tiledgrid" and infer.field_weights is None and infer.sr_model is None,
          "a grid head serves its float32 field")
    H, W = infer.dataset.H, infer.dataset.W
    check((H, W) == (SIZE, SIZE), f"head-only frames at {H}x{W}")
    n_rows = sum(t.shape[0] for k, t in got.items() if k.endswith("embedder.embeddings"))
    print(f"[serve_grid] a fake reference head (legacy torch.save, {len(state)} tensors, tiledgrid: grid tables of "
          f"{n_rows:,} rows, {cfg.individual_embedding_num} x {cfg.individual_embedding_dim} individual codes, grid "
          f"{cfg.grid_size}; its density_bitfield the bench's ellipsoid in morton order) -> tools/convert_ckpt.py "
          f"--type head -> {os.path.basename(path)}: occupancy equal to the ellipsoid; from_work_dirs on the card: "
          f"every head tensor equal to the mapping's; head crop {infer.head_crop}")

    # head-only frames, GT-driven; the grid encoders' device time
    ids = [i % len(infer.dataset) for i in range(GRID_FRAMES)]
    torch.cuda.reset_peak_memory_stats(dev)
    frames, ms_tiled = timed_frames(infer, ids)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    bg_u8 = (np.clip(infer.dataset.bg_img, 0.0, 1.0) * 255.0).astype(np.uint8)
    check(len(frames) == GRID_FRAMES and all(f.shape == (H, W, 3) and f.dtype == np.uint8 for f in frames),
          "tiledgrid frames")
    check(any(not np.array_equal(frames[0], f) for f in frames[1:]), "tiledgrid frames do not vary")
    head = min((np.abs(f.astype(np.int16) - bg_u8).max(axis=-1) > 8).mean() for f in frames)
    check(head > 0.02, f"head region missing: {head:.4f} of pixels differ from the background")
    pos_ms, amb_ms, frame_ms = encoder_device_ms(infer, GRID_SIDE_FRAMES)
    per_frame, kernels, busy, top = profile_request(infer, infer.prepare_gt_batch(ids[:GRID_SIDE_FRAMES]))
    band_card_vs_cpu(infer, dev, infer.render_options({}), "tiledgrid head-only")

    # one 4 s audio-driven request through infer_once (an mp4 encoded on the card), then the same through a stream
    inp = default_inp(drv_aud_features=served["request"], out_name=os.path.join(work, "grid.mp4"))
    infer.generator.manual_seed(42)
    torch.cuda.synchronize()
    he.h264_intra.launches = 0  # count only the main path's launches
    t0 = time.perf_counter()
    mp4 = infer.infer_once(inp)
    once_ms = (time.perf_counter() - t0) * 1e3
    grid_h264 = he.h264_intra.launches
    track = read_mp4_track(mp4)
    os.remove(mp4)
    infer.generator.manual_seed(42)
    direct = np.stack(list(infer.forward_secc2video(infer.forward_audio2secc(infer.prepare_batch_from_inp(inp), inp),
                                                    inp)))
    T = len(direct)
    check(grid_h264 == -(-T // 8), f"h264_intra launched {grid_h264} times for {T} frames in chunks of 8")
    encoded = [au for s in range(0, T, 8) for au in he.encode_access_units(torch.from_numpy(direct[s:s + 8]).to(dev), s)]
    differ = [i for i in range(T) if i >= len(track.samples) or track.samples[i] != encoded[i]]
    check((len(track.samples), track.height, track.width) == (T, H, W) and not differ,
          f"infer_once's mp4 vs the kernel's encode of the direct frames: {differ[:10]}")
    feats = np.load(served["request"], allow_pickle=True).tolist()
    t0 = time.perf_counter()
    stamps, streamed = [], []
    for f in stream_infer(infer, served["wav"], {"hubert_full": feats["hubert"]}, chunk_seconds=STREAM_CHUNK_SECONDS):
        stamps.append(time.perf_counter())
        streamed.append(f)
    tail = len(served["wav"]) - len(streamed) * 2 * 320
    check(0 <= tail < 16000 // 5 and all(f.shape == (H, W, 3) for f in streamed),
          f"{len(streamed)} streamed frames for {len(served['wav'])} samples (drift)")
    check(any(not np.array_equal(streamed[0], f) for f in streamed[1:]), "streamed frames do not vary")
    print(f"[serve_grid] audio-driven (the serve_cli a2m, 4 s): infer_once {T} frames of {H}x{W} in {once_ms:.1f} ms "
          f"({once_ms / T:.3f} ms a frame), the mp4's samples equal to the kernel's encode of the direct frames ({grid_h264} h264_intra "
          f"launches); stream_infer "
          f"({STREAM_CHUNK_SECONDS} s chunks) {len(streamed)} frames, first frame {(stamps[0] - t0) * 1e3:.1f} ms, "
          f"{(stamps[-1] - t0) * 1e3 / len(streamed):.3f} ms a frame")

    # grid-mode marching: one frame on the card, the masks and a band against the CPU
    gopts = dataclasses.replace(infer.render_options({}), **GRID_MARCH)
    ro, rd, win, eye, _ = frame_inputs(infer, dev)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = render_full_frame(infer.head_model, ro, rd, win, infer.occupancy, infer.bg_color, gopts, (H, W),
                                eye_area_percent=eye)
        torch.cuda.synchronize()
        march_ms = (time.perf_counter() - t0) * 1e3
        check(bool(torch.isfinite(out.rgb_map).all()) and out.weights_sum.max().item() > 0.1, "the grid-mode frame")
        masks = []
        for d, o in ((dev, infer.occupancy), ("cpu", infer.occupancy.cpu())):
            nears, fars = raymarch.near_far_from_aabb(ro.to(d), rd.to(d), make_aabb(cfg.bound, device=d),
                                                      cfg.min_near)
            masks.append(raymarch.march_rays(ro.to(d), rd.to(d), nears, fars, o, cfg.bound, gopts.dt_gamma,
                                             gopts.max_steps, gopts.num_coarse, gopts.num_samples).mask.cpu())
    agree = (masks[0] == masks[1]).all(dim=1).float().mean().item()
    print(f"[serve_grid] grid-mode marching ({GRID_MARCH}): one {H}x{W} frame in {march_ms:.1f} ms, "
          f"{int(masks[0].sum()):,} live samples; sample masks card vs CPU agree on {100.0 * agree:.4f} % of rays")
    band_card_vs_cpu(infer, dev, gopts, "grid-mode marching")

    # the same head as hashgrid
    hcfg = RADNeRFConfig.from_hparams(grid_head_hparams("hashgrid"))
    hstate = reference_head_state(grid_head_hparams("hashgrid"), seed=32, occupancy=occ)
    hinfer = GeneFaceInfer(hcfg, convert_flax_params(cvt.convert_radnerf_grid(hstate, GRID)["params"], RADNeRF(hcfg)),
                           infer.dataset, occ, device=dev)
    hframes, ms_hash = timed_frames(hinfer, ids[:GRID_SIDE_FRAMES])
    check(len(hframes) == GRID_SIDE_FRAMES and any(not np.array_equal(hframes[0], f) for f in hframes[1:]),
          "hashgrid frames")
    band_card_vs_cpu(hinfer, dev, hinfer.render_options({}), "hashgrid head-only")
    del hinfer

    # the torso_sr frame: a tiledgrid head in the SR config (256^2 raw), a tiledgrid torso, bf16 SR
    scfg = RADNeRFConfig.from_hparams(grid_head_hparams("tiledgrid", sr=True))
    sstate = reference_head_state(grid_head_hparams("tiledgrid", sr=True), seed=33, occupancy=occ)
    tcfg = TorsoConfig.from_hparams(dict(MAY_LM3D_RADNERF_TORSO_SR, grid_type="tiledgrid"))
    torso = TorsoField(tcfg, generator=torch.Generator().manual_seed(34))
    with torch.no_grad():
        torso.torso_embedder.embeddings.mul_(1000.0)  # a trained table's scale, not the init's 1e-4
    sr = Superresolution(3, 256, generator=torch.Generator().manual_seed(35))
    sds = RADNeRFDataset(synthetic(num_frames=24, H=SIZE, W=SIZE, seed=0), smo_win_size=scfg.smo_win_size,
                         with_sr=True)
    sinfer = GeneFaceInfer(scfg, convert_flax_params(cvt.convert_radnerf_grid(sstate, GRID)["params"], RADNeRF(scfg)),
                           sds, occ, device=dev, torso_cfg=tcfg, torso_params=torso.state_dict(),
                           sr_params=sr.state_dict(), torso_occupancy_2d=bench_torso_grid(tcfg.grid_size))
    sframes, ms_sr = timed_frames(sinfer, ids[:GRID_SIDE_FRAMES])
    check(len(sframes) == GRID_SIDE_FRAMES and all(f.shape == (2 * sds.H, 2 * sds.W, 3) for f in sframes)
          and any(not np.array_equal(sframes[0], f) for f in sframes[1:]), "grid torso_sr frames")
    ro, rd, win, eye, lm68 = frame_inputs(sinfer, dev)
    outs = {}
    for where, d in (("card", dev), ("cpu", "cpu")):
        head, tor = (sinfer.head_model, sinfer.torso_model) if where == "card" else (cpu_twin(sinfer.head_model),
                                                                                      cpu_twin(sinfer.torso_model))
        sr32 = Superresolution(3, 256).to(d)  # float32, as the CPU runs it
        sr32.load_state_dict(sinfer.sr_model.state_dict())
        with torch.no_grad():
            o = render_full_frame(head, ro.to(d), rd.to(d), win.to(d), sinfer.occupancy.to(d), sinfer.bg_color.to(d),
                                  sinfer.render_options({}), (sds.H, sds.W), eye_area_percent=eye.to(d),
                                  torso_model=tor, bg_coords=sinfer.bg_coords.to(d), lm68=lm68.to(d),
                                  occupancy_2d=sinfer.torso_occupancy_2d.to(d), sr_model=sr32,
                                  torso_crop=sinfer.torso_crop)
        outs[where] = {k: getattr(o, k).cpu() for k in ("rgb_map", "torso_alpha", "sr_rgb_map")}
    errs = {k: ((outs["card"][k] - v).abs().max().item(), (outs["card"][k] - v).abs().mean().item())
            for k, v in outs["cpu"].items()}
    print(f"[serve_grid] grid torso_sr frame (raw {sds.H}x{sds.W}, float32 SR), card vs CPU: "
          + ", ".join(f"{k} max |d| {m:.3e} mean {a:.3e}" for k, (m, a) in errs.items())
          + f" (frames <= {GRID_CARD_MAX}, {GRID_CARD_MEAN})")
    for k in ("rgb_map", "sr_rgb_map"):
        check(errs[k][0] <= GRID_CARD_MAX and errs[k][1] <= GRID_CARD_MEAN, f"grid torso_sr card vs CPU {k}")
    del sinfer

    launches = ff.fused_field.launches
    check(launches == 0, f"serve_grid launched the fused field {launches} times")
    print(f"[serve_grid] {card}; convert {convert_ms:.1f} ms (host), from_work_dirs {load_ms:.1f} ms")
    print(f"[serve_grid] {card}; ms a frame (host wall, one frame a dispatch, median / p90): tiledgrid head-only "
          f"{statistics.median(ms_tiled):.3f} / {p90(ms_tiled):.3f} ({GRID_FRAMES} frames), hashgrid head-only "
          f"{statistics.median(ms_hash):.3f} / {p90(ms_hash):.3f}, grid torso_sr {statistics.median(ms_sr):.3f} / "
          f"{p90(ms_sr):.3f} ({GRID_SIDE_FRAMES} frames each); the Fourier head-only frame of this call (serve, 8 "
          f"a dispatch) {fourier_ms:.3f}")
    print(f"[serve_grid] {card}; the grid encoders by CUDA events, tiledgrid head-only, 8 a dispatch: position "
          f"{pos_ms:.3f} ms a frame, ambient {amb_ms:.3f}, together {pos_ms + amb_ms:.3f} of the frame's "
          f"{frame_ms:.3f} ms")
    if per_frame is None:
        print(f"[serve_grid] profiler: no device activity recorded; kernels a frame not measured; peak memory "
              f"{peak:.2f} GiB")
    else:
        print(f"[serve_grid] profiler over {GRID_SIDE_FRAMES} tiledgrid frames: {kernels:.1f} kernels a frame, device "
              f"busy {busy:.3f} ms a frame; peak memory {peak:.2f} GiB (one frame a dispatch)")
        for name, count, ms in top[:6]:
            print(f"[serve_grid] profiler top kernel: {ms:.4f} ms a frame in {count:.1f} launches: {name}")
    return grid_h264


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


def phase_serve_app(dev, served) -> tuple:
    """serve_app (module docstring); returns its B1 and h264_intra launches."""
    import threading

    from genefaceplusplus_tpu_torch.data.audio import pcm16
    from genefaceplusplus_tpu_torch.data.image_io import jpeg_bytes, read_jpeg
    from genefaceplusplus_tpu_torch.data.mp4 import read_mp4_track
    from genefaceplusplus_tpu_torch.inference import app
    from genefaceplusplus_tpu_torch.inference.metrics import METRICS
    from genefaceplusplus_tpu_torch.inference.serving import stream_infer
    from genefaceplusplus_tpu_torch.ops import fused_field as ff
    from genefaceplusplus_tpu_torch.ops import h264_encode as he

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
        ff.fused_field.launches = he.h264_intra.launches = 0  # count only the main path's launches
        ws, ws_times, ws_sent = _ws_stream(port, dict(inp, push_queue_frames=4 * T))
        mj, mj_times, mj_sent = _mjpeg_stream(port, _multipart("/stream", {"temperature": "0"}, upload))
        t0 = time.perf_counter()
        status, headers, body = _http(port, _multipart("/infer", {"temperature": "0"}, upload))
        infer_ms = (time.perf_counter() - t0) * 1e3
        launches, h264_launches = ff.fused_field.launches, he.h264_intra.launches
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
    out = os.path.join(served["work"], "reply.mp4")
    with open(out, "wb") as f:
        f.write(body)
    track = read_mp4_track(out)
    os.remove(out)
    t_once = HUBERT_FRAMES // 2  # infer_once's frames: the whole clip, where the stream trims each chunk
    shape = (len(track.samples), track.height, track.width)
    check(status == "HTTP/1.0 200 OK" and headers["Content-Type"] == "video/mp4"
          and shape == (t_once, 2 * infer.dataset.H, 2 * infer.dataset.W) and track.fps == 25.0
          and np.array_equal(track.pcm, pcm16(served["wav"])), f"POST /infer: {status}, {shape}")
    check(launches == 2 * T + t_once, f"{launches} fused_field launches for 2 x {T} + {t_once} frames")
    check(h264_launches == -(-t_once // 8), f"h264_intra launched {h264_launches} times for {t_once} frames")
    worst = math.inf
    for got in (ws, mj):
        for jpg, ref in zip(got, direct):
            if jpg != ref:
                worst = min(worst, psnr(read_jpeg(jpg), read_jpeg(ref), 255.0))
    equal = [sum(a == b for a, b in zip(got, direct)) for got in (ws, mj)]
    print(f"[serve_app] inference/app.py on 127.0.0.1:{port} over serve_cli's GeneFaceInfer, {AUDIO_SECONDS:g} s "
          f"request at temperature 0: WebSocket {len(ws)} and MJPEG {len(mj)} frames, byte-equal to jpeg_bytes of a direct "
          f"stream_infer's: {equal[0]}/{T} and {equal[1]}/{T}; the others decoded vs the direct ones' decodes: "
          f"worst PSNR {worst:.2f} dB; POST /infer: an mp4 of {len(body):,} bytes, "
          f"{len(track.samples)} frames, the PCM, {h264_launches} h264_intra launches; GET /metrics parses ({metrics['streams']['completed']} streams "
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
    return launches, h264_launches


# hubert: facebook/hubert-large-ls960-ft's architecture at full width (1024
# wide, 24 layers, 16 heads, FFN 4096, conv_dim 512 x 7, positional kernel
# 128 in 16 groups, layer-norm extractor, stable LayerNorm), seeded weights
# written as the released checkpoint lays them out. Card vs CPU on a 2 s
# wav: both float32 runs against a CPU float64 run of the same module and
# input, the card's distance from it within HUBERT_ORDER_K x the CPU
# float32's + HUBERT_FLOOR of the largest |feature| (the rule of
# train_disc's feature-matching gradients and of the fit). A 45 s wav
# crosses two window seams; each window's rows are held to that window
# run again alone, to HUBERT_SEAM_REL of the largest |feature| (the same
# products on the same card, at another address). The bound counts the
# products' and convolutions' multiply-adds (2 FLOPs each) at the H100's
# float32 peak outside the tensor cores (TF32 is off), against the
# weights, input and output bytes at its HBM rate.
HUBERT_SEED = 11
HUBERT_SHORT_SECONDS, HUBERT_LONG_SECONDS = 2.0, 45.0
HUBERT_REQUEST_SECONDS, HUBERT_STREAM_SECONDS, HUBERT_ONBOARD_SECONDS = 4.0, 6.0, 3.0
HUBERT_REPS, HUBERT_CPU_REPS = 10, 3
HUBERT_ORDER_K, HUBERT_FLOOR, HUBERT_SEAM_REL = 4.0, 1e-5, 1e-5
PEAK_FP32_FLOPS = 67e12


def hubert_work(cfg, n: int, params: int) -> tuple:
    """(FLOPs, bytes) of one HuBERT window of `n` samples: the
    convolutions', products' and attention's multiply-adds x 2; the weights,
    the input and the output in float32, each moved once."""
    t, c_in, flops = n, 1, 0
    for c, k, s in zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride):
        t = (t - k) // s + 1
        flops += 2 * t * c * c_in * k
        c_in = c
    h, inter = cfg.hidden_size, cfg.intermediate_size
    flops += 2 * t * c_in * h  # the feature projection
    flops += 2 * t * h * (h // cfg.num_conv_pos_embedding_groups) * cfg.num_conv_pos_embeddings
    flops += cfg.num_hidden_layers * (2 * t * 4 * h * h + 2 * t * 2 * h * inter + 2 * 2 * t * t * h)
    return flops, 4 * (params + n + t * h)


def phase_hubert(dev, served) -> int:
    """hubert (module docstring); returns its B1 launches."""
    import copy

    from genefaceplusplus_tpu_torch.data import audio
    from genefaceplusplus_tpu_torch.data.process import step_audio
    from genefaceplusplus_tpu_torch.data.video import read_avi
    from genefaceplusplus_tpu_torch.inference import cli
    from genefaceplusplus_tpu_torch.inference.pipeline import default_inp
    from genefaceplusplus_tpu_torch.inference.serving import stream_infer
    from genefaceplusplus_tpu_torch.models.hubert import HUBERT_LARGE_LS960_FT, HUBERT_PREPROCESSOR
    from genefaceplusplus_tpu_torch.ops import fused_field as ff
    from genefaceplusplus_tpu_torch.testing import write_hubert_snapshot

    card, work, infer = card_line(), served["work"], served["infer"]
    cache = tempfile.mkdtemp(prefix="chip_smoke_hub_")
    prev_cache = os.environ.get("HF_HUB_CACHE")
    os.environ["HF_HUB_CACHE"] = cache
    try:
        t0 = time.perf_counter()
        snap = write_hubert_snapshot(cache, audio.HUBERT_MODEL, HUBERT_LARGE_LS960_FT, HUBERT_PREPROCESSOR,
                                     seed=HUBERT_SEED)
        write_s = time.perf_counter() - t0
        check(audio.hubert_available(), "the written snapshot is not found")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, do_normalize = audio.load_hubert(device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        cfg = model.cfg
        params = sum(p.numel() for p in model.parameters())
        check(next(model.parameters()).device.type == "cuda" and do_normalize, "HuBERT on the card, normalising")
        t0 = time.perf_counter()
        cpu32, _ = audio.load_hubert(device="cpu")
        cpu64 = copy.deepcopy(cpu32).double()
        cpu_load_s = time.perf_counter() - t0
        print(f"[hubert] {audio.HUBERT_MODEL}'s architecture, seeded (seed {HUBERT_SEED}): {params} parameters, "
              f"{cfg.num_hidden_layers} layers x {cfg.hidden_size}, {cfg.num_attention_heads} heads, FFN "
              f"{cfg.intermediate_size}; pytorch_model.bin ({os.path.getsize(os.path.join(snap, 'pytorch_model.bin')) / 2 ** 30:.2f} "
              f"GiB, hubert. keys, lm_head, weight_g/weight_v) written in {write_s:.1f} s; loaded on the card "
              f"{load_s:.1f} s, on the CPU (float32 and a float64 copy) {cpu_load_s:.1f} s")

        def normalised(wav):
            x = np.asarray(wav, np.float32)
            return (x - x.mean()) / np.sqrt(x.var() + 1e-7)

        # card vs CPU on a 2 s wav, both against the CPU's float64
        wav2 = voiced_wav(HUBERT_SHORT_SECONDS, 110.0, 190.0, seed=21)
        got = audio.get_hubert_from_16k_speech(wav2, device=dev)
        t0 = time.perf_counter()
        cpu = audio.get_hubert_from_16k_speech(wav2, device="cpu")
        cpu_wall_ms = (time.perf_counter() - t0) * 1e3
        with torch.no_grad():
            ref64 = cpu64(torch.from_numpy(normalised(wav2)).double()[None])[0].numpy()
        scale = float(np.abs(ref64).max())
        d_card = float(np.abs(got - ref64).max()) / scale
        d_cpu = float(np.abs(cpu - ref64).max()) / scale
        d_pair = float(np.abs(got - cpu).max()) / scale
        n_frames = (len(wav2) - 80) // 320
        check(got.shape == (n_frames, cfg.hidden_size) and got.dtype == np.float32 and np.isfinite(got).all(),
              f"HuBERT features {got.shape} {got.dtype} for {len(wav2)} samples")
        print(f"[hubert] {HUBERT_SHORT_SECONDS} s wav ({n_frames} frames, |feature| up to {scale:.4f}): max |d| / max "
              f"|float64| card {d_card:.3e}, CPU float32 {d_cpu:.3e} (card <= {HUBERT_ORDER_K} x CPU + "
              f"{HUBERT_FLOOR}); card vs CPU {d_pair:.3e}")
        check(d_card <= HUBERT_ORDER_K * d_cpu + HUBERT_FLOOR, "HuBERT on the card vs the CPU's float64")

        # 45 s: two window seams and a tail; each window against itself run alone
        wav45 = voiced_wav(HUBERT_LONG_SECONDS, 100.0, 240.0, seed=22)
        t0 = time.perf_counter()
        long = audio.get_hubert_from_16k_speech(wav45, device=dev)
        long_ms = (time.perf_counter() - t0) * 1e3
        windows, expected_T = audio.hubert_windows(len(wav45))
        check(long.shape == (expected_T, cfg.hidden_size) and np.isfinite(long).all(),
              f"45 s features {long.shape}, {expected_T} frames expected")
        x45 = torch.from_numpy(normalised(wav45)).to(dev)
        row, seam_err = 0, 0.0
        with torch.no_grad():
            for s, e in windows:
                alone = model(x45[s:e].clone()[None])[0].cpu().numpy()
                seam_err = max(seam_err, float(np.abs(long[row:row + len(alone)] - alone).max()))
                row += len(alone)
        seam_err /= float(np.abs(long).max())
        check(len(windows) == 3 and row == expected_T, f"windows {windows} give {row} frames, {expected_T} expected")
        print(f"[hubert] {HUBERT_LONG_SECONDS} s wav: {expected_T} frames from windows {windows} (seams at frames "
              f"1000 and 2000), all finite, {long_ms:.1f} ms host wall; each window's rows vs the window run "
              f"alone: max |d| / max {seam_err:.3e} (<= {HUBERT_SEAM_REL})")
        check(seam_err <= HUBERT_SEAM_REL, "HuBERT window seams vs each window alone")

        # timing: a 2 s chunk and a whole 20 s window on the card, the CPU's float32 beside
        x2 = torch.from_numpy(normalised(wav2)).to(dev)[None]
        x20 = x45[windows[0][0]:windows[0][1]][None]
        with torch.no_grad():
            for _ in range(2):
                model(x2), model(x20)
            ms2 = cuda_ms(lambda: model(x2), HUBERT_REPS)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ms20 = cuda_ms(lambda: model(x20), HUBERT_REPS)
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            events, kernels, busy, top = profile_device(lambda: (model(x2), 1)[1])
            x2c, x20c = x2.cpu(), x20.cpu()
            cpu_ms2, cpu_ms20 = [], []
            for _ in range(HUBERT_CPU_REPS):
                t0 = time.perf_counter()
                cpu32(x2c)
                cpu_ms2.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            cpu32(x20c)
            cpu_ms20.append((time.perf_counter() - t0) * 1e3)
        walls = []
        for _ in range(HUBERT_REPS):
            t0 = time.perf_counter()
            audio.get_hubert_from_16k_speech(wav2, device=dev)
            walls.append((time.perf_counter() - t0) * 1e3)
        for what, n, ms in (("2 s chunk", x2.shape[1], ms2), ("20 s window", x20.shape[1], ms20)):
            flops, nbytes = hubert_work(cfg, n, params)
            ops_ms, bytes_ms = flops / PEAK_FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
            bound = max(ops_ms, bytes_ms)
            print(f"[hubert] {card}; {what} ({n} samples): {statistics.median(ms):.3f} ms on the card by CUDA "
                  f"events (median of {len(ms)}, min {min(ms):.3f}, max {max(ms):.3f}); bound {bound:.3f} ms by "
                  f"{'operations' if ops_ms >= bytes_ms else 'bytes'} ({flops / 1e9:.1f} GFLOP at 67 TFLOP/s float32 "
                  f"{ops_ms:.3f} ms, {nbytes / 1e9:.3f} GB at 3.35 TB/s {bytes_ms:.3f} ms): "
                  f"{100 * bound / statistics.median(ms):.1f} % of it, {flops / statistics.median(ms) / 1e9:.1f} "
                  f"TFLOP/s")
        print(f"[hubert] {card}; CPU float32 ({torch.get_num_threads()} threads): 2 s chunk "
              f"{', '.join(f'{x:.1f}' for x in cpu_ms2)} ms, 20 s window {cpu_ms20[0]:.1f} ms; "
              f"get_hubert_from_16k_speech on the 2 s wav, host wall: card {statistics.median(walls):.3f} ms "
              f"(median of {len(walls)}, min {min(walls):.3f}, max {max(walls):.3f}), CPU {cpu_wall_ms:.1f} ms; peak "
              f"memory over the 20 s window {peak:.2f} GiB above the {base / 2 ** 30:.2f} GiB held")
        if kernels is None:
            print("[hubert] profiler: no device activity recorded; kernels a chunk not measured")
        else:
            print(f"[hubert] profiler, one 2 s chunk: {kernels:.0f} kernels ({events:.0f} device activities), "
                  f"device busy {busy:.3f} ms")
            for name, count, ms in top[:5]:
                print(f"[hubert] profiler top kernel: {ms:.4f} ms in {count:.0f} launches: {name}")

        # a bare wav through the CLI, and through the direct GeneFaceInfer for the same draw
        req = os.path.join(work, "hubert_request.wav")
        audio.save_wav_16k(voiced_wav(HUBERT_REQUEST_SECONDS, 120.0, 200.0, seed=23), req)
        torch.cuda.synchronize()
        ff.fused_field.launches = 0  # count only the main path's launches
        t0 = time.perf_counter()
        out = cli.main(["--a2m_ckpt", served["a2m"], "--torso_ckpt", served["torso"], "--drv_aud", req,
                        "--out_name", os.path.join(work, "hubert_cli.avi")])
        cli_ms = (time.perf_counter() - t0) * 1e3
        cli_launches = ff.fused_field.launches
        frames, pcm = read_avi(out)
        padded, _ = audio.extract_mel(audio.load_wav_16k(req))
        T = (len(padded) - 80) // 320 // 8 * 8 // 2
        H, W = 2 * infer.dataset.H, 2 * infer.dataset.W
        check(frames.shape == (T, H, W, 3), f"CLI frames {frames.shape}, {T} expected")
        check(np.array_equal(pcm, audio.pcm16(padded)), "the CLI's AVI audio vs pcm16 of the padded wav")
        check(cli_launches == T, f"fused_field launched {cli_launches} times for {T} CLI frames")
        check(any(not np.array_equal(frames[0], f) for f in frames[1:]), "CLI frames do not vary")
        infer.generator.manual_seed(42)  # the CLI's GeneFaceInfer draws from a fresh generator seeded 42
        inp = default_inp(drv_aud=req)
        batch = infer.forward_audio2secc(infer.prepare_batch_from_inp(inp), inp)
        ref = np.stack(list(infer.forward_secc2video(batch, inp)))
        check(batch["hubert"].shape == (2 * T, cfg.hidden_size) and np.isfinite(batch["hubert"]).all(),
              f"the request's features {batch['hubert'].shape}")
        check(np.isfinite(batch["cond"]).all() and batch["cond"].shape == (T, 1, 204), "condition")
        differ = [i for i in range(T) if not np.array_equal(frames[i], ref[i])]
        check(not differ, f"the CLI's frames {differ[:10]} vs the direct GeneFaceInfer's for the same wav and draw")
        p_plain = psnr(plain_first_frame(infer, batch, dev), frames[0], 255.0)
        check(p_plain >= PLAIN_FRAME_MIN_PSNR, "the bare-wav CLI frame vs its plain-field frame")
        print(f"[hubert] {card}; CLI on a bare {HUBERT_REQUEST_SECONDS} s wav (--drv_aud): {T} frames of {H}x{W}, "
              f"{cli_launches} fused_field launches, equal to the direct GeneFaceInfer's bit for bit, PCM equal to "
              f"the padded wav's, frame 1 vs the plain field PSNR {p_plain:.2f} dB (>= {PLAIN_FRAME_MIN_PSNR}); wall "
              f"{cli_ms:.1f} ms (work-dir load, HuBERT, audio2secc, render, AVI)")

        # a bare wav streamed: HuBERT per chunk, no inp['hubert_full']
        swav = voiced_wav(HUBERT_STREAM_SECONDS, 110.0, 220.0, seed=24)
        chunk_ms, chunk_T = [], []
        compute = audio.get_hubert_from_16k_speech

        def timed_hubert(wav, *a, **kw):
            start = time.perf_counter()
            out = compute(wav, *a, **kw)
            chunk_ms.append((time.perf_counter() - start) * 1e3)
            chunk_T.append((len(out), (len(wav) - 80) // 320, bool(np.isfinite(out).all())))
            return out

        audio.get_hubert_from_16k_speech = timed_hubert
        try:
            torch.cuda.synchronize()
            ff.fused_field.launches = 0
            stamps = []
            t0 = time.perf_counter()
            for f in stream_infer(infer, swav, {}, chunk_seconds=STREAM_CHUNK_SECONDS):
                check(f.shape == (H, W, 3) and f.dtype == np.uint8, f"streamed frame {f.shape} {f.dtype}")
                stamps.append(time.perf_counter())
            stream_launches = ff.fused_field.launches
        finally:
            audio.get_hubert_from_16k_speech = compute
        n = len(stamps)
        tail = len(swav) - n * 2 * 320
        check(all(t == want and ok for t, want, ok in chunk_T), f"per-chunk features {chunk_T}")
        check(0 <= tail < 16000 // 5, f"{n} frames for {len(swav)} samples: {tail} samples unconsumed (drift)")
        check(stream_launches == n, f"fused_field launched {stream_launches} times for {n} streamed frames")
        print(f"[hubert] {card}; stream_infer on a bare {HUBERT_STREAM_SECONDS} s wav in {STREAM_CHUNK_SECONDS} s "
              f"chunks: {n} frames, {len(chunk_ms)} chunks of HuBERT ({', '.join(str(t[0]) for t in chunk_T)} "
              f"frames), {tail} samples unconsumed, {stream_launches} fused_field launches; time to first frame "
              f"{(stamps[0] - t0) * 1e3:.1f} ms; HuBERT host wall a chunk {', '.join(f'{x:.1f}' for x in chunk_ms)} "
              f"ms (from chunk 2 on it waits for the last chunk's render, queued before it)")

        # onboarding: step_audio writes aud_hubert.npy
        proc = os.path.join(work, "hubert_onboard")
        os.makedirs(proc)
        audio.save_wav_16k(voiced_wav(HUBERT_ONBOARD_SECONDS, 130.0, 170.0, seed=25), os.path.join(proc, "aud.wav"))
        t0 = time.perf_counter()
        step_audio(proc, device=dev)
        step_s = time.perf_counter() - t0
        written = np.load(os.path.join(proc, "aud_hubert.npy"))
        padded, _ = audio.extract_mel(audio.load_wav_16k(os.path.join(proc, "aud.wav")))
        check(np.array_equal(written, audio.get_hubert_from_16k_speech(padded, device=dev)),
              "aud_hubert.npy vs HuBERT of the step's padded wav")
        print(f"[hubert] step_audio on a {HUBERT_ONBOARD_SECONDS} s aud.wav: aud_hubert.npy {written.shape} "
              f"{written.dtype}, equal to HuBERT of the padded wav; {step_s:.2f} s")
        return cli_launches + stream_launches
    finally:
        if prev_cache is None:
            os.environ.pop("HF_HUB_CACHE", None)
        else:
            os.environ["HF_HUB_CACHE"] = prev_cache
        audio._HUBERT_CACHE.clear()
        shutil.rmtree(cache, ignore_errors=True)
        torch.cuda.empty_cache()


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
    clean = clean_points(fk, fp).nonzero().flatten()
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


def phase_kernel_bwd(dev, train_extra_ms: float):
    from genefaceplusplus_tpu_torch.ops import fused_field as ff

    args = bwd_inputs(dev)
    xyz, dirs, ab, cb, w, g_sigma, g_rgb, g_amb = args
    grads = (g_sigma, g_rgb, g_amb)
    n = xyz.shape[0]
    g = torch.Generator(device=dev).manual_seed(3)
    with torch.no_grad():
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
    ref = parent_reference()
    now, parent = digest(kern), str(ref["fused_field_backward"])
    print(f"[kernel_bwd] gradients sha256 {now}; the chain that recomputed the forward ({parent}): "
          f"{'bit-identical' if now == parent else 'different'}")
    if now != parent:
        apart = []
        for (name, _, (r, c)), k in zip(ff.GRAD_BLOCKS, kern):
            cos, ratio, rel = grad_stats(k[:r, :c], torch.from_numpy(ref[name]).to(dev))
            apart.append(f"{name} cos {cos:.8f} |r-1| {abs(ratio - 1.0):.2e} max|d|/max {rel:.3e}")
        print("[kernel_bwd] against the chain that recomputed the forward: " + "; ".join(apart))
    del kern, again, permuted, plain

    with torch.no_grad():
        # the train mode's buffers, then the chain alone on them
        fwd = ff.fused_field_forward_train(xyz, dirs, ab, cb, w)
        ops = ff.fused_field_bwd_chain(xyz, fwd, w, *grads)
        plain_fwd = ff.fused_field_train_plain(xyz, dirs, ab, cb, w)
        plain_grads = ff.fused_field_chain_plain(xyz, plain_fwd, w, *grads)
        unpacked = ff.unpack_operands(ops, n)
        clean = clean_points(fwd[:3], plain_fwd[:3])
        n_c, n_agree, rel, share, chain_abs = operand_witness(unpacked, plain_grads, ff.OPERAND_WRITERS["fused_field_bwd"],
                                                   clean, ff.unpack_relu_masks(fwd.relu, n), plain_fwd.relu)
        padded = ff.unpack_operands(ops, ff.operand_points(n))
        check(all(not padded[k][n:].float().any() for k, _ in ff.WGRAD_OPERANDS), "operands past n are not zero")
        del padded
        print(f"[kernel_bwd] chain's gradient operands vs fused_field_chain_plain: {n_c} clean points, {n_agree} "
              f"with the plain version's ReLU masks; max |chain - plain| / max |plain| there: "
              + ", ".join(f"{k_}={v:.2e}" for k_, v in rel.items())
              + "; share of clean entries that differ: " + ", ".join(f"{k_}={v:.4f}" for k_, v in share.items()))
        check(n_agree >= CHAIN_MASKS_AGREE * n_c and all(v <= CHAIN_MAX_REL for v in rel.values()),
              "chain operands vs plain")
        again = ff.fused_field_bwd_chain(xyz, fwd, w, *grads).clone()
        check(torch.equal(again, ops), "the chain's operands differ between two launches on one buffer")
        del again, plain_grads

        # the weight-gradient kernel alone, on the operands
        wk, wp = ff.fused_field_wgrad(ops, n), ff.fused_field_wgrad_plain(unpacked)
        torch.cuda.synchronize()
        wgrad_err, wgrad_rel = 0.0, 0.0
        for (name, _, _), a, b in zip(ff.GRAD_BLOCKS, wk, wp):
            check(bool(torch.isfinite(a).all()), f"non-finite weight gradient {name}")
            d = (a - b).abs().max().item()
            r = d / max(b.abs().max().item(), 1e-30)
            wgrad_err, wgrad_rel = max(wgrad_err, d), max(wgrad_rel, r)
            check(r <= WGRAD_MAX_REL, f"weight-gradient kernel vs plain {name}: {r:.3e}")
        print(f"[kernel_bwd] weight-gradient kernel vs plain on the operands: every block within "
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
            "chain": (lambda: ff.fused_field_bwd_chain(xyz, fwd, w, *grads),
                      lambda: ff.fused_field_chain_plain(xyz, plain_fwd, w, *grads)),
            "wgrad": (lambda: ff.fused_field_wgrad(ops, n), lambda: ff.fused_field_wgrad_plain(unpacked)),
            "backward": (lambda: ff.fused_field_backward(*args), lambda: ff.fused_field_backward_plain(*args)),
        }
        times = {key: timed_in_turns(run_kernel, run_plain, 3) for key, (run_kernel, run_plain) in timings.items()}
        cuda_ms(run_library, 2)
        t_lib = []
        for _ in range(3):  # in turns with the kernel
            t_lib += cuda_ms(run_library, 1)
            times["wgrad"][0].extend(cuda_ms(timings["wgrad"][0], 1))
        del ops, unpacked, X, gc1, u, fwd, plain_fwd
    chain_ptxas = ptxas_report(ff.build_kernels(["fused_field_bwd"])["fused_field_bwd"])
    cfg = ff.chain_config(ff._library("fused_field_bwd"))
    print(f"[kernel_bwd] {card_line()}; chain: {cfg['consumers']} consumer warpgroups of {cfg['tile']} points and "
          f"one producer warpgroup a block, one block an SM, {cfg['stages']} weight-ring stages, "
          f"{cfg['smem_bytes']} bytes of dynamic shared memory a block, {cfg['launch_regs']} registers a thread at "
          f"launch, {cfg['consumer_regs']} a consumer after setmaxnreg; ptxas: "
          + "; ".join(x for x in chain_ptxas if "Compiling" not in x))
    check(not any(int(v) for x in chain_ptxas for v in re.findall(r"(\d+) bytes spill", x)), "the chain spills")
    print(f"[kernel_bwd] times at {n} points, medians in turns with the plain versions:")
    for key, (t_k, t_p) in times.items():
        print(f"[kernel_bwd] {key}: kernel {med(t_k)}; plain {med(t_p)}")
    ms, plain_ms = statistics.median(times["backward"][0]), statistics.median(times["backward"][1])
    bound_ms, bound_by = kernel_bound(n, BWD_MACS, BWD_BYTES, 4 * ff.PACKED_SIZE)
    w_ms, w_plain_ms = statistics.median(times["wgrad"][0]), statistics.median(times["wgrad"][1])
    w_bound_ms, w_bound_by = kernel_bound(n, WGRAD_MACS, WGRAD_BYTES, 4 * ff.PACKED_SIZE)
    library_ms = statistics.median(t_lib)
    c_ms, c_plain_ms = statistics.median(times["chain"][0]), statistics.median(times["chain"][1])
    c_bound_ms, c_bound_by = kernel_bound(n, CHAIN_MACS, CHAIN_BYTES)
    print(f"[kernel_bwd] backward (train mode + chain + weight gradients) bound {bound_ms:.4f} ms ({bound_by}): "
          f"{100.0 * bound_ms / ms:.1f} % of the bound; B2 as the train mode's extra over serving "
          f"({train_extra_ms:.4f} ms) + chain + weight gradients: {train_extra_ms + c_ms + w_ms:.4f} ms")
    print(f"[kernel_bwd] chain bound {c_bound_ms:.4f} ms ({c_bound_by}; operations "
          f"{kernel_bound(n, CHAIN_MACS, 0)[0]:.4f} ms): {100.0 * c_bound_ms / c_ms:.1f} % of the bound")
    print(f"[kernel_bwd] weight-gradient kernel bound {w_bound_ms:.4f} ms ({w_bound_by}): "
          f"{100.0 * w_bound_ms / w_ms:.1f} % of the bound; bf16 torch.matmul on the same operands "
          f"{med(t_lib)}")
    return ({"max_abs_err": chain_abs, "ms": c_ms, "plain_ms": c_plain_ms, "bound_ms": c_bound_ms,
             "bound_by": c_bound_by, "backward_ms": ms, "backward_max_abs_err": worst},
            {"max_abs_err": wgrad_err, "ms": w_ms, "plain_ms": w_plain_ms, "bound_ms": w_bound_ms,
             "bound_by": w_bound_by, "library_ms": library_ms})


def train_compaction(dev, ds, cfg, task_cfg, state) -> dict:
    """The train side of compaction on the card (module docstring, train):
    TRAIN_COMPACT_STEPS steps of a HeadNeRFTask that switches at
    TRAIN_COMPACT_START (the main path: its launches), then one compacted
    and one full-slot loss and backward from `state` on one batch whose ray
    0's first sample is live, with pad slots in the budget (the slot of
    sample 0 has several writers)."""
    import dataclasses

    from genefaceplusplus_tpu_torch.models.renderer import make_aabb
    from genefaceplusplus_tpu_torch.ops import fused_field as ff
    from genefaceplusplus_tpu_torch.ops import raymarch
    from genefaceplusplus_tpu_torch.training.radnerf_task import head_loss_fn
    from genefaceplusplus_tpu_torch.training.tasks.head_task import HeadNeRFTask

    occupancy = torch.from_numpy(bench_occupancy(cfg.grid_size, SMALL_HEAD_R2)).to(dev)
    task = HeadNeRFTask(ds, cfg, dataclasses.replace(task_cfg, train_compact_start=TRAIN_COMPACT_START),
                        seed=9998, device=dev)
    task.occupancy = occupancy
    st = task.create_state()
    torch.cuda.synchronize()
    for k in (ff.fused_field, ff.fused_field_forward_train, ff.fused_field_bwd_chain, ff.fused_field_wgrad):
        k.launches = 0  # the main path: the task's steps
    losses = []
    for step in range(TRAIN_COMPACT_STEPS):
        st, metrics = task.train_step(st, task.sample_train_batch(global_step=step))
        losses.append(float(metrics["total_loss"]))
    torch.cuda.synchronize()
    out = {"fwd": ff.fused_field_forward_train.launches, "chain": ff.fused_field_bwd_chain.launches,
           "wgrad": ff.fused_field_wgrad.launches, **task._compact_telemetry}
    budget = task._compact_telemetry.get("compact/budget_frac", 1.0)
    n_steps = TRAIN_COMPACT_STEPS
    check(all(math.isfinite(x) for x in losses), f"compacted train losses {losses}")
    check(task._compact_step is not None and task._compact_step is not task._train_step,
          f"the task did not switch to a compacted step (budget {budget})")
    check(out["fwd"] == out["chain"] == out["wgrad"] == n_steps, f"train kernels launched {out} in {n_steps} steps")

    # one batch, the state of the counted run, one noise draw: ray 0 the first
    # pixel (row-major) of the frame whose ray's first sample is live
    b = task.sample_train_batch(global_step=n_steps)
    frames = task._device_frames()
    noise = torch.rand(N_RAYS, generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    gather = task._make_ray_gather()
    aabb = make_aabb(cfg.bound, device=dev)

    def march(batch, ray_noise):
        ro, rd = batch["rays_o"], batch["rays_d"]
        nears, fars = raymarch.near_far_from_aabb(ro, rd, aabb, cfg.min_near)
        return raymarch.march_rays_interval(ro, rd, nears, fars, raymarch.occupancy_aabb(occupancy, cfg.bound),
                                            bound=cfg.bound, max_steps=task_cfg.max_steps, num_samples=TRAIN_SAMPLES,
                                            noise=ray_noise, min_near=cfg.min_near, grid_size=cfg.grid_size).mask

    idx = torch.tensor(b["frame_idx"], device=dev)
    every = gather(frames, idx, torch.arange(ds.H * ds.W, device=dev))
    pixel = int(torch.nonzero(march(every, noise[:1].expand(ds.H * ds.W))[:, 0])[0])
    inds = torch.as_tensor(b["inds"], device=dev).long()
    inds[0] = pixel
    batch = gather(frames, idx, inds)
    mask = march(batch, noise)
    N = mask.numel()
    M = min(N, max(512, ((int(budget * N) + 511) // 512) * 512))
    live = int(mask.sum())
    check(bool(mask[0, 0]) and live < M, f"ray 0's first sample live {bool(mask[0, 0])}, {live} live of M {M}")
    model = state.model
    # the full-slot step again on the rays in another order: the same sums in
    # another float32 order, the yardstick of the comparison
    perm = torch.randperm(N_RAYS, generator=torch.Generator().manual_seed(6)).to(dev)
    permuted = {k: v[perm] if torch.is_tensor(v) and v.ndim and v.shape[0] == N_RAYS else v for k, v in batch.items()}
    res, blocks, step_ms = {}, [], {}
    backward = ff.backward_from_train

    def kept(*a, **kw):  # the 14 gradient blocks each backward sums
        out = backward(*a, **kw)
        blocks.append([b.detach().clone() for b in out])
        return out

    ff.backward_from_train = kept
    try:
        for name, b_, n_, opts in (("full", batch, noise, task.opts), ("permuted", permuted, noise[perm], task.opts),
                                   ("compact", batch, noise, dataclasses.replace(task.opts, compact_frac=budget))):
            model.zero_grad()
            start = cuda_event()
            total, _ = head_loss_fn(model, b_, occupancy, opts, task.hp, state.global_step, state.lambda_ambient,
                                    n_, use_fused_field=True)
            total.backward()
            end = cuda_event()
            torch.cuda.synchronize()
            res[name] = (total.item(), {k: p.grad.detach().clone() for k, p in model.named_parameters()})
            step_ms[name] = start.elapsed_time(end)
    finally:
        ff.backward_from_train = backward
    model.zero_grad()
    check(len(blocks) == 3, f"{len(blocks)} fused backwards for 3 steps")
    block_rel = {}
    for (bname, _, _), f_, p_, c_ in zip(ff.GRAD_BLOCKS, *blocks):
        sc = max(f_.abs().max().item(), 1e-30)
        block_rel[bname] = ((c_ - f_).abs().max().item() / sc, (p_ - f_).abs().max().item() / sc)
    order = max(o for _, o in block_rel.values())
    block_bound = max(COMPACT_ORDER_K * order, BWD_PERMUTED_MAX_REL)
    (l_f, g_f), (l_c, g_c) = res["full"], res["compact"]
    param_rel = {k: (g_c[k] - g).abs().max().item() / g.abs().max().item() for k, g in g_f.items()
                 if g.abs().max().item() > 0}
    worst_block = max(block_rel, key=lambda k: block_rel[k][0])
    worst_param = max(param_rel, key=param_rel.get)
    out.update(loss_rel=abs(l_c - l_f) / abs(l_f), block=(worst_block, *block_rel[worst_block]), order=order,
               block_bound=block_bound, param=(worst_param, param_rel[worst_param]), M=M, N=N, live=live,
               pixel=pixel, losses=losses, ms=step_ms,
               failed=[k for k, (c, _) in block_rel.items() if c > block_bound]
               + [k for k, r in param_rel.items() if r > COMPACT_PARAM_REL])
    return out


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

    step_ms, step_events, bwd_events, losses, occ, last = [], [], [], [], [], {}
    train_step, refresh, backward = task.train_step, task.update_extra_state, ff.backward_from_train

    def timed_step(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start = cuda_event()
        state, metrics = train_step(state, batch)
        end = cuda_event()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_events.append((start, end))
        losses.append(float(metrics["total_loss"]))
        last["batch"] = batch
        return state, metrics

    def timed_backward(*args, **kwargs):  # the field's backward: the chain and the weight gradients
        start = cuda_event()
        grads = backward(*args, **kwargs)
        bwd_events.append((start, cuda_event()))
        return grads

    def recorded_refresh(state):
        before = (task.occupancy.clone(), task.density_grid.clone())
        refresh(state)
        occ.append((before, (task.occupancy.clone(), task.density_grid.clone())))

    task.train_step, task.update_extra_state = timed_step, recorded_refresh
    ff.backward_from_train = timed_backward
    work_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ff.fused_field.launches = ff.fused_field_bwd_chain.launches = ff.fused_field_wgrad.launches = 0
        ff.fused_field_forward_train.launches = 0  # B1's train-mode launches (fused_field.launches counts both modes)
        ff.fused_field_backward.launches = 0  # backward passes (chain + weight gradients; it launches nothing itself)
        trainer = Trainer(task, work_dir, max_updates=TRAIN_STEPS, val_check_interval=1000,
                          tb_log_interval=10, update_extra_interval=task_cfg.update_extra_interval)
        state = trainer.fit()
        torch.cuda.synchronize()
        fwd, chain, wgrad = ff.fused_field.launches, ff.fused_field_bwd_chain.launches, ff.fused_field_wgrad.launches
        fwd_train, bwd_calls = ff.fused_field_forward_train.launches, ff.fused_field_backward.launches
        peak = torch.cuda.max_memory_allocated(dev)

        check(len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses),
              f"train losses not all finite: {losses}")
        check(fwd == TRAIN_STEPS and fwd_train == TRAIN_STEPS and chain == TRAIN_STEPS and wgrad == TRAIN_STEPS,
              f"{fwd} forward ({fwd_train} in train mode), {chain} backward-chain and {wgrad} weight-gradient "
              f"kernel launches for {TRAIN_STEPS} train steps")
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

        def more_steps():  # after the counted run: the device's busy time a step
            st = state
            for _ in range(TRAIN_PROFILE_STEPS):
                st, _ = train_step(st, last["batch"])
            return TRAIN_PROFILE_STEPS

        _, kernels, busy_ms, top = profile_device(more_steps)
    finally:
        ff.backward_from_train = backward
        shutil.rmtree(work_dir, ignore_errors=True)
    compact = train_compaction(dev, ds, cfg, task_cfg, state)
    timed = step_ms[1:]  # the first step includes one-time set-up
    span = [a.elapsed_time(b) for a, b in step_events[1:]]
    bwd_ms = [a.elapsed_time(b) for a, b in bwd_events[1:TRAIN_STEPS]]
    check(len(bwd_events) == TRAIN_STEPS + 2 + TRAIN_PROFILE_STEPS,
          f"{len(bwd_events)} field backwards in {TRAIN_STEPS} + 2 + {TRAIN_PROFILE_STEPS} steps")
    print(f"[train] {TRAIN_STEPS} steps: losses finite ({losses[0]:.5f} -> {losses[-1]:.5f}); "
          f"{fwd} forward (all {fwd_train} in train mode), {chain} backward-chain and {wgrad} weight-gradient "
          f"kernel launches in {bwd_calls} backward passes (one each per step); occupancy "
          f"{occ[0][0][0].float().mean().item():.4f} -> {occ[0][1][0].float().mean().item():.4f} -> "
          f"{occ[1][1][0].float().mean().item():.4f} across the refreshes at steps 0 and 16; all field "
          f"parameters moved (position B by {moved['position_embedder.B']:.3e}, ambient B by "
          f"{moved['ambient_embedder.B']:.3e}); checkpoint written and resumed to step "
          f"{TRAIN_STEPS + 2}")
    print(f"[train] train step (host wall, synchronised, steps 2..{TRAIN_STEPS}): median "
          f"{statistics.median(timed):.3f} ms, min {min(timed):.3f}, max {max(timed):.3f}, n={len(timed)}; "
          f"first step {step_ms[0]:.3f} ms; peak allocated {peak / 2 ** 30:.3f} GiB")
    print(f"[train] {card_line()}; on the device, steps 2..{TRAIN_STEPS}: the step's span on the stream (CUDA "
          f"events around train_step) median {statistics.median(span):.3f} ms (min {min(span):.3f}, max "
          f"{max(span):.3f}); the field's backward (CUDA events around backward_from_train: chain + weight "
          f"gradients) median {statistics.median(bwd_ms):.3f} ms (min {min(bwd_ms):.3f}, max {max(bwd_ms):.3f})")
    if busy_ms is None:
        print("[train] device busy a step: not measured (the profiler showed no device activity)")
    else:
        print(f"[train] {TRAIN_PROFILE_STEPS} more steps under torch.profiler: device busy {busy_ms:.3f} ms a step, "
              f"{kernels:.1f} kernels a step; the most device time: "
              + "; ".join(f"{name} {c:.1f}x {t:.3f} ms" for name, c, t in top[:6]))
    c = compact
    print(f"[train] compaction: HeadNeRFTask with train_compact_start {TRAIN_COMPACT_START} on a head of half the "
          f"bench's radii, {TRAIN_COMPACT_STEPS} steps (losses {', '.join(f'{x:.5f}' for x in c['losses'])}): "
          f"compact/probe_live_frac {c['compact/probe_live_frac']:.4f}, compact/budget_frac "
          f"{c['compact/budget_frac']:.4f}; {c['fwd']} train-mode forward, {c['chain']} chain and {c['wgrad']} "
          f"weight-gradient launches, {TRAIN_COMPACT_STEPS - TRAIN_COMPACT_START} of each on the compact buffer")
    print(f"[train] compacted vs full-slot loss and backward (the counted run's state, one batch and noise; ray 0 "
          f"= pixel {c['pixel']}, its first sample live; {c['live']} live samples in a budget of M {c['M']} of "
          f"{c['N']} slots, so pad slots write sample 0's slot): loss relative {c['loss_rel']:.3e} (<= "
          f"{COMPACT_LOSS_REL}); the backward's float32 blocks, max |d| / max |g|: the largest {c['block'][0]} "
          f"compacted {c['block'][1]:.3e} (its permuted rays {c['block'][2]:.3e}; permuted rays move a block by "
          f"{c['order']:.3e} at most; bound {c['block_bound']:.3e}); the parameters' gradients (through the bf16 "
          f"cast): the largest {c['param'][0]} {c['param'][1]:.3e} (<= {COMPACT_PARAM_REL:.3e})")
    print(f"[train] {card_line()}; that loss and backward by CUDA events, once each: full-slot "
          f"{c['ms']['full']:.3f} ms, on permuted rays {c['ms']['permuted']:.3f}, compacted {c['ms']['compact']:.3f}")
    check(c["loss_rel"] <= COMPACT_LOSS_REL, "compacted vs full-slot loss")
    check(not c["failed"], f"compacted vs full-slot gradients: {c['failed']}")
    return fwd_train + c["fwd"], chain + c["chain"], wgrad + c["wgrad"], TRAIN_COMPACT_STEPS - TRAIN_COMPACT_START


# ---- train_cli: one identity trained through the training CLI -------------

# the three stages of one identity through the training CLI in processes of
# their own (the head; the SR stage, SIGTERM'd; its resume and the torso; the egs/
# configs at their widths, their 65,536-ray batches and full 256^2 frames;
# 16 frames of 512^2 with torso images); lip steps, the SR and perceptual
# terms start at step TRAIN_CLI_START; the SR stage is preempted by SIGTERM
# after step TRAIN_CLI_START and resumed
TRAIN_CLI_FRAMES, TRAIN_CLI_STEPS, TRAIN_CLI_START = 16, 12, 4
TRAIN_CLI_COMPACT = 8  # the head stage's train_compact_start: its full steps from step 9 on
TRAIN_CLI_STAGES = {
    "head": ("egs/datasets/May/lm3d_radnerf.yaml",
             f"finetune_lips_start_iter={TRAIN_CLI_START},train_compact_start={TRAIN_CLI_COMPACT}"),
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
    """Run by phase_train_cli in a process of its own (and by train_grid,
    several in one process): the training CLI's `main(argv)` with each train
    step timed (synchronised), then the newest checkpoint read back and held
    to the final live state bit for bit; the readings (and the stage's wall
    and peak memory) go to chip_smoke_stage.json in the work dir."""
    from genefaceplusplus_tpu_torch.training import run
    from genefaceplusplus_tpu_torch.training.trainer import state_to_flax
    from genefaceplusplus_tpu_torch.utils.ckpt import get_last_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    step_ms, disc = [], {}
    build = run.build_task

    def timed_build(cfg, device=None):
        task = build(cfg, device)
        step = task.train_step
        if getattr(task, "disc_model", None) is not None:
            # train_disc: the frozen discriminator's tensors before the run and
            # its forward passes by CUDA events (two a step: fake, real)
            disc.update(model=task.disc_model, before=digest(task.disc_model.state_dict().values()), spans=[])
            task.disc_model.register_forward_pre_hook(lambda *_: disc["spans"].append([cuda_event()]))
            task.disc_model.register_forward_hook(lambda *_: disc["spans"][-1].append(cuda_event()))

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
    t0 = time.perf_counter()
    try:
        state = run.main(argv)
    finally:
        run.build_task = build
    wall = time.perf_counter() - t0
    work_dir = argv[argv.index("--work_dir") + 1]
    ckpt, path = get_last_checkpoint(work_dir)
    out = {"step_ms": step_ms, "global_step": int(state.global_step), "ckpt": os.path.basename(path),
           "ckpt_equal": _trees_equal(ckpt["state_dict"], state_to_flax(state)),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "wall_s": wall}
    if disc:
        torch.cuda.synchronize()
        out.update(disc_equal=digest(disc["model"].state_dict().values()) == disc["before"],
                   disc_ms=[a.elapsed_time(b) for a, b in disc["spans"]])
    with open(os.path.join(work_dir, "chip_smoke_stage.json"), "w") as f:
        json.dump(out, f)
    return 0


def run_cli_stages(argvs, what: str) -> list:
    """`train_cli_stage` on each of `argvs`, one after another in one
    process of its own; their readings. Prints the process's wall beside
    its stages' own: the rest is the process's fixed set-up (the
    interpreter, torch and TensorFlow's imports, the card's context)."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", "import json, sys, chip_smoke; "
                          "sys.exit(max(chip_smoke.train_cli_stage(a) for a in json.loads(sys.argv[1])))",
                          json.dumps(argvs)],
                         cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True, timeout=1200)
    wall = time.perf_counter() - t0
    check(out.returncode == 0, f"{what}: exit {out.returncode}\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    readings = []
    for argv in argvs:
        with open(os.path.join(argv[argv.index("--work_dir") + 1], "chip_smoke_stage.json")) as f:
            readings.append(json.load(f))
    own = sum(r["wall_s"] for r in readings)
    print(f"[{what}] {len(argvs)} stage(s) in one process: its wall {wall:.1f} s, the stages' own {own:.1f} s, "
          f"the process's set-up {wall - own:.1f} s")
    return readings


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


def binarizer_identity(root: str) -> tuple:
    """train_cli's identity in the binarizer's layout under `root`: the
    record names the image files (gt JPEG, head and torso RGBA PNG) and holds
    no image arrays. Returns (the binary dir, the record)."""
    from genefaceplusplus_tpu_torch.data.dataset import synthetic
    from genefaceplusplus_tpu_torch.data.image_io import write_jpeg, write_png

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
    return binary, ds_dict


def phase_train_cli(dev, root: str):
    """train_cli (module docstring); the identity and the work dirs stay in
    `root` for train_grid. Returns (fused_field launches, the binary dir)."""
    from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer
    from genefaceplusplus_tpu_torch.models.full_renderer import render_full_frame
    from genefaceplusplus_tpu_torch.models.superresolution import Superresolution
    from genefaceplusplus_tpu_torch.ops import fused_field as ff
    from genefaceplusplus_tpu_torch.utils.audio_features import get_audio_features_batch
    from genefaceplusplus_tpu_torch.utils.ckpt import get_all_ckpts
    from genefaceplusplus_tpu_torch.utils.rays import pixel_rays

    repo = os.path.dirname(os.path.abspath(__file__))
    codec_check()
    binary, ds_dict = binarizer_identity(root)
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
    common = train_cli_common(binary)

    def argv(stage):
        cfg, extra = TRAIN_CLI_STAGES[stage]
        if stage == "torso":
            extra += f",head_model_dir={dirs['sr']}"
        return ["--config", os.path.join(repo, cfg), "--exp_name", f"chip_smoke_{stage}",
                "--work_dir", dirs[stage], "--hparams", f"{common},{extra}"]

    t0 = time.perf_counter()
    res = {"head": run_cli_stages([argv("head")], "train_cli head")[0]}
    # the SR stage: the CLI module itself, SIGTERM once step TRAIN_CLI_START is logged
    preempted_at = run_until_sigterm(argv("sr"), dirs["sr"], TRAIN_CLI_START, TRAIN_CLI_STEPS,
                                     os.path.join(root, "sr_sigterm.log"), "train_cli sr")
    # the SR stage's resume, then the torso from it, in one process
    res["sr"], res["torso"] = run_cli_stages([argv("sr"), argv("torso")], "train_cli sr + torso")
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
    compact = [x for x in _stage_metrics(dirs["head"]) if "compact/budget_frac" in x]
    check(compact and compact[0]["step"] > TRAIN_CLI_COMPACT and all(
        0.0 < x["compact/budget_frac"] <= 1.0 for x in compact), "train_cli head: no compact/* telemetry")
    print(f"[train_cli] head stage, train_compact_start {TRAIN_CLI_COMPACT}: compact/* telemetry from step "
          f"{compact[0]['step']}: " + "; ".join(
              f"step {x['step']} probe_live_frac {x['compact/probe_live_frac']:.4f} budget_frac "
              f"{x['compact/budget_frac']:.4f}" for x in compact)
          + (" (at or above 0.85: the full-slot step is kept)" if compact[0]["compact/budget_frac"] >= 0.85 else ""))
    print(f"[train_cli] {TRAIN_CLI_FRAMES} frames of {SIZE}x{SIZE} as image files (gt JPEG q95 4:2:0, head and "
          f"torso RGBA PNG); three stages through "
          f"the training CLI (three processes), {TRAIN_CLI_STEPS} steps each, {wall:.1f} s of wall: every loss "
          f"finite, each "
          f"checkpoint flax msgpack and equal to the live state bit for bit; head: {lip_steps} lip steps "
          f"from step {TRAIN_CLI_START + 1}; sr: SR and perceptual terms from step {TRAIN_CLI_START + 1}, "
          f"SIGTERM after step {TRAIN_CLI_START}: checkpoint at step {preempted_at}, exit 0, resumed to "
          f"step {TRAIN_CLI_STEPS}, every step logged once; torso: from the sr dir")
    for name, r in res.items():
        # this process's steps; the first includes one-time set-up; the
        # head's lip steps (a 64^2 window of rays) apart from its full steps
        first = TRAIN_CLI_STEPS - len(r["step_ms"]) + 1
        recs = _stage_metrics(dirs[name]) if name == "head" else []
        lip = {x["step"] for x in recs if "lpips_loss" in x}
        switched = {x["step"] for x in recs if "compact/budget_frac" in x}
        kinds = {"full": [ms for s, ms in enumerate(r["step_ms"], first)
                          if s > first and s not in lip and s not in switched],
                 "switched to compaction": [ms for s, ms in enumerate(r["step_ms"], first) if s in switched],
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
    return launches, binary


# train_grid: grid heads trained on train_cli's identity through the training
# CLI at the May widths (tables of 903,480 rows a grid, grid 128, 65,536 rays
# x 16 samples), TRAIN_CLI_STEPS steps each, the stages one after another in
# one process; a reference head faked at the same widths (testing.reference_head_state),
# converted by tools/convert_ckpt.py --type head at step CONVERTED_STEP and
# fine-tuned TRAIN_GRID_FINETUNE steps past it; then the trained dirs served
# and one head step's gradients on the card held to the CPU's
TRAIN_GRID_STAGES = {
    "tiled": ("egs/datasets/May/lm3d_radnerf.yaml", f"grid_type=tiledgrid,finetune_lips_start_iter={TRAIN_CLI_START}"),
    "sr": ("egs/datasets/May/lm3d_radnerf_sr.yaml", f"grid_type=tiledgrid,lpips_start_iters={TRAIN_CLI_START}"),
    "torso": ("egs/datasets/May/lm3d_radnerf_torso_sr.yaml", "grid_type=tiledgrid,lambda_torso_deform=0.01"),
    "hash": ("egs/datasets/May/lm3d_radnerf.yaml", "grid_type=hashgrid"),
    "converted": ("egs/datasets/May/lm3d_radnerf.yaml", "grid_type=tiledgrid"),
}
TRAIN_GRID_METRICS = {"tiled": {"lpips_loss", "mse_loss", "weights_entropy_loss", "ambient_loss"},
                      "sr": {"sr_mse_loss", "lpips_loss", "sr_lpips_loss", "sr_lip_lpips_loss"},
                      "torso": {"torso_entropy", "deform_reg", "mse_loss"},
                      "hash": {"mse_loss", "weights_entropy_loss", "ambient_loss"},
                      "converted": {"mse_loss", "lpips_loss"}}
# the converted head resumes past the reference's lip start (200,000), so its
# fine-tune alternates lip and full steps, as the reference's late steps do
CONVERTED_STEP, TRAIN_GRID_FINETUNE = 250_000, 8
TRAIN_GRID_PROFILE_STEPS = 3
TRAIN_GRID_BAND_ROWS = 32  # the hashgrid and converted heads' band, card vs CPU
# one head step's gradients, card against CPU, same weights, batch and noise.
# The old witness held |card - CPU| to GRID_GRAD_REL of each tensor's largest
# entry; it failed once at 1.197e-4 (color_net.dense.0.weight) from a
# trained state that varies run to run. Where the step's own sums can be
# redone in float64 on the CPU (every nn.Linear's weight and bias gradient
# from its captured float32 operands, every grid table's gradient from
# GridEncodeFunction's backward on its saved inputs, the individual codes'
# from the color net's first layer's output gradient), with the sums of their
# terms' absolute values beside them, each entry of the card's gradient must
# lie within GRID_GRAD_ABS of its terms' absolute sum plus GRID_GRAD_REL of
# the tensor's largest entry from the float64 sum. An entry whose terms
# cancel (the MLPs': their terms' absolute sums 53x the gradient's largest
# entry on the card, PR 18) turns the card's float32 differences in the
# forward into larger differences of the gradient, in proportion; the CPU's
# own float32 error is read beside it, and a card that sums wrong still
# fails. The other tensors keep the old check.
GRID_GRAD_REL = 1e-4
GRID_GRAD_ABS = 1e-5


def head_band_card_vs_cpu(head, occupancy, ds, dev, what: str) -> tuple:
    """`band_card_vs_cpu` for a trained head (no GeneFaceInfer): the head-only
    render of dataset frame 0 on TRAIN_GRID_BAND_ROWS rows through the
    middle of the frame, card against CPU: (max, mean) |d| of the band's
    rgb."""
    from genefaceplusplus_tpu_torch.models.full_renderer import render_full_frame
    from genefaceplusplus_tpu_torch.models.renderer import RenderOptions
    from genefaceplusplus_tpu_torch.utils.rays import pixel_rays

    rows = min(TRAIN_GRID_BAND_ROWS, ds.H)
    r0 = (ds.H - rows) // 2
    ro, rd = pixel_rays(torch.from_numpy(ds.frame_pose(0)[None]), ds.intrinsics, ds.H, ds.W)
    band = slice(r0 * ds.W, (r0 + rows) * ds.W)
    win = torch.from_numpy(ds.frame_cond_window(0))
    bg = torch.from_numpy(np.asarray(ds.bg_img, np.float32).reshape(-1, 3))[band]
    outs = {}
    for where, d, model in (("card", dev, head), ("cpu", "cpu", cpu_twin(head))):
        with torch.no_grad():
            out = render_full_frame(model, ro[0, band].to(d), rd[0, band].to(d), win.to(d), occupancy.to(d),
                                    bg.to(d), RenderOptions(), (rows, ds.W),
                                    eye_area_percent=torch.from_numpy(ds.eye_area_percents[:1]).to(d))
        outs[where] = (out.rgb_map.cpu(), out.weights_sum.cpu())
    e = (outs["card"][0] - outs["cpu"][0]).abs()
    m, a, ws = e.max().item(), e.mean().item(), outs["cpu"][1].max().item()
    print(f"[train_grid] {what}: card vs CPU over rows {r0}..{r0 + rows - 1} of {ds.H}x{ds.W} ({rows * ds.W} rays, "
          f"largest weights sum {ws:.3f}): max |d| {m:.3e} (<= {TRAINED_CARD_MAX}), mean {a:.3e} "
          f"(<= {TRAINED_CARD_MEAN})")
    check(ws > 0.1, f"{what}: the band misses the head")
    check(m <= TRAINED_CARD_MAX and a <= TRAINED_CARD_MEAN, f"{what}: card vs CPU")
    return m, a


def grid_step_readings(cfg, ckpt, dev) -> dict:
    """A tiledgrid head's CLI step on the card from a trained checkpoint:
    host wall a step; the grid encoders' forward and backward device ms a
    step (CUDA events around GridEncodeFunction) beside the float32 MLPs'
    (events in module hooks); kernels a step, device busy and the idle
    share (profile_device); the step's peak memory through the Function and
    through the plain encoder (autograd keeps every level's rows, weights
    and corners), and the two gradients' largest difference."""
    from genefaceplusplus_tpu_torch.models import grid_modules
    from genefaceplusplus_tpu_torch.ops.grid_encoder import GridEncodeFunction, grid_encode
    from genefaceplusplus_tpu_torch.training import run
    from genefaceplusplus_tpu_torch.training.trainer import load_flax_state

    task = run.build_task(cfg, device=dev)
    task.load_extra_state(ckpt["extra_state"])
    state = load_flax_state(task.create_state(), ckpt["state_dict"])
    n = TRAIN_GRID_PROFILE_STEPS

    def steps(k=n):
        for _ in range(k):
            task.train_step(state, task.sample_train_batch())
        return k

    steps(2)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n

    spans = {k: [] for k in ("enc_fwd", "enc_bwd", "mlp_fwd", "mlp_bwd")}
    fwd, bwd = GridEncodeFunction.forward, GridEncodeFunction.backward

    def timed(kind, fn):
        def run_timed(ctx, *args):
            start = cuda_event()
            out = fn(ctx, *args)
            spans[kind].append((start, cuda_event()))
            return out
        return staticmethod(run_timed)

    def opens(kind):
        def hook(*_):
            spans[kind].append([cuda_event()])
        return hook

    def closes(kind):
        def hook(*_):
            spans[kind][-1].append(cuda_event())
        return hook

    hooks = []
    for mlp in (state.model.ambient_net, state.model.sigma_net, state.model.color_net):
        hooks += [mlp.register_forward_pre_hook(opens("mlp_fwd")), mlp.register_forward_hook(closes("mlp_fwd")),
                  mlp.register_full_backward_pre_hook(opens("mlp_bwd")),
                  mlp.register_full_backward_hook(closes("mlp_bwd"))]
    GridEncodeFunction.forward, GridEncodeFunction.backward = timed("enc_fwd", fwd), timed("enc_bwd", bwd)
    try:
        steps()
        torch.cuda.synchronize()
    finally:
        GridEncodeFunction.forward, GridEncodeFunction.backward = staticmethod(fwd), staticmethod(bwd)
        for h in hooks:
            h.remove()
    out = {k: sum(a.elapsed_time(b) for a, b in v) / n for k, v in spans.items()}
    out["wall"] = wall
    out["acts"], out["kernels"], out["busy"], out["top"] = profile_device(steps)
    check(out["busy"] is not None, "train_grid: the profiler saw no device activity")

    # peak memory of one step through the Function, then through autograd of
    # the plain encoder, from the same weights, batch and noise
    batch = task.sample_train_batch()
    noise = torch.rand(len(batch["inds"]), generator=torch.Generator().manual_seed(3)).to(dev)
    weights = {k: v.clone() for k, v in state.model.state_dict().items()}
    start = (state.global_step, state.lambda_ambient.clone())

    def plain_forward(self, x, bound=1.0):
        return grid_encode(x, self.embeddings, self.spec, bound=bound)

    grads = {}
    for how in ("function", "plain"):
        state.model.load_state_dict(weights)
        state.global_step, state.lambda_ambient = start[0], start[1].clone()
        forward = grid_modules.GridEncoder.forward
        if how == "plain":
            grid_modules.GridEncoder.forward = plain_forward
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            task.train_step(state, batch, noise=noise)
            torch.cuda.synchronize()
        finally:
            grid_modules.GridEncoder.forward = forward
        out[f"peak_{how}"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out[f"step_{how}"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        grads[how] = {k: p.grad.detach().clone() for k, p in state.model.named_parameters() if p.grad is not None}
    out["plain_rel"] = max((grads["function"][k] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
                           for k, g in grads["plain"].items())
    return out


def grad_witness(g_card, g_cpu, g64, spread64) -> tuple:
    """(old, card, cpu, spread, ok) for one gradient tensor: the old reading
    |card - CPU| / max |CPU|; each device's max |g - g64| over max |g64|,
    g64 the same sums in float64; the largest of their terms' absolute sums
    `spread64` over max |g64|; ok when every entry of the card's gradient
    lies within GRID_GRAD_ABS * spread64 + GRID_GRAD_REL * max |g64| of g64."""
    g_card, g_cpu, g64, spread64 = (t.detach().double().cpu() for t in (g_card, g_cpu, g64, spread64))
    old = ((g_card - g_cpu).abs().max() / g_cpu.abs().max().clamp_min(1e-300)).item()
    scale = g64.abs().max().clamp_min(1e-300)
    card = ((g_card - g64).abs().max() / scale).item()
    cpu = ((g_cpu - g64).abs().max() / scale).item()
    ok = bool(((g_card - g64).abs() <= GRID_GRAD_ABS * spread64 + GRID_GRAD_REL * scale).all())
    return old, card, cpu, (spread64.abs().max() / scale).item(), ok


class Float64Sums:
    """While active, keeps a float64 copy of the gradient sums that a step of
    `model` does in float32, on the model's device: for every nn.Linear
    call, input^T (output gradient) and its bias row sum, from the float32
    operands (a forward hook saves the input, a hook on the output its
    gradient); for every GridEncodeFunction backward, the table gradient
    accumulated in float64 from the same rows and weights; for every
    Fourier projection x @ B^T, B's gradient (output gradient)^T x; for
    every SR layer's const noise, its strength's gradient, the sum of the
    conv output's gradient times the noise; for every head's individual
    code, its row's gradient, the sum over the points of the color net's
    first layer's output gradient times that layer's weight columns that
    take the code. `refs` maps parameter names to those sums; `spread` to
    the same sums of the terms' absolute values (how far an entry's terms
    cancel)."""

    def __init__(self, model):
        from genefaceplusplus_tpu_torch.models import superresolution
        from genefaceplusplus_tpu_torch.ops import fourier_encoder
        from genefaceplusplus_tpu_torch.ops.grid_encoder import GridEncodeFunction

        self.model, self.fn = model, GridEncodeFunction
        self.sr, self.fourier = superresolution, fourier_encoder
        self.names = {p.data_ptr(): n for n, p in model.named_parameters()}
        self.layers = {m: n for n, m in model.named_modules() if isinstance(m, superresolution.SynthesisLayer)}
        # a head's code enters its color net's first layer as the input's last
        # columns, tiled over the points (RADNeRF.field_color)
        self.codes, self.heads, self.rows = {}, {}, {}
        for n, m in model.named_modules():
            if getattr(m, "individual_embeddings", None) is not None:
                name = (n + "." if n else "") + "individual_embeddings"
                self.codes[m.color_net.dense[0]], self.heads[name] = name, m
        self.refs, self.spread, self.hooks, self.layer = {}, {}, [], None

    def _add(self, name, ref, spread):
        self.refs[name] = self.refs.get(name, 0) + ref
        self.spread[name] = self.spread.get(name, 0) + spread

    def __enter__(self):
        def on_forward(layer, inputs, output):
            if not output.requires_grad:
                return
            a32 = inputs[0].detach()
            mod = next(n for n, m in self.model.named_modules() if m is layer)

            def on_grad(g):
                a = a32.reshape(-1, layer.in_features).double()
                g = g.detach().reshape(-1, layer.out_features).double()
                self._add(mod + ".weight", g.t() @ a, g.abs().t() @ a.abs())
                if layer.bias is not None:
                    self._add(mod + ".bias", g.sum(0), g.abs().sum(0))
                name = self.codes.get(layer)
                if name is not None:
                    table = self.heads[name].individual_embeddings
                    t = g @ layer.weight.detach()[:, -table.shape[1]:].double()  # each point's term
                    ref = torch.zeros(table.shape, dtype=torch.float64, device=t.device)
                    spread = torch.zeros_like(ref)
                    ref[self.rows[name]], spread[self.rows[name]] = t.sum(0), t.abs().sum(0)
                    self._add(name, ref, spread)
            output.register_hook(on_grad)

        self.hooks = [m.register_forward_hook(on_forward) for m in self.model.modules()
                      if isinstance(m, torch.nn.Linear)]
        for name, head in self.heads.items():
            def coded(index, name=name, head=head, get=head.get_individual_code):
                n = head.individual_embeddings.shape[0]
                i = int(index)  # the row JAX's gather reads: a negative index wraps once, then clamps
                self.rows[name] = min(max(i + n if i < 0 else i, 0), n - 1)
                return get(index)
            head.get_individual_code = coded
        backward = self.backward = self.fn.backward

        def recorded(ctx, grad_out):
            import types

            x, table = ctx.saved_tensors
            for g, into in ((grad_out.double(), "refs"), (grad_out.double().abs(), "spread")):
                twin = types.SimpleNamespace(saved_tensors=(x, table.detach().double()), spec=ctx.spec,
                                             bound=ctx.bound, needs_input_grad=(False, True))
                ref = backward(twin, g)[1]
                name = self.names[table.data_ptr()]
                getattr(self, into)[name] = getattr(self, into).get(name, 0) + ref
            return backward(ctx, grad_out)

        self.fn.backward = staticmethod(recorded)

        project = self.project = self.fourier.project

        def projected(x, Bt):
            p = project(x, Bt)
            name = self.names.get(Bt.data_ptr())
            if name is not None and p.requires_grad:
                a = x.detach().reshape(-1, x.shape[-1]).double()

                def on_grad(g):
                    g = g.detach().reshape(-1, p.shape[-1]).double()
                    self._add(name, g.t() @ a, g.abs().t() @ a.abs())
                p.register_hook(on_grad)
            return p

        def on_layer(layer, args, kwargs):
            self.layer = (self.layers[layer], layer, kwargs.get("noise_offset", (0, 0)))

        self.hooks += [m.register_forward_pre_hook(on_layer, with_kwargs=True) for m in self.layers]
        modulated = self.modulated = self.sr.modulated_conv2d

        def noised(*args, noise=None, **kwargs):
            out = modulated(*args, noise=noise, **kwargs)
            if noise is not None and out.requires_grad and self.layer is not None:
                mod, layer, (r0, c0) = self.layer
                h, w = out.shape[2:]
                const = layer.noise_const.detach()[r0:r0 + h, c0:c0 + w].double()

                def on_grad(g):
                    t = g.detach().double() * const
                    self._add(mod + ".noise_strength", t.sum(), t.abs().sum())
                out.register_hook(on_grad)
            return out

        self.fourier.project, self.sr.modulated_conv2d = projected, noised
        return self

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()
        self.fn.backward = staticmethod(self.backward)
        self.fourier.project, self.sr.modulated_conv2d = self.project, self.modulated
        for head in self.heads.values():
            del head.get_individual_code


def grid_grads_card_vs_cpu(cfg, ckpt, dev) -> dict:
    """One tiledgrid head step of the CLI's task on the card and on the CPU
    from a trained checkpoint, one batch (full rays) and one noise draw, each
    step's gradient sums also redone in float64 (`Float64Sums`): by part
    (the grid tables, the MLPs, the condition net, the rest), the tensor of
    the largest |card - CPU| over its largest entry with `grad_witness`'s
    readings and the card against its own operands' float64 sums; fails
    where `grad_witness` does (the old bound where no float64 sum exists)."""
    from genefaceplusplus_tpu_torch.training import run
    from genefaceplusplus_tpu_torch.training.trainer import load_flax_state

    grads, batch, noise, losses, own = {}, None, None, {}, {}
    for d in ("cpu", dev):
        task = run.build_task(cfg, device=d)
        task.load_extra_state(ckpt["extra_state"])
        state = load_flax_state(task.create_state(), ckpt["state_dict"])
        if batch is None:
            batch = task.sample_train_batch(global_step=0)
            check(not batch["_is_lip"], "train_grid: the gradient check's batch is a lip window")
            noise = torch.rand(len(batch["inds"]), generator=torch.Generator().manual_seed(5))
        with Float64Sums(state.model) as own[str(d)]:
            _, metrics = task.train_step(state, batch, noise=noise.to(d))
        losses[str(d)] = float(metrics["total_loss"])
        grads[str(d)] = {k: p.grad.detach().cpu() for k, p in state.model.named_parameters()}
    parts = {"tables": ("position_embedder", "ambient_embedder"), "mlps": ("ambient_net", "sigma_net", "color_net"),
             "condition": ("cond_prenet", "cond_att_net", "blink_")}
    out, failed = {}, []
    for k, ref in grads["cpu"].items():
        scale = ref.abs().max().item()
        if scale == 0.0:
            check(grads[str(dev)][k].abs().max().item() == 0.0, f"train_grid: {k}'s gradient is 0 on the CPU only")
            continue
        sums = own["cpu"]
        if k in sums.refs:
            old, card, cpu, spread, ok = grad_witness(grads[str(dev)][k], ref, sums.refs[k], sums.spread[k])
            # the card's gradient against its own operands' float64 sums: its summation alone
            ref_card = own[str(dev)].refs[k].cpu()
            card_own = ((grads[str(dev)][k].double() - ref_card).abs().max() / ref_card.abs().max()).item()
        else:
            old = (grads[str(dev)][k] - ref).abs().max().item() / scale
            card = cpu = spread = card_own = None
            ok = old <= GRID_GRAD_REL
        if not ok:
            failed.append(k)
        part = next((p for p, names in parts.items() if k.startswith(names)), "other")
        if part not in out or old > out[part][0]:
            out[part] = (old, k, card, cpu, spread, card_own)
    out["failed"] = failed
    out["f64"] = len(own["cpu"].refs)
    out["loss_rel"] = abs(losses[str(dev)] - losses["cpu"]) / abs(losses["cpu"])
    out["points"] = len(batch["inds"])
    return out


def phase_train_grid(dev, binary: str, root: str):
    """train_grid (module docstring), on train_cli's identity in `binary`."""
    from genefaceplusplus_tpu_torch.config import set_hparams
    from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset
    from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer
    from genefaceplusplus_tpu_torch.models.full_renderer import render_full_frame
    from genefaceplusplus_tpu_torch.models.radnerf import RADNeRFConfig
    from genefaceplusplus_tpu_torch.models.superresolution import Superresolution
    from genefaceplusplus_tpu_torch.ops import fused_field as ff
    from genefaceplusplus_tpu_torch.testing import reference_head_state, save_reference_ckpt
    from genefaceplusplus_tpu_torch.tools import convert_ckpt
    from genefaceplusplus_tpu_torch.training.tasks.torso_task import load_head
    from genefaceplusplus_tpu_torch.utils.audio_features import get_audio_features_batch
    from genefaceplusplus_tpu_torch.utils.ckpt import get_all_ckpts, get_last_checkpoint
    from genefaceplusplus_tpu_torch.utils.rays import pixel_rays

    repo = os.path.dirname(os.path.abspath(__file__))
    dirs = {s: os.path.join(root, f"grid_{s}") for s in TRAIN_GRID_STAGES}
    common = (f"binary_data_dir={binary},video_id=syn,val_check_interval=6,update_extra_interval={TRAIN_CLI_START},"
              "tb_log_interval=1")

    def hparams(name):
        cfg, extra = TRAIN_GRID_STAGES[name]
        steps = CONVERTED_STEP + TRAIN_GRID_FINETUNE if name == "converted" else TRAIN_CLI_STEPS
        extra += f",head_model_dir={dirs['sr']}" if name == "torso" else ""
        return os.path.join(repo, cfg), f"{common},max_updates={steps},{extra}"

    def argv(name):
        cfg, hp = hparams(name)
        return ["--config", cfg, "--exp_name", f"chip_smoke_grid_{name}", "--work_dir", dirs[name], "--hparams", hp]

    # the reference's head at the May widths, converted (params and grids only)
    t0 = time.perf_counter()
    src = os.path.join(root, "reference_head", f"model_ckpt_steps_{CONVERTED_STEP}.ckpt")
    os.makedirs(os.path.dirname(src))
    hp = dict(set_hparams(config=hparams("converted")[0], hparams_str=hparams("converted")[1]))
    save_reference_ckpt(src, reference_head_state(hp, seed=11, occupancy=bench_occupancy(GRID)), global_step=CONVERTED_STEP)
    convert_ckpt.main(["--input", src, "--type", "head", "--grid_size", str(GRID), "--out", dirs["converted"]])
    converted = get_last_checkpoint(dirs["converted"])[0]
    check(set(converted["state_dict"]) == {"params"}, "the converted head holds params only")
    convert_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    res = dict(zip(TRAIN_GRID_STAGES, run_cli_stages([argv(name) for name in TRAIN_GRID_STAGES], "train_grid")))
    wall = time.perf_counter() - t0
    for name, r in res.items():
        recs = _stage_metrics(dirs[name])
        steps = [x for x in recs if "total_loss" in x]
        first = CONVERTED_STEP if name == "converted" else 0
        total = TRAIN_GRID_FINETUNE if name == "converted" else TRAIN_CLI_STEPS
        check([x["step"] for x in steps] == list(range(first + 1, first + total + 1)),
              f"train_grid {name}: steps logged {[x['step'] for x in steps]}")
        check(all(math.isfinite(v) for x in steps for k, v in x.items() if k.endswith("loss")),
              f"train_grid {name}: a loss is not finite")
        keys = set().union(*steps)
        check(TRAIN_GRID_METRICS[name] <= keys, f"train_grid {name}: metrics {sorted(keys)}")
        check(any("val_psnr" in x for x in recs), f"train_grid {name}: no validation")
        check(r["global_step"] == total and r["ckpt_equal"],
              f"train_grid {name}: final step {r['global_step']}, checkpoint equals the live state {r['ckpt_equal']}")
        check([os.path.basename(p) for p in get_all_ckpts(dirs[name])] == [f"model_ckpt_steps_{first + total}.ckpt"],
              f"train_grid {name}: checkpoints {get_all_ckpts(dirs[name])}")
        if name != "torso":
            check(any(x.get("grad_norm/grid", 0) > 0 for x in steps), f"train_grid {name}: the tables got no gradient")
    print(f"[train_grid] five stages through the training CLI at the May widths on train_cli's identity, one "
          f"after another in one process, {wall:.1f} s of wall (" + ", ".join(
              f"{name} {r['wall_s']:.1f} s" for name, r in res.items()) + f"): tiledgrid head (lip steps from step {TRAIN_CLI_START + 1}), head + SR, the "
          f"tiledgrid torso over it, hashgrid head, {TRAIN_CLI_STEPS} steps each; the reference head converted by "
          f"--type head ({convert_s:.1f} s with its fake) and fine-tuned from step {CONVERTED_STEP} to "
          f"{CONVERTED_STEP + TRAIN_GRID_FINETUNE} from a fresh optimizer: every loss finite, each checkpoint equal to "
          f"the live state bit for bit")
    for name, r in res.items():
        recs = {x["step"]: x for x in _stage_metrics(dirs[name]) if "total_loss" in x}
        base = min(recs) - 1
        kinds = {"full": [], "lip": []}
        for s, ms in enumerate(r["step_ms"], base + 1):
            if s > base + 1:
                kinds["lip" if "lpips_loss" in recs[s] and name in ("tiled", "converted") else "full"].append(ms)
        print(f"[train_grid] {card_line()}; {name} ms/step (host wall, synchronised, steps {base + 2}.."
              f"{base + len(r['step_ms'])}): " + "; ".join(
                  f"{k} steps median {statistics.median(v):.3f}, min {min(v):.3f}, max {max(v):.3f}, n={len(v)}"
                  for k, v in kinds.items() if v)
              + f"; step {base + 1} (set-up) {r['step_ms'][0]:.3f} ms; peak allocated {r['peak_gib']:.3f} GiB")

    # the tiledgrid head's step: encoders, MLPs, kernels, memory; then its
    # gradients on the card against the CPU's
    cfg = set_hparams(config=hparams("tiled")[0], hparams_str=hparams("tiled")[1], work_dir=dirs["tiled"])
    cfg = cfg.replace(finetune_lips_start_iter=10 ** 9)  # full steps only
    ckpt = get_last_checkpoint(dirs["tiled"])[0]
    parts = {"convert": convert_s, "stages": wall}
    ff.fused_field.launches = ff.fused_field_bwd_chain.launches = 0  # grid heads run the float32 field
    t0 = time.perf_counter()
    rd = grid_step_readings(cfg, ckpt, dev)
    parts["step readings"] = time.perf_counter() - t0
    enc = rd["enc_fwd"] + rd["enc_bwd"]
    print(f"[train_grid] {card_line()}; tiledgrid head step (65,536 rays x 16 samples; {TRAIN_GRID_PROFILE_STEPS} "
          f"steps after 2 warm): host wall {rd['wall']:.3f} ms a step; by CUDA events a step: the grid encoders "
          f"forward {rd['enc_fwd']:.3f} ms, backward {rd['enc_bwd']:.3f} ms ({100 * enc / rd['wall']:.1f} % of the "
          f"wall), the float32 MLPs forward {rd['mlp_fwd']:.3f} ms, backward {rd['mlp_bwd']:.3f} ms; under "
          f"torch.profiler {rd['kernels']:.1f} kernels ({rd['acts']:.1f} device activities) a step, device busy "
          f"{rd['busy']:.3f} ms a step: idle {100 * (1 - rd['busy'] / rd['wall']):.1f} %; most device time: "
          + "; ".join(f"{t:.3f} ms in {c:.0f} launches {name[:48]}" for name, c, t in rd["top"][:5]))
    print(f"[train_grid] {card_line()}; one step's peak memory: through GridEncodeFunction {rd['peak_function']:.3f} "
          f"GiB allocated ({rd['step_function']:.3f} GiB above the step's start), through autograd of the plain "
          f"encoder {rd['peak_plain']:.3f} GiB ({rd['step_plain']:.3f} GiB above); their gradients differ by "
          f"{rd['plain_rel']:.3e} of a tensor's largest entry at most")
    check(rd["plain_rel"] <= GRID_GRAD_REL, "train_grid: the Function's gradients against the plain encoder's")
    t0 = time.perf_counter()
    g = grid_grads_card_vs_cpu(cfg, ckpt, dev)
    parts["gradients card vs CPU"] = time.perf_counter() - t0
    print(f"[train_grid] one tiledgrid head step's gradients, card vs CPU (the trained state, one batch of "
          f"{g['points']} rays and one noise draw): max |d| / max |g| "
          + ", ".join(f"{p} {g[p][0]:.3e} ({g[p][1]})" for p in ("tables", "mlps", "condition", "other") if p in g)
          + f" (the old reading; its bound was {GRID_GRAD_REL}); total loss relative {g['loss_rel']:.3e}")
    print(f"[train_grid] the same gradients against the CPU step's sums redone in float64 ({g['f64']} tensors), "
          f"for each part's worst tensor above: " + "; ".join(
              f"{p} card {g[p][2]:.3e}, CPU {g[p][3]:.3e} of the largest entry (the card against its own "
              f"operands' float64 sums {g[p][5]:.3e}), the terms' absolute sum {g[p][4]:.1f}x it"
              for p in ("tables", "mlps", "condition", "other") if p in g and g[p][2] is not None)
          + f" (each card entry within {GRID_GRAD_ABS} of its terms' absolute sum + {GRID_GRAD_REL} of the largest "
            f"entry; tensors without a float64 sum: the old bound)")
    check(not g["failed"], f"train_grid: gradients card vs CPU: {g['failed']}")
    check(g["loss_rel"] <= 1e-5, "train_grid: the loss card vs CPU")

    # serving the trained dirs: the torso dir (over the SR head) on the card,
    # each frame's float32 composite and SR frame held to the CPU's; the
    # hashgrid and the fine-tuned converted heads on a band
    t0 = time.perf_counter()
    infer = GeneFaceInfer.from_work_dirs(torso_model_dir=dirs["torso"], device=dev)
    check(infer.head_cfg.grid_type == "tiledgrid" and infer.torso_cfg.grid_type == "tiledgrid", "grid dirs")
    ids = list(range(SERVE_TRAINED_FRAMES))
    batch = infer.prepare_gt_batch(ids)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = list(infer.forward_secc2video(batch, {"frames_per_dispatch": SERVE_TRAINED_FRAMES}))
    serve_ms = (time.perf_counter() - t0) * 1e3
    H = infer.dataset.H
    check(len(frames) == len(ids) and all(f.shape == (2 * H, 2 * H, 3) for f in frames), "frames from the grid dirs")
    cpu = GeneFaceInfer.from_work_dirs(torso_model_dir=dirs["torso"], device="cpu")
    worst = {}
    for i in ids:
        outs = {}
        for inf in (cpu, infer):
            d = inf.device
            sr32 = Superresolution(3, inf.sr_model.block0.conv0.noise_const.shape[0]).to(d)
            sr32.load_state_dict(inf.sr_model.state_dict())
            with torch.no_grad():
                ro, rdir = pixel_rays(torch.as_tensor(batch["poses"][i:i + 1], device=d), inf.dataset.intrinsics, H, H)
                win = get_audio_features_batch(torch.as_tensor(batch["cond"], device=d),
                                               torch.tensor([i], device=d), inf.head_cfg.smo_win_size)[0]
                out = render_full_frame(
                    inf.head_model, ro[0], rdir[0], win, inf.occupancy, inf.bg_color, inf.render_options({}), (H, H),
                    eye_area_percent=torch.as_tensor(batch["eye_area_percent"][i:i + 1], device=d),
                    torso_model=inf.torso_model, bg_coords=inf.bg_coords,
                    lm68=torch.as_tensor(batch["lm68"][i:i + 1], device=d), occupancy_2d=inf.torso_occupancy_2d,
                    sr_model=sr32, torso_crop=inf.torso_crop)
            outs[str(d)] = {k: getattr(out, k).cpu() for k in ("rgb_map", "sr_rgb_map")}
        for k, ref in outs["cpu"].items():
            e = (outs[str(infer.device)][k] - ref).abs()
            m, a = worst.get(k, (0.0, 0.0))
            worst[k] = (max(m, e.max().item()), max(a, e.mean().item()))
    print(f"[train_grid] {card_line()}; served from the grid dirs (tiledgrid torso over the tiledgrid SR head): "
          f"{len(frames)} frames of {2 * H}x{2 * H} in {serve_ms:.1f} ms ({serve_ms / len(frames):.3f} ms a frame, "
          f"first request, host wall), 0 fused_field launches; each frame's float32 composite and SR frame card vs "
          f"CPU, worst over the {len(ids)}: " + ", ".join(f"{k} max |d| {m:.3e} mean {a:.3e}" for k, (m, a) in worst.items())
          + f" (<= {TRAINED_CARD_MAX}, {TRAINED_CARD_MEAN})")
    for k, (m, a) in worst.items():
        check(m <= TRAINED_CARD_MAX and a <= TRAINED_CARD_MEAN, f"train_grid: served {k} card vs CPU")
    parts["serving, frames card vs CPU"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name in ("hash", "converted"):
        head_cfg = RADNeRFConfig.from_hparams(set_hparams(work_dir=dirs[name]))
        ds = RADNeRFDataset(os.path.join(binary, "syn", "trainval_dataset.npy"), smo_win_size=head_cfg.smo_win_size,
                            with_sr=True)  # as training/run.py builds it
        head, occ, _ = load_head(head_cfg, dirs[name], dev)
        head_band_card_vs_cpu(head, occ, ds, dev, f"the trained {head_cfg.grid_type} head ({name})")
    parts["bands"] = time.perf_counter() - t0
    check(ff.fused_field.launches == 0 and ff.fused_field_bwd_chain.launches == 0,
          "train_grid: a grid head launched the Fourier kernels")
    print("[train_grid] the phase's parts, host wall: " + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()))


# train_disc: the SR stage's frozen dual discriminator, as the reference
# trains with it (radnerf_sr.py's feature matching): a seeded fake of its
# `disc` sub-model at full width (testing.reference_disc_state: 512^2,
# channel_base 32768, channel_max 512, 8 mapping layers, 25-d camera)
# converted by tools/convert_ckpt.py --type disc; the discriminator alone at
# 512^2, batch DISC_BATCH, card vs CPU; the CLI's head + SR stage on
# train_cli's identity with lambda_dual_fm DISC_LAMBDA from step 1; one SR +
# FM step card vs CPU (float32 SR: the bf16 convolutions of cuDNN and
# oneDNN round differently) from the trained state, batch and noise; then
# DISC_SERVE_FRAMES frames served from the trained dir.
DISC_STEP, DISC_BATCH, DISC_LAMBDA, DISC_SERVE_FRAMES = 60_000, 2, 0.1, 8
DISC_REL = 1e-4  # the discriminator card vs CPU: each output within this of its largest |value|
# the FM loss's input gradients: the card's distance from the CPU's float64
# gradient within DISC_ORDER_K times the CPU float32's own, plus DISC_REL
# (max |d| over the largest |g64|, and the L2 distance over |g64|): an L1 of
# lrelu features is not smooth, so float32 rounding flips some of its signs
# and kinks on either device (the CPU's own float32 gradient read 5.8e-3 of
# the largest entry from float64 at 512^2, the card's 4.8e-3)
DISC_ORDER_K = 4.0
# the SR + FM step card vs CPU. Its gradients are not a smooth function of
# float32 rounding (lrelu and clamps in the SR and the discriminator, ReLUs in
# the head and the perceptual net, the FM loss's L1), and each device's sums
# sit within 1.6e-6 of float64 sums of its own operands: card vs CPU (NVIDIA
# H100 80GB HBM3, 700 W, eight runs) the head's Fourier B and sigma layers
# read 1.1e-4-2.26e-4 of their largest entry (failing `grad_witness` against
# the CPU's float64 sums), the SR's noise strengths up to 2.73e-2 of
# themselves, the noise_const buffers 4e-2-1.7e-1 (L2 1.5e-3-3.5e-3).
# The individual codes' gradient, a sum over every point of the color net's
# input gradient, read 3.1e-5-6.3e-5 of its largest entry in earlier runs and
# 1.14e-4 in one whole run, which then failed under GRID_GRAD_REL.
# Held: each parameter within GRID_GRAD_REL of its largest entry, the
# tensors whose sums `Float64Sums` redoes (the head's nn.Linear layers, both
# Fourier projections, the individual codes) within FM_GRAD_REL and the card
# within GRID_GRAD_REL
# of float64 sums of its own operands; the noise strengths (scalar sums
# whose terms cancel ~10^3-10^4x) by `grad_witness` against the CPU step's
# float64 sums; the noise_const buffers (per-pixel sums over a layer's
# channels) by their L2 distance within FM_CONST_L2 of their norm. Then the
# card's Adam step replayed on the CPU from the card's gradients: each entry
# within ADAM_ULPS float32 ulps, plus ADAM_UPDATE_REL of a parameter's update
FM_GRAD_REL, FM_CONST_L2 = 1e-3, 1e-2
ADAM_ULPS, ADAM_UPDATE_REL = 4.0, 1e-6
FM_LOSS_REL = 1e-5  # the SR + FM step's losses card vs CPU


def fm_input_grads(disc, inputs, cam, dev, dtype=torch.float32) -> dict:
    """The feature-matching loss of (image, raw) against the maps of a second
    pair, and its gradients with respect to both images, on `dev` in
    `dtype` (float64 copies of the discriminator on the CPU as a witness)."""
    from genefaceplusplus_tpu_torch.models.eg3d_discriminator import feature_matching_loss

    model = disc.to(dev, dtype)
    img, raw, rimg, rraw = (t.to(dev, dtype) for t in inputs)
    img, raw = img.detach().requires_grad_(True), raw.detach().requires_grad_(True)  # leaves on each device
    with torch.no_grad():
        _, real = model(rimg, rraw, cam.to(dev, dtype))
    _, feats = model(img, raw, cam.to(dev, dtype))
    feature_matching_loss(feats, real).backward()
    disc.to("cpu", torch.float32)
    return {"grad_image": img.grad.double().cpu(), "grad_raw": raw.grad.double().cpu()}


def disc_card_vs_cpu(disc, dev) -> dict:
    """The converted discriminator on the card and on the CPU, on seeded
    inputs in [0, 1] (what the SR task feeds it) at SIZE^2: the logits and
    each feature map at batch DISC_BATCH, max |card - CPU| over the CPU's
    largest |value|; the feature-matching loss's input gradients at batch
    1, the card's and the CPU's each against the CPU's float64 gradient
    (max |d| over the largest |g64| and the L2 distance over |g64|: the
    loss is an L1 of lrelu features, so float32 rounding flips some of its
    signs and kinks, on either device); the card's forward and forward +
    FM backward by CUDA events."""
    from genefaceplusplus_tpu_torch.models.eg3d_discriminator import feature_matching_loss

    g = torch.Generator().manual_seed(41)
    R = SIZE
    img, raw = torch.rand((DISC_BATCH, 3, R, R), generator=g), torch.rand((DISC_BATCH, 3, R // 2, R // 2), generator=g)
    cam = torch.randn((DISC_BATCH, 25), generator=g)
    out = {}
    for d in ("cpu", dev):
        with torch.no_grad():
            logits, feats = disc.to(d)(img.to(d), raw.to(d), cam.to(d))
        out[str(d)] = {"logits": logits.cpu(), **{f"map{i}": f.cpu() for i, f in enumerate(feats)}}
    rel = {k: ((out[str(dev)][k] - ref).abs().max() / ref.abs().max()).item() for k, ref in out["cpu"].items()}
    shapes = [tuple(out["cpu"][f"map{i}"].shape[1:]) for i in range(len(feats))]

    pair = [torch.rand((1, 3, R, R), generator=g), torch.rand((1, 3, R // 2, R // 2), generator=g),
            torch.rand((1, 3, R, R), generator=g), torch.rand((1, 3, R // 2, R // 2), generator=g)]
    c1 = torch.randn((1, 25), generator=g)
    grads = {"card": fm_input_grads(disc, pair, c1, dev), "cpu": fm_input_grads(disc, pair, c1, "cpu"),
             "f64": fm_input_grads(disc, pair, c1, "cpu", torch.float64)}
    witness = {}
    for k, g64 in grads["f64"].items():
        witness[k] = {f"{who}_{how}": ((grads[who][k] - g64).abs().max() / g64.abs().max()).item() if how == "max"
                      else ((grads[who][k] - g64).norm() / g64.norm()).item()
                      for who in ("card", "cpu") for how in ("max", "l2")}
        witness[k]["card_vs_cpu_max"] = ((grads["card"][k] - grads["cpu"][k]).abs().max() / g64.abs().max()).item()

    model = disc.to(dev)
    x, r = img.to(dev), raw.to(dev)
    x.requires_grad_(True)
    with torch.no_grad():
        _, real = model(x.detach(), r, cam.to(dev))
        fwd = cuda_ms(lambda: model(x, r, cam.to(dev)), 5)

    def fwd_bwd():
        _, f = model(x, r, cam.to(dev))
        feature_matching_loss(f, real).backward()
    both = cuda_ms(fwd_bwd, 5)
    disc.to("cpu")
    return {"rel": rel, "witness": witness, "shapes": shapes,
            "ms": {"forward": statistics.median(fwd), "forward_backward": statistics.median(both)}}


def fm_step_card_vs_cpu(cfg, ckpt, dev) -> dict:
    """One SR + FM step of the CLI's task (float32 SR) on the card and on
    the CPU from a trained checkpoint (its Adam state), one frame and one
    noise draw, each step's gradient sums also redone in float64
    (`Float64Sums`): every loss's relative difference; for each gradient
    tensor (the trained buffers too) max |card - CPU| over the CPU's
    largest entry and the L2 distance over the CPU's norm, with
    `grad_witness`'s readings against the CPU step's float64 sums and the
    card against its own operands' float64 sums where `Float64Sums` has
    them, and whether the tensor passes its bound (see FM_GRAD_REL); then
    the card's Adam step against the CPU's Adam applied to the card's
    gradients from the same state (parameters and both moments,
    `adam_replay`), and the updated parameters card vs CPU."""
    from genefaceplusplus_tpu_torch.training import run
    from genefaceplusplus_tpu_torch.training.schedulers import _moments
    from genefaceplusplus_tpu_torch.training.trainer import load_flax_state

    cfg = cfg.replace(sr_dtype="float32")
    grads, after, losses, sums, buffers, noise = {}, {}, {}, {}, set(), None
    for d, who in (("cpu", "cpu"), (dev, "card")):
        task = run.build_task(cfg, device=d)
        task.load_extra_state(ckpt["extra_state"])
        if noise is None:
            noise = torch.rand(task.dataset.H * task.dataset.W, generator=torch.Generator().manual_seed(7))
        state = load_flax_state(task.create_state(), ckpt["state_dict"])
        with Float64Sums(state.model) as sums[who]:
            _, m = task.train_step(state, {"frame_idx": 3}, noise=noise.to(d))
        losses[who] = {k: float(v) for k, v in m.items() if k.endswith("loss")}
        grads[who] = {k: p.grad.detach().cpu() for k, p in state.opt.named}
        moms = _moments(state.opt.opt, state.opt.named)
        after[who] = {k: (p.detach().cpu(), moms[k][0].cpu(), moms[k][1].cpu()) for k, p in state.opt.named}
        buffers = {k for k, _ in state.model.named_buffers()}
        if who == "cpu":
            cpu_task = task
    rows, zero = {}, []
    for k, ref in grads["cpu"].items():
        g_card = grads["card"][k]
        if ref.abs().max().item() == 0.0:
            zero.append(k)
            continue
        row = {"max": ((g_card - ref).abs().max() / ref.abs().max()).item(),
               "l2": ((g_card - ref).norm() / ref.norm()).item()}
        if k in sums["cpu"].refs:
            _, row["w_card"], row["w_cpu"], row["spread"], row["witness_ok"] = grad_witness(
                g_card, ref, sums["cpu"].refs[k], sums["cpu"].spread[k])
            r64 = sums["card"].refs[k].cpu()  # the card against its own operands' float64 sums
            row["own"] = ((g_card.double() - r64).abs().max() / r64.abs().max()).item()
        if k.endswith("noise_strength"):
            row["ok"] = row.get("witness_ok", False)
        elif k in buffers:
            row["ok"] = row["l2"] <= FM_CONST_L2
        elif "own" in row:
            row["ok"] = row["max"] <= FM_GRAD_REL and row["own"] <= GRID_GRAD_REL
        else:
            row["ok"] = row["max"] <= GRID_GRAD_REL
        rows[k] = row
    check(all(grads["card"][k].abs().max().item() == 0.0 for k in zero),
          f"train_disc: a gradient is 0 on the CPU only: {zero}")

    # the card's Adam step, replayed on the CPU from the card's gradients
    replay = load_flax_state(cpu_task.create_state(), ckpt["state_dict"])
    before = {k: p.detach().clone() for k, p in replay.opt.named}
    for k, p in replay.opt.named:
        p.grad = grads["card"][k].clone()
    replay.opt.step()
    mom = _moments(replay.opt.opt, replay.opt.named)
    adam = {}
    for k, p in replay.opt.named:
        for i, (want, name) in enumerate(((p.detach(), "param"), (mom[k][0], "exp_avg"), (mom[k][1], "exp_avg_sq"))):
            adam[(k, name)] = adam_replay(after["card"][k][i], want, before[k] if name == "param" else None)
    moved = {k: ((after["card"][k][0] - after["cpu"][k][0]).abs().max().item(),
                 (after["cpu"][k][0] - before[k]).abs().max().item()) for k in before}
    return {"rows": rows, "adam": adam, "moved": moved,
            "loss_rel": {k: abs(losses["card"][k] - v) / abs(v) if v else abs(losses["card"][k])
                         for k, v in losses["cpu"].items()}}


def adam_replay(got, want, before=None) -> tuple:
    """(max |got - want| over the allowance, ok) for one tensor of an Adam
    step that two devices computed from the same gradients and state: each
    entry within ADAM_ULPS float32 ulps of `want`, plus, for a parameter,
    ADAM_UPDATE_REL of its update `want - before` (the update's own
    rounding)."""
    got, want = got.double(), want.double()
    allow = ADAM_ULPS * torch.finfo(torch.float32).eps * want.abs() + torch.finfo(torch.float32).tiny
    if before is not None:
        allow = allow + ADAM_UPDATE_REL * (want - before.double()).abs()
    ratio = ((got - want).abs() / allow).max().item()
    return ratio, ratio <= 1.0


def phase_train_disc(dev, binary: str, root: str) -> int:
    """train_disc (module docstring), on train_cli's identity in `binary`
    (train_cli's work dirs in `root`); returns the fused_field launches of
    the frames served from the trained dir."""
    import hashlib

    from genefaceplusplus_tpu_torch.config import load_config, set_hparams
    from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer
    from genefaceplusplus_tpu_torch.models.eg3d_discriminator import EG3DDualDiscriminator
    from genefaceplusplus_tpu_torch.models.radnerf_torso import TorsoField
    from genefaceplusplus_tpu_torch.ops import fused_field as ff
    from genefaceplusplus_tpu_torch.testing import reference_disc_state, save_reference_ckpt
    from genefaceplusplus_tpu_torch.tools import convert_ckpt
    from genefaceplusplus_tpu_torch.utils.ckpt import get_all_ckpts, get_last_checkpoint, save_flax_checkpoint
    from genefaceplusplus_tpu_torch.utils.convert_jax import convert_flax_params, export_flax_params

    repo = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()

    # the reference's discriminator at full width, converted
    t0 = time.perf_counter()
    src = os.path.join(root, "reference_disc", f"model_ckpt_steps_{DISC_STEP}.ckpt")
    os.makedirs(os.path.dirname(src))
    state = reference_disc_state(seed=31, img_resolution=SIZE)
    save_reference_ckpt(src, state, global_step=DISC_STEP, sub_model="disc")
    with open(os.path.join(root, "reference_disc", "config.yaml"), "w") as f:
        f.write(f"final_resolution: {SIZE}\n")  # the reference's config beside its checkpoint
    disc_dir = os.path.join(root, "disc")
    path = convert_ckpt.main(["--input", src, "--type", "disc", "--out", disc_dir])
    convert_s = time.perf_counter() - t0
    n_map = int(set_hparams(work_dir=disc_dir)["disc_mapping_layers"])
    disc = EG3DDualDiscriminator(img_resolution=SIZE, mapping_layers=n_map)
    disc.load_state_dict(convert_flax_params(get_last_checkpoint(disc_dir)[0]["state_dict"]["disc"], disc))
    check(n_map == 8 and np.array_equal(getattr(disc, f"b{SIZE}").conv0.weight.detach().numpy(),
                                        state[f"b{SIZE}.conv0.weight"])
          and np.array_equal(disc.mapping.fc7.weight.detach().numpy(), state["mapping.fc7.weight"]),
          "train_disc: the converted discriminator")
    n_params = sum(p.numel() for p in disc.parameters())
    with open(path, "rb") as f:
        disc_sha = hashlib.sha256(f.read()).hexdigest()
    print(f"[train_disc] the reference's disc sub-model faked at full width ({SIZE}^2, channel_base 32768, channel_max "
          f"512, {len(state)} torch tensors, {n_params:,} parameters), converted by --type disc at step {DISC_STEP} in "
          f"{convert_s:.1f} s: mapping depth {n_map}, every tensor restored into EG3DDualDiscriminator")

    # the discriminator alone, card vs CPU
    t0 = time.perf_counter()
    r = disc_card_vs_cpu(disc, dev)
    del disc
    worst = max(r["rel"].items(), key=lambda kv: kv[1])
    print(f"[train_disc] {card_line()}; the discriminator alone at {SIZE}^2, batch {DISC_BATCH}, card vs CPU, max |d| "
          f"over the largest |value|: " + ", ".join(f"{k} {v:.3e}" for k, v in r["rel"].items())
          + f" (worst {worst[0]} {worst[1]:.3e}, <= {DISC_REL}); feature maps {r['shapes']}; on the card forward "
          f"{r['ms']['forward']:.3f} ms, forward + FM backward {r['ms']['forward_backward']:.3f} ms (CUDA events, "
          f"median of 5); {time.perf_counter() - t0:.1f} s")
    ok = worst[1] <= DISC_REL
    for k, w in r["witness"].items():
        print(f"[train_disc] the FM loss's {k} (batch 1) against the CPU's float64 gradient: card max "
              f"{w['card_max']:.3e} of the largest, L2 {w['card_l2']:.3e}; CPU float32 max {w['cpu_max']:.3e}, L2 "
              f"{w['cpu_l2']:.3e}; card vs CPU max {w['card_vs_cpu_max']:.3e} (the card within {DISC_ORDER_K}x the "
              f"CPU's + {DISC_REL})")
        ok = ok and all(w[f"card_{how}"] <= DISC_ORDER_K * w[f"cpu_{how}"] + DISC_REL for how in ("max", "l2"))
    check(ok, "train_disc: the discriminator card vs CPU")

    # the CLI's head + SR stage with feature matching
    work = os.path.join(root, "disc_sr")
    cfg_path = os.path.join(repo, TRAIN_CLI_STAGES["sr"][0])
    argv = ["--config", cfg_path, "--exp_name", "chip_smoke_disc", "--work_dir", work, "--hparams",
            f"{train_cli_common(binary)},lpips_start_iters=0,lambda_dual_fm={DISC_LAMBDA},disc_model_dir={disc_dir}"]
    t0 = time.perf_counter()
    res = run_cli_stages([argv], "train_disc")[0]
    wall = time.perf_counter() - t0
    steps = [x for x in _stage_metrics(work) if "total_loss" in x]
    check([x["step"] for x in steps] == list(range(1, TRAIN_CLI_STEPS + 1)), f"train_disc: steps logged "
                                                                             f"{[x['step'] for x in steps]}")
    check(all(math.isfinite(x.get("dual_feature_matching_loss", math.nan)) for x in steps),
          "train_disc: dual_feature_matching_loss missing or not finite in a step")
    check(all(math.isfinite(v) for x in steps for k, v in x.items() if k.endswith("loss")),
          "train_disc: a loss is not finite")
    check(res["global_step"] == TRAIN_CLI_STEPS and res["ckpt_equal"], "train_disc: the checkpoint")
    check(res["disc_equal"], "train_disc: the discriminator's tensors changed")
    with open(path, "rb") as f:
        check(hashlib.sha256(f.read()).hexdigest() == disc_sha, "train_disc: the disc dir's checkpoint changed")
    ckpt, ckpt_path = get_last_checkpoint(work)
    check(set(ckpt["state_dict"]["params"]) == {"head", "sr"} and "disc" not in ckpt["state_dict"],
          "train_disc: a discriminator leaf in the checkpoint")
    with open(os.path.join(root, "sr", "chip_smoke_stage.json")) as f:
        sr_stage = json.load(f)  # train_cli's head + SR stage in this run
    sr_ms = sr_stage["step_ms"][1:]
    fm_ms = res["step_ms"][1:]
    passes = res["disc_ms"]
    fake, real = passes[0::2], passes[1::2]
    fm = [x["dual_feature_matching_loss"] for x in steps]
    print(f"[train_disc] the CLI's head + SR stage ({TRAIN_CLI_STAGES['sr'][0]}) with lambda_dual_fm {DISC_LAMBDA} "
          f"and disc_model_dir from step 1, {TRAIN_CLI_STEPS} steps, {wall:.1f} s of wall: "
          f"dual_feature_matching_loss in every step ({fm[0]:.5f} .. {fm[-1]:.5f}), the discriminator's tensors "
          f"bit-equal after the run, its dir's checkpoint unchanged, {os.path.basename(ckpt_path)} holds params "
          f"{sorted(ckpt['state_dict']['params'])} and no discriminator leaf, equal to the live state")
    print(f"[train_disc] {card_line()}; head + SR + FM ms/step (host wall, synchronised, steps 2..{TRAIN_CLI_STEPS}): "
          f"median {statistics.median(fm_ms):.3f}, min {min(fm_ms):.3f}, max {max(fm_ms):.3f}; train_cli's head + "
          f"SR (no FM, this run): median {statistics.median(sr_ms):.3f}, min {min(sr_ms):.3f}, max {max(sr_ms):.3f}; "
          f"the discriminator's passes by CUDA events over {len(fake)} steps: fake (with autograd) median "
          f"{statistics.median(fake):.3f} ms, real (no grad) median {statistics.median(real):.3f} ms; peak "
          f"allocated {res['peak_gib']:.3f} GiB (train_cli's head + SR stage: {sr_stage['peak_gib']:.3f} GiB)")

    # one SR + FM step, card vs CPU
    t0 = time.perf_counter()
    g = fm_step_card_vs_cpu(set_hparams(work_dir=work), ckpt, dev)
    rows = g["rows"]
    parts = {"mlps": ("head.ambient_net", "head.sigma_net", "head.color_net"),
             "fourier": ("head.position_embedder.B", "head.ambient_embedder.B"),
             "condition": ("head.cond_prenet", "head.cond_att_net", "head.blink_"), "noise": ("noise_strength",),
             "noise_const": ("noise_const",), "sr": ("sr.",)}
    worst = {}
    for k, row in rows.items():
        part = next((p for p, names in parts.items() if k.startswith(names) or k.endswith(names)), "other")
        if part not in worst or row["max"] > worst[part][1]["max"]:
            worst[part] = (k, row)
    summed = ("noise_strength", "_embedder.B", "individual_embeddings")
    check(all("own" in rows[k] for k in rows if k.endswith(summed)),
          "train_disc: a noise strength, Fourier projection or individual code without its float64 sum")
    failed = [k for k, row in rows.items() if not row["ok"]]
    witnessed = {k: row for k, row in rows.items() if "own" in row}
    print(f"[train_disc] one SR + FM step (float32 SR) card vs CPU from the trained state, frame 3, one noise draw "
          f"({time.perf_counter() - t0:.1f} s): losses relative " + ", ".join(
              f"{k} {v:.3e}" for k, v in g["loss_rel"].items())
          + f" (<= {FM_LOSS_REL}); gradients card vs CPU, max |d| / max |g| and L2 over |g|, each part's worst: "
          + "; ".join(f"{p} {row['max']:.3e}, {row['l2']:.3e} ({k})" for p, (k, row) in worst.items())
          + f"; past {GRID_GRAD_REL} of the largest entry: "
          + (", ".join(f"{k} {row['max']:.3e}" for k, row in rows.items() if row["max"] > GRID_GRAD_REL) or "none")
          + f" (parameters within {GRID_GRAD_REL}, those with float64 sums within {FM_GRAD_REL}; the noise_const "
            f"buffers' L2 within {FM_CONST_L2})")
    print(f"[train_disc] the same gradients against the CPU step's sums redone in float64 ({len(witnessed)} tensors: "
          f"the head's nn.Linear layers, both Fourier projections, the individual codes, the SR's noise strengths), "
          f"each part's worst tensor above: " + "; ".join(
              f"{p} card {row['w_card']:.3e}, CPU {row['w_cpu']:.3e} of the largest entry (the card against its own "
              f"operands' float64 sums {row['own']:.3e}), the terms' absolute sum {row['spread']:.1f}x it"
              for p, (k, row) in worst.items() if "own" in row)
          + f" (the card against its own operands' float64 sums within {GRID_GRAD_REL}: worst "
            f"{max(row['own'] for row in witnessed.values()):.3e})")
    print("[train_disc] the noise strengths' gradients (scalar sums; each card entry within "
          f"{GRID_GRAD_ABS} of its terms' absolute sum + {GRID_GRAD_REL} of the largest from the CPU's float64 sum): "
          + "; ".join(f"{k} card vs CPU {row['max']:.3e} of the CPU's, card {row['w_card']:.3e} and CPU "
                      f"{row['w_cpu']:.3e} from float64, terms' absolute sum {row['spread']:.1f}x it"
                      for k, row in rows.items() if k.endswith("noise_strength")))
    adam_worst = max(g["adam"].items(), key=lambda kv: kv[1][0])
    moved = max(g["moved"].items(), key=lambda kv: kv[1][0])
    print(f"[train_disc] the card's Adam step against the CPU's Adam on the card's gradients from the same state "
          f"({len(g['adam'])} tensors: parameters, trained buffers and both moments): worst {adam_worst[1][0]:.3f} "
          f"of the allowance ({adam_worst[0][0]} {adam_worst[0][1]}; {ADAM_ULPS:.0f} float32 ulps + "
          f"{ADAM_UPDATE_REL} of the update, <= 1); the updated parameters card vs CPU (each from its own "
          f"gradients): max |d| {moved[1][0]:.3e} ({moved[0]}, whose largest update is {moved[1][1]:.3e})")
    check(not failed, "train_disc: gradients card vs CPU: " + "; ".join(
        f"{k} {rows[k]}" for k in failed))
    check(all(ok for _, ok in g["adam"].values()),
          f"train_disc: the card's Adam step: {[k for k, (_, ok) in g['adam'].items() if not ok]}")
    check(max(g["loss_rel"].values()) <= FM_LOSS_REL, "train_disc: the losses card vs CPU")

    # serving from the FM-trained head + SR dir, with a seeded torso dir
    tcfg = torso_config()
    cwd = os.getcwd()
    os.chdir(repo)  # base_config paths are relative to the repository root
    try:
        torso_yaml = load_config(TRAIN_CLI_STAGES["torso"][0])
    finally:
        os.chdir(cwd)
    torso_dir = os.path.join(root, "disc_torso")
    save_flax_checkpoint(torso_dir, 1, {
        "state_dict": {"torso_params": export_flax_params(TorsoField(tcfg, generator=torch.Generator().manual_seed(9))),
                       "opt_state": {}},
        "extra_state": {"torso_grid": bench_torso_grid(tcfg.grid_size)}},
        config=dict(torso_yaml, head_model_dir=work, binary_data_dir=binary, video_id="syn"))
    infer = GeneFaceInfer.from_work_dirs(torso_model_dir=torso_dir, device=dev)
    batch = infer.prepare_gt_batch(list(range(DISC_SERVE_FRAMES)))
    torch.cuda.synchronize()
    ff.fused_field.launches = 0  # count only the main path's launches
    t0 = time.perf_counter()
    frames = list(infer.forward_secc2video(batch, {"frames_per_dispatch": DISC_SERVE_FRAMES}))
    serve_ms = (time.perf_counter() - t0) * 1e3
    launches = ff.fused_field.launches
    H = infer.dataset.H
    check(len(frames) == DISC_SERVE_FRAMES and all(f.shape == (2 * H, 2 * H, 3) and f.dtype == np.uint8
                                                   for f in frames), "train_disc: served frames")
    check(any(not np.array_equal(frames[0], f) for f in frames[1:]), "train_disc: frames do not vary")
    check(launches == DISC_SERVE_FRAMES, f"train_disc: fused_field launched {launches} times for "
                                         f"{DISC_SERVE_FRAMES} frames")
    print(f"[train_disc] served from the FM-trained head + SR dir with a seeded torso dir: {len(frames)} frames of "
          f"{2 * H}x{2 * H} in {serve_ms:.1f} ms (first request, host wall), {launches} fused_field launches; "
          f"checkpoints kept {len(get_all_ckpts(work))}; the phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def train_cli_common(binary: str) -> str:
    """The hparams every train_cli stage shares."""
    return (f"binary_data_dir={binary},video_id=syn,max_updates={TRAIN_CLI_STEPS},val_check_interval=6,"
            f"update_extra_interval={TRAIN_CLI_START},tb_log_interval=1")


# quality: the instruments on QUALITY_FRAMES frames that serve_full served
# (512^2): the v1 and v2 landmark detectors (seeded weights), card vs CPU
# (landmarks within LMD_REL of the largest, v2's peak probabilities within
# LMD_CONF_ABS); detect_lmd against the detector's own landmarks and a
# 1/512 shift of them; the sync scorer trained on the card on
# tests/test_sync_scorer.py's clip at HuBERT's width, JAX's three controls,
# and sync_confidence card vs CPU on its params.
QUALITY_FRAMES = N_REQUESTS * FRAMES_PER_REQUEST
LMD_REL, LMD_CONF_ABS = 1e-4, 1e-5
SYNC_STEPS, SYNC_BATCH, SYNC_AUDIO_DIM, SYNC_CURVE_ABS = 500, 48, 1024, 1e-4


def phase_quality(dev, frames) -> None:
    """quality (module docstring), on serve_full's frames."""
    from genefaceplusplus_tpu_torch.metrics import lmd, sync_scorer
    from genefaceplusplus_tpu_torch.testing import sync_clip
    from genefaceplusplus_tpu_torch.utils.convert_jax import export_flax_params

    frames = np.stack(frames)
    check(frames.shape == (QUALITY_FRAMES, SIZE, SIZE, 3) and frames.dtype == np.uint8, "quality: the frames")
    readings = []
    for arch, seed in (("v1", 51), ("v2", 52)):
        params = export_flax_params(lmd.lm_detector(arch, generator=torch.Generator().manual_seed(seed)))
        lms = {"cpu": lmd.detect_lms(frames, "", arch=arch, params=params, device="cpu")}
        lmd.detect_lms(frames[:2], "", arch=arch, params=params, device=dev)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lms[str(dev)] = lmd.detect_lms(frames, "", arch=arch, params=params, device=dev)
        ms = (time.perf_counter() - t0) * 1e3
        rel = np.abs(lms[str(dev)] - lms["cpu"]).max() / np.abs(lms["cpu"]).max()
        conf_d = None
        if arch == "v2":
            conf = {str(d): lmd.detect_lmd(frames, lms["cpu"], "", arch=arch, per_landmark=True, with_conf=True,
                                           params=params, device=d)[1] for d in ("cpu", dev)}
            conf_d = float(np.abs(conf[str(dev)] - conf["cpu"]).max())
        own = lmd.detect_lmd(frames, lms[str(dev)], "", arch=arch, params=params, device=dev)
        shifted = lmd.detect_lmd(frames, lms[str(dev)] + np.array([1.0 / 512.0, 0.0]), "", arch=arch, params=params,
                                 device=dev)
        readings.append((arch, rel, conf_d, own, shifted, ms))
        check(rel <= LMD_REL and (conf_d is None or conf_d <= LMD_CONF_ABS),
              f"quality: the {arch} detector card vs CPU ({rel:.3e}, {conf_d})")
        check(own <= 1e-3 and abs(shifted - 1.0) <= 1e-3, f"quality: detect_lmd ({own}, {shifted})")
    for arch, rel, conf_d, own, shifted, ms in readings:
        print(f"[quality] {card_line()}; {arch} detector (seeded weights) on serve_full's {QUALITY_FRAMES} frames of "
              f"{SIZE}x{SIZE}: card vs CPU landmarks {rel:.3e} of the largest (<= {LMD_REL})"
              + ("" if conf_d is None else f", peak probabilities max |d| {conf_d:.3e} (<= {LMD_CONF_ABS})")
              + f"; detect_lmd against its own landmarks {own:.3e} px (<= 1e-3), with a 1/512 shift {shifted:.6f} px "
                f"(1 +- 1e-3); {QUALITY_FRAMES} frames detected on the card in {ms:.3f} ms (host wall, resize on "
                f"the host included)")

    hubert, lms = sync_clip(audio_dim=SYNC_AUDIO_DIM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = sync_scorer.train_sync_scorer(hubert, lms, steps=SYNC_STEPS, batch=SYNC_BATCH, seed=0, device=dev)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / SYNC_STEPS
    aligned = sync_scorer.sync_confidence(params, hubert, lms, device=dev)
    blocks = hubert.reshape(-1, 2, hubert.shape[-1])
    shuffled = sync_scorer.sync_confidence(
        params, blocks[np.random.RandomState(3).permutation(len(blocks))].reshape(hubert.shape), lms, device=dev)
    frozen = sync_scorer.sync_confidence(params, hubert, np.repeat(lms[:1], len(lms), 0), device=dev)
    cpu = sync_scorer.sync_confidence(params, hubert, lms, device="cpu")
    curve_d = float(np.abs(np.asarray(aligned["curve"]) - np.asarray(cpu["curve"])).max())
    print(f"[quality] {card_line()}; sync scorer trained on the card, {SYNC_STEPS} steps of batch {SYNC_BATCH} at "
          f"audio_dim {SYNC_AUDIO_DIM}, {step_ms:.3f} ms/step (host wall, synchronised): aligned confidence "
          f"{aligned['confidence']:.4f} at offset {aligned['offset']} (> 0.15 at |offset| <= 1), shuffled audio "
          f"{shuffled['confidence']:.4f}, frozen mouth {frozen['confidence']:.4f} (each < half the aligned); "
          f"sync_confidence card vs CPU: curve max |d| {curve_d:.1e} (<= {SYNC_CURVE_ABS}, both rounded to 4 "
          f"decimals), offset {aligned['offset']} / {cpu['offset']}")
    check(abs(aligned["offset"]) <= 1 and aligned["confidence"] > 0.15, f"quality: aligned {aligned}")
    check(shuffled["confidence"] < 0.5 * aligned["confidence"], "quality: shuffled audio does not collapse")
    check(frozen["confidence"] < 0.5 * aligned["confidence"], "quality: a frozen mouth carries signal")
    check(curve_d <= SYNC_CURVE_ABS * (1 + 1e-6) and aligned["offset"] == cpu["offset"],
          "quality: sync_confidence card vs CPU")


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

        t0 = time.perf_counter()
        preempted_at = run_until_sigterm(argv("a2m"), dirs["a2m"], TRAIN_AUDIO_SIGTERM, TRAIN_AUDIO_STEPS,
                                         os.path.join(root, "a2m_sigterm.log"), "train_audio a2m")
        # the a2m's resume, then the postnet, in one process
        res = dict(zip(TRAIN_AUDIO_STAGES, run_cli_stages([argv(name) for name in TRAIN_AUDIO_STAGES],
                                                          "train_audio a2m + postnet")))
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


# onboard: a new identity from video to served frames, the port alone
ONBOARD_FRAMES = 66  # 60 train + 6 val samples
ONBOARD_STEPS = 20  # each fleet stage
ONBOARD_SERVE_FRAMES = 8
ONBOARD_HPARAMS = "update_extra_interval=8,tb_log_interval=1"  # the fleet's, beside the data dir and validation
# the fit's mean landmark error in pixels at 512^2: the stand-in basis is 68
# random points, not a face, so the fit cannot follow the synthetic face's
# landmarks closely (CPU rehearsal, 22 frames: 72.6 px, against 117.4 px at
# zero coefficients); the bounds say the fit ran and moved the landmarks
# toward the detections, not how good a fit is
ONBOARD_FIT_PX, ONBOARD_FIT_GAIN = 90.0, 0.75
# the card's fit against the CPU's: each reading (coefficients relative to
# their largest entry, losses relative, reprojected landmarks in pixels)
# within FIT_ORDER_K x the CPU float32 fit's distance from the CPU float64
# fit, plus FIT_FLOOR of it (Adam normalises gradient entries near its eps,
# so float32 rounding moves a 400-iteration fit along the loss's flat
# directions: the reading is the order of that motion, not a fixed bound).
# The losses and the reprojected landmarks decide the check. exp and trans
# move along the stand-in basis's flat directions (exp against the pose) by
# ~0.1 of their largest entry in float32 (PR 20's T = 250 fits), so 4x that
# passes almost any exp or trans. exp is held through its reprojection
# instead (exp_px: the largest landmark displacement, in pixels, that a
# fit's exp alone makes against the float64 fit's, both with the float64
# fit's id and pose; data/fit_3dmm.py:exp_displacement_px), its coefficient
# reading only printed; trans is still held only that loosely; id and euler
# read ~1e-3 and are held in earnest
FIT_ORDER_K, FIT_FLOOR = 4.0, 1e-6
FIT_T, FIT_K, FIT_CPU_ITERS, FIT_SLICE, FIT_PROFILE_ITERS = 6000, 468, 20, 250, 10


def onboard_identity(data: str, vid: str, dev) -> dict:
    """The raw video and the precomputed inputs mediapipe would give:
    raw/videos/<vid>.mp4 (H.264 written by the port's Mp4Writer on `dev`),
    processed/videos/<vid>/{aud.wav, segmaps/*.png, lms_2d.npy}. Returns the
    synthetic identity's dict."""
    from genefaceplusplus_tpu_torch.data.audio import save_wav_16k
    from genefaceplusplus_tpu_torch.data.image_io import write_png
    from genefaceplusplus_tpu_torch.data.segmenter import encode_segmap_image, onehot_from_categories
    from genefaceplusplus_tpu_torch.data.synthetic_face import synthetic_face
    from genefaceplusplus_tpu_torch.data.video import Mp4Writer

    ds = synthetic_face(num_frames=ONBOARD_FRAMES, size=SIZE, seed=5, head_masks=True)
    samples = ds["train_samples"] + ds["val_samples"]
    os.makedirs(os.path.join(data, "raw", "videos"))
    writer = Mp4Writer(os.path.join(data, "raw", "videos", f"{vid}.mp4"), fps=25, device=dev)
    for s in samples:
        writer.append(s["gt_img"])
    writer.close()
    proc = os.path.join(data, "processed", "videos", vid)
    os.makedirs(os.path.join(proc, "segmaps"))
    save_wav_16k(voiced_wav(ONBOARD_FRAMES / 25.0, 140.0, 200.0, seed=9), os.path.join(proc, "aud.wav"))
    for i, s in enumerate(samples):
        # classes: head -> face-skin; the torso layer's skin-coloured neck ->
        # body-skin, its cloth -> clothes; the rest background
        cat = np.zeros((SIZE, SIZE), np.int64)
        torso = s["torso_img"]
        alpha = torso[..., 3] > 127
        skin = torso[..., 0].astype(np.int64) > torso[..., 2]
        cat[alpha & skin], cat[alpha & ~skin], cat[s["head_mask"]] = 2, 4, 3
        write_png(os.path.join(proc, "segmaps", f"{i:08d}.png"), encode_segmap_image(onehot_from_categories(cat)))
    np.save(os.path.join(proc, "lms_2d.npy"), (np.stack([s["lms"] for s in samples]) * SIZE).astype(np.float32))
    return ds


def camera_mp4_check(path: str, ds: dict, dev) -> None:
    """The onboarded mp4 as the frames step read it (data/mp4.py:read_mp4_frames,
    the host decoder): ONBOARD_FRAMES frames, and the first and the last
    equal to decode_own's and to the encoder's reconstruction (h264.encode_plain
    of the same frames on `dev`), all three planes."""
    from genefaceplusplus_tpu_torch.data import h264
    from genefaceplusplus_tpu_torch.data.mp4 import read_mp4_frames, read_mp4_track

    decoded = list(read_mp4_frames(path))
    check(len(decoded) == ONBOARD_FRAMES, f"onboard: {path} decodes to {len(decoded)} frames")
    track = read_mp4_track(path)
    samples = ds["train_samples"] + ds["val_samples"]
    picks = (0, ONBOARD_FRAMES - 1)
    enc = h264.encode_plain(torch.from_numpy(np.stack([samples[i]["gt_img"] for i in picks])).to(dev), 0)
    for k, i in enumerate(picks):
        own = h264.decode_own(track.samples[i], track.sps, track.pps)
        for c, (mine, theirs) in enumerate(((decoded[i].y, own.y), (decoded[i].cb, own.cb), (decoded[i].cr, own.cr))):
            h, w = mine.shape
            check(np.array_equal(mine, theirs), f"onboard: frame {i} plane {c} differs from decode_own's")
            check(np.array_equal(mine, enc.recon[c][k, :h, :w].cpu().numpy()),
                  f"onboard: frame {i} plane {c} differs from the encoder's reconstruction")
    print(f"[onboard] {os.path.basename(path)}: {len(decoded)} frames decoded on the host "
          "(csrc/h264_decode.cpp); frames 0 and the last equal decode_own's and the encoder's reconstruction, "
          "Y, Cb and Cr")


def h264_decode_reading(dev, root: str, ds: dict) -> dict:
    """Host ms a frame of the H.264 decoder (read_mp4_frames: demux, decode,
    nothing more) at 512^2: the port's own 100-frame mp4 (the onboarded
    frames again, written by Mp4Writer on `dev`) and tools/h264_streams.py's
    seeded CABAC B stream (I P B B, 4 frames), whose luma digest is held to
    DIGEST_LUMA_SHA256 (FFmpeg's, tests/test_torch_h264_decode.py)."""
    from genefaceplusplus_tpu_torch.data.mp4 import read_mp4_frames
    from genefaceplusplus_tpu_torch.data.video import Mp4Writer
    from genefaceplusplus_tpu_torch.tools import h264_streams as hs

    samples = ds["train_samples"] + ds["val_samples"]
    own = os.path.join(root, "own100.mp4")
    writer = Mp4Writer(own, fps=25, device=dev)
    for i in range(100):
        writer.append(samples[i % len(samples)]["gt_img"])
    writer.close()
    t0 = time.perf_counter()
    n_own = sum(1 for _ in read_mp4_frames(own))
    own_ms = (time.perf_counter() - t0) * 1e3 / max(n_own, 1)
    cabac = os.path.join(root, "cabac_b.mp4")
    t0 = time.perf_counter()
    hs.write_stream(hs.DIGEST_SPEC, cabac, hs.DIGEST_SEED)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    frames = list(read_mp4_frames(cabac))
    cabac_ms = (time.perf_counter() - t0) * 1e3 / max(len(frames), 1)
    digest = hs.luma_digest(f.y for f in frames)
    check(n_own == 100 and len(frames) == 4, f"decode: {n_own} and {len(frames)} frames")
    check(digest == hs.DIGEST_LUMA_SHA256, f"decode: the CABAC B stream's luma digest {digest} is not FFmpeg's "
                                           f"{hs.DIGEST_LUMA_SHA256}")
    import platform

    cpu = next((line.split(":", 1)[1].strip() for line in open("/proc/cpuinfo") if line.startswith("model name")),
               platform.processor() if platform.processor() not in ("", "unknown") else platform.machine())
    print(f"[decode] {card_line()}; host {cpu}, {os.cpu_count()} cores: 512^2 H.264 on the host, "
          f"{own_ms:.2f} ms a frame for the port's own 100-frame mp4 (CAVLC intra), {cabac_ms:.2f} ms a frame for "
          f"the seeded CABAC B stream (I P B B, written in {write_s:.1f} s by tools/h264_streams.py), its luma digest "
          "equal to FFmpeg's")
    return {"own_ms": own_ms, "cabac_ms": cabac_ms}


def fit_distances(fit, ref, helper) -> dict:
    """Per reading, how far `fit` lies from `ref`: each coefficient tensor
    relative to ref's largest entry, both losses relative, the reprojected
    landmarks' largest distance in pixels at SIZE, and that of fit's exp
    alone (exp_px)."""
    from genefaceplusplus_tpu_torch.data.fit_3dmm import exp_displacement_px

    out = {k: float(np.abs(fit[k] - ref[k]).max() / max(np.abs(ref[k]).max(), 1e-30))
           for k in ("id", "exp", "euler", "trans")}
    for k in ("final_loss", "pose_loss"):
        out[k] = abs(fit[k] - ref[k]) / abs(ref[k])

    def reproj(c):
        t = [torch.as_tensor(np.asarray(c[k], np.float32)) for k in ("id", "exp", "euler", "trans")]
        return helper.reconstruct_lm2d(*t).numpy() * SIZE

    out["lm_px"] = float(np.abs(reproj(fit) - reproj(ref)).max())
    out["exp_px"] = exp_displacement_px(helper, fit, ref, SIZE)
    return out


def fit_card_vs_cpu(lm2d, dev, mode: str, what: str) -> dict:
    """The default fit of `lm2d` on the card, the CPU in float32 and the CPU
    in float64; fails where a card reading exceeds FIT_ORDER_K x the CPU
    float32 one's (plus FIT_FLOOR). The losses and the reprojected landmarks
    (lm_px, and exp_px for exp) are what a wrong card fit fails; the exp
    coefficients are printed only and trans's bound is loose (both sit on
    flat directions: FIT_ORDER_K's comment). Returns the distances."""
    from genefaceplusplus_tpu_torch.data.face3d import Face3DHelper
    from genefaceplusplus_tpu_torch.data.fit_3dmm import fit_3dmm_for_video

    cpu = Face3DHelper.synthetic(mode)
    f64 = Face3DHelper.synthetic(mode)
    for name in ("key_mean_shape", "key_id_base", "key_exp_base", "persc_proj"):
        setattr(f64, name, getattr(f64, name).double())
    fits = {"card": fit_3dmm_for_video(lm2d, Face3DHelper.synthetic(mode, device=dev)),
            "cpu": fit_3dmm_for_video(lm2d, cpu), "f64": fit_3dmm_for_video(lm2d, f64)}
    d_card, d_cpu = fit_distances(fits["card"], fits["f64"], cpu), fit_distances(fits["cpu"], fits["f64"], cpu)
    d_pair = fit_distances(fits["card"], fits["cpu"], cpu)
    print(f"[{what}] fit card vs CPU ({lm2d.shape[0]} frames x {lm2d.shape[1]} points, 200 + 200 iterations): "
          + ", ".join(f"{k} {v:.3e}" for k, v in d_pair.items()) + "; from the CPU's float64 fit: card "
          + ", ".join(f"{k} {v:.3e}" for k, v in d_card.items()) + "; CPU float32 "
          + ", ".join(f"{k} {v:.3e}" for k, v in d_cpu.items())
          + f" (bound: {FIT_ORDER_K} x the CPU float32's + {FIT_FLOOR}; the losses, lm_px and exp_px decide; the "
            f"exp coefficients are printed only, trans lies on flat directions)")
    for k, v in d_card.items():
        if k == "exp":
            continue  # held through exp_px
        check(v <= FIT_ORDER_K * d_cpu[k] + FIT_FLOOR, f"{what}: the card's fit {k} {v:.3e} from float64 against "
                                                         f"the CPU float32's {d_cpu[k]:.3e}")
    return {"pair": d_pair, "card": d_card, "cpu": d_cpu}


def phase_onboard(dev) -> tuple:
    """onboard (module docstring). Returns its B1 and h264_intra launches."""
    from genefaceplusplus_tpu_torch.data import fit_3dmm, process
    from genefaceplusplus_tpu_torch.data.audio import extract_f0
    from genefaceplusplus_tpu_torch.data.face3d import Face3DHelper
    from genefaceplusplus_tpu_torch.data.mp4 import read_mp4_track
    from genefaceplusplus_tpu_torch.data.video import read_avi
    from genefaceplusplus_tpu_torch.inference import cli
    from genefaceplusplus_tpu_torch.ops import fused_field as ff
    from genefaceplusplus_tpu_torch.ops import h264_encode as he
    from genefaceplusplus_tpu_torch.training import fleet, run
    from genefaceplusplus_tpu_torch.utils.ckpt import get_all_ckpts, save_flax_checkpoint
    from genefaceplusplus_tpu_torch.utils.convert_jax import export_flax_params
    from genefaceplusplus_tpu_torch.config import load_config

    repo = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="chip_smoke_onboard_")
    walls = {}
    cwd = os.getcwd()
    os.chdir(repo)  # the configs' base_config paths are relative to the repository root
    try:
        data, vid = os.path.join(root, "data"), "Onboard"
        t0 = time.perf_counter()
        ds = onboard_identity(data, vid, dev)
        walls["identity"] = time.perf_counter() - t0
        proc = os.path.join(data, "processed", "videos", vid)

        # data preparation, the fit timed on the card and its device checked
        fits = []
        fit = fit_3dmm.fit_3dmm_for_video

        def watched_fit(lm2d, helper, *a, **kw):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fit(lm2d, helper, *a, **kw)
            torch.cuda.synchronize()
            fits.append((helper.key_mean_shape.device, (time.perf_counter() - start) * 1e3))
            return out

        fit_3dmm.fit_3dmm_for_video = watched_fit
        torch.cuda.synchronize()
        he.h264_intra.launches = 0  # count only the main path's launches (debug_fit.mp4)
        try:
            steps = process.main(["--video_id", vid, "--data_dir", data, "--device", str(dev), "--size", str(SIZE),
                                  "--steps", "frames,audio,segment,fit,debug_fit,binarize"])
        finally:
            fit_3dmm.fit_3dmm_for_video = fit
        walls.update({f"process {k}": v for k, v in steps.items()})
        check(len(fits) == 1 and fits[0][0].type == dev.type, f"onboard: the fit ran on {[f[0] for f in fits]}")
        T = ONBOARD_FRAMES
        for name, n in (("gt_imgs", T), ("head_imgs", T), ("com_imgs", T), ("inpaint_torso_imgs", T),
                        ("torso_imgs", T), ("person_imgs", T), ("segmaps", T)):
            check(len(os.listdir(os.path.join(proc, name))) == n, f"onboard: {name} holds "
                                                                    f"{len(os.listdir(os.path.join(proc, name)))}")
        for f in ("bg.jpg", "coeff_fit_mp.npy", "lms_2d.npy", "aud_mel_f0.npy"):
            check(os.path.exists(os.path.join(proc, f)), f"onboard: {f} missing")
        h264_launches = he.h264_intra.launches
        t0 = time.perf_counter()
        camera_mp4_check(os.path.join(data, "raw", "videos", f"{vid}.mp4"), ds, dev)
        walls["decode check"] = time.perf_counter() - t0
        fit_video = read_mp4_track(os.path.join(proc, "debug_fit.mp4"))
        debug_shape = (len(fit_video.samples), fit_video.height, fit_video.width)
        check(debug_shape == (T, SIZE, 2 * SIZE), f"onboard: debug_fit.mp4 {debug_shape}")
        check(h264_launches == -(-T // 8), f"onboard: h264_intra launched {h264_launches} times for {T} "
                                           "debug_fit frames")
        binary = os.path.join(data, "binary", "videos")
        rec = np.load(os.path.join(binary, vid, "trainval_dataset.npy"), allow_pickle=True).tolist()
        n_train = T // 11 * 10  # 60 of 66
        check(len(rec["train_samples"]) == n_train and len(rec["val_samples"]) == T - n_train,
              "onboard: the record's split")
        for smp in rec["train_samples"] + rec["val_samples"]:
            for k in ("head_img_fname", "torso_img_fname", "gt_img_fname"):
                check(os.path.exists(smp[k]), f"onboard: {smp[k]} missing")
        coeff = np.load(os.path.join(proc, "coeff_fit_mp.npy"), allow_pickle=True).tolist()
        lms = np.load(os.path.join(proc, "lms_2d.npy"))
        helper = Face3DHelper.synthetic("lm68")
        pred = helper.reconstruct_lm2d(*(torch.as_tensor(coeff[k]) for k in ("id", "exp", "euler", "trans"))).numpy()
        err_px = float(np.linalg.norm(pred * 512.0 - lms, axis=-1).mean())  # step_fit's 512 scale
        zeros = helper.reconstruct_lm2d(*(torch.zeros(T, n) for n in (80, 64, 3, 3))).numpy()
        err0_px = float(np.linalg.norm(zeros * 512.0 - lms, axis=-1).mean())
        print(f"[onboard] {card_line()}; {T} frames of {SIZE}^2 through data/process.py: "
              + ", ".join(f"{k} {v:.3f} s" for k, v in steps.items())
              + f"; the fit on {fits[0][0]} {fits[0][1]:.1f} ms (400 iterations, {fits[0][1] / 400:.3f} ms an "
                f"iteration, host wall synchronised), final loss {coeff['final_loss']:.4e}, mean landmark error "
                f"{err_px:.2f} px against {err0_px:.2f} at zero coefficients (bounds {ONBOARD_FIT_PX} px and "
                f"{ONBOARD_FIT_GAIN} x that); debug_fit.mp4 {debug_shape} ({h264_launches} h264_intra launches)")
        check(err_px < ONBOARD_FIT_PX and err_px < ONBOARD_FIT_GAIN * err0_px,
              f"onboard: the fit's mean landmark error {err_px:.2f} px ({err0_px:.2f} at zero coefficients)")
        t0 = time.perf_counter()
        fit_card_vs_cpu((lms / 512.0).astype(np.float32), dev, "lm68", "onboard")
        walls["fit card vs CPU"] = time.perf_counter() - t0

        # the fleet: head + SR, then torso, on the card; a second run skips both
        stages = []
        main = run.main

        def watched_main(argv):
            t1 = time.perf_counter()
            state = main(argv)
            stages.append((argv[argv.index("--exp_name") + 1], time.perf_counter() - t1, int(state.global_step),
                           next(state.model.parameters()).device))
            return state

        argv = ["--video_ids", vid, "--head_config", os.path.join(repo, "egs/datasets/May/lm3d_radnerf_sr.yaml"),
                "--torso_config", os.path.join(repo, "egs/datasets/May/lm3d_radnerf_torso_sr.yaml"),
                "--data_dir", data, "--ckpt_root", os.path.join(root, "checkpoints"),
                "--max_updates_head", str(ONBOARD_STEPS), "--max_updates_torso", str(ONBOARD_STEPS),
                "--hparams", f"binary_data_dir={binary},val_check_interval={ONBOARD_STEPS},{ONBOARD_HPARAMS}",
                "--device", str(dev)]
        run.main = watched_main
        try:
            t0 = time.perf_counter()
            dirs = fleet.main(argv)[vid]
            walls["fleet"] = time.perf_counter() - t0
            out = io_capture(lambda: fleet.main(argv))
        finally:
            run.main = main
        check([s[0] for s in stages] == [f"{vid}_head", f"{vid}_torso"], f"onboard: fleet stages {stages}")
        for name, wall, step, d in stages:
            check(step == ONBOARD_STEPS and d.type == dev.type, f"onboard: {name} ended at step {step} on {d}")
            check(bool(get_all_ckpts(os.path.join(root, "checkpoints", name))), f"onboard: {name} has no checkpoint")
        for stage in ("preprocess", "head", "torso"):
            check(re.search(rf"\[{vid}\] {stage}: .*skipping", out) is not None,
                  f"onboard: the second fleet run did not skip {stage}")
        print(f"[onboard] training/fleet.py: " + "; ".join(f"{n} {w:.1f} s ({s} steps on {d})" for n, w, s, d in stages)
              + "; the second run skipped preprocess, head and torso")

        # serving from the fleet's dirs through the CLI, plain and --debug
        hp = a2m_hparams()
        from genefaceplusplus_tpu_torch.models.audio2motion.vae_model import a2m_model_from_hparams

        a2m = a2m_model_from_hparams(hp)
        a2m.load_state_dict(seeded_a2m_params(hp, 4))
        a2m_dir = os.path.join(root, "a2m")
        a2m_yaml = load_config("egs/datasets/May/audio2motion_vae.yaml")
        save_flax_checkpoint(a2m_dir, 40000, {"state_dict": {"variables": export_flax_params(a2m), "opt_state": {}}},
                             config=a2m_yaml)
        wav = voiced_wav(ONBOARD_SERVE_FRAMES / 25.0, 150.0, 170.0, seed=11)
        n_hub = 2 * ONBOARD_SERVE_FRAMES
        feats = {"hubert": np.random.RandomState(12).randn(n_hub, 1024).astype(np.float32),
                 "f0": extract_f0(wav, mel_len=n_hub), "wav16k": wav}
        fpath = os.path.join(root, "request.npy")
        np.save(fpath, feats, allow_pickle=True)
        served, launches = {}, 0
        for how, extra, ext in (("plain", [], "avi"), ("debug", ["--debug"], "avi"), ("debug mp4", ["--debug"], "mp4")):
            torch.cuda.synchronize()
            ff.fused_field.launches = he.h264_intra.launches = 0  # count only the main path's launches
            t0 = time.perf_counter()
            path = cli.main(["--a2m_ckpt", a2m_dir, "--torso_ckpt", dirs["torso"], "--drv_aud_features", fpath,
                             "--out_name", os.path.join(root, f"{how.replace(' ', '_')}.{ext}"),
                             "--device", str(dev)] + extra)
            walls[f"serve {how}"] = time.perf_counter() - t0
            n = ff.fused_field.launches
            check(n == ONBOARD_SERVE_FRAMES, f"onboard: fused_field launched {n} times for {ONBOARD_SERVE_FRAMES} "
                                             f"{how} frames")
            launches += n
            served[how] = read_avi(path)[0] if ext == "avi" else read_mp4_track(path)
        plain, debug = served["plain"], served["debug"]
        # --debug to an mp4: the panels composed on the host, uploaded and encoded by the kernel
        n_h264 = he.h264_intra.launches
        check(n_h264 == -(-ONBOARD_SERVE_FRAMES // 8), f"onboard: h264_intra launched {n_h264} times for "
                                                       f"{ONBOARD_SERVE_FRAMES} --debug frames")
        h264_launches += n_h264
        encoded = he.encode_access_units(torch.from_numpy(debug).to(dev), 0)
        check(served["debug mp4"].samples == encoded, "onboard: the --debug mp4's samples vs the kernel's encode "
                                                       "of the --debug AVI's panels")
        check(plain.shape == (ONBOARD_SERVE_FRAMES, SIZE, SIZE, 3), f"onboard: plain frames {plain.shape}")
        check(debug.shape == (ONBOARD_SERVE_FRAMES, SIZE, 3 * SIZE, 3), f"onboard: debug frames {debug.shape}")
        check(np.array_equal(debug[:, :, :SIZE], plain), "onboard: the debug frames' first panel vs the plain frames")
        check(debug[:, :, SIZE:2 * SIZE].any(), "onboard: an empty SECC panel")
        check(any(not np.array_equal(plain[0], f) for f in plain[1:]), "onboard: the served frames do not vary")
        print(f"[onboard] inference/cli.py from the fleet's dirs: {ONBOARD_SERVE_FRAMES} frames of {SIZE}^2 plain "
              f"({walls['serve plain']:.1f} s) and with --debug ({walls['serve debug']:.1f} s, "
              f"{debug.shape[1]}x{debug.shape[2]}, the first panel equal to the plain frame bit for bit; lit pixels "
              f"a frame: SECC {int(debug[:, :, SIZE:2 * SIZE].any(-1).sum()) / ONBOARD_SERVE_FRAMES:.0f}, lm68 "
              f"{int(debug[:, :, 2 * SIZE:].any(-1).sum()) / ONBOARD_SERVE_FRAMES:.0f}), "
              f"{launches} fused_field launches; to an mp4 with --debug ({walls['serve debug mp4']:.1f} s) its samples "
              f"equal to the kernel's encode of the AVI's panels, {n_h264} h264_intra launch")
        t0 = time.perf_counter()
        h264_decode_reading(dev, root, ds)
        walls["decode reading"] = time.perf_counter() - t0
        del ds
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    print(f"[onboard] wall by step (s): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    return launches, h264_launches


def io_capture(fn) -> str:
    """What `fn()` prints to stdout (it is also passed through)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    text = buf.getvalue()
    sys.stdout.write(text)
    return text


def phase_fit(dev) -> dict:
    """fit (module docstring)."""
    from genefaceplusplus_tpu_torch.data.face3d import Face3DHelper
    from genefaceplusplus_tpu_torch.data.fit_3dmm import FitConfig, fit_3dmm_for_video

    cpu = Face3DHelper.synthetic("mediapipe")
    card = Face3DHelper.synthetic("mediapipe", device=dev)
    rng = np.random.RandomState(13)
    T = FIT_T
    t = np.arange(T, dtype=np.float32)[:, None] / 25.0
    true = {"id": np.tile(rng.randn(1, 80).astype(np.float32) * 0.3, (T, 1)),
            "exp": (0.2 * np.sin(2 * np.pi * (0.3 + rng.rand(1, 64)) * t + rng.rand(1, 64) * 6)).astype(np.float32),
            "euler": (0.1 * np.sin(2 * np.pi * 0.1 * t + rng.rand(1, 3) * 6)).astype(np.float32),
            "trans": (0.05 * np.sin(2 * np.pi * 0.07 * t + rng.rand(1, 3) * 6)).astype(np.float32)}
    lm2d = cpu.reconstruct_lm2d(*(torch.as_tensor(true[k]) for k in ("id", "exp", "euler", "trans"))).numpy()
    lm2d = (lm2d + rng.randn(*lm2d.shape).astype(np.float32) * 0.002).astype(np.float32)
    check(lm2d.shape == (FIT_T, FIT_K, 2), f"fit: landmarks {lm2d.shape}")

    fit_3dmm_for_video(lm2d[:50], card, FitConfig(iters_pose=2, iters_joint=2))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    t0 = time.perf_counter()
    fit = fit_3dmm_for_video(lm2d, card)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    check(all(np.isfinite(fit[k]).all() for k in ("id", "exp", "euler", "trans")) and fit["final_loss"]
          < fit["pose_loss"], f"fit: final loss {fit['final_loss']} against the pose phase's {fit['pose_loss']}")
    n_prof = FIT_PROFILE_ITERS // 2
    acts, kernels, busy, top = profile_device(lambda: (fit_3dmm_for_video(
        lm2d, card, FitConfig(iters_pose=n_prof, iters_joint=FIT_PROFILE_ITERS - n_prof)), FIT_PROFILE_ITERS)[1])
    t0 = time.perf_counter()
    fit_3dmm_for_video(lm2d, cpu, FitConfig(iters_pose=FIT_CPU_ITERS, iters_joint=0))
    cpu_ms = (time.perf_counter() - t0) * 1e3 / FIT_CPU_ITERS
    ms_iter = wall * 1e3 / 400
    print(f"[fit] {card_line()}; {FIT_T} frames x {FIT_K} points, 200 + 200 iterations on the card: "
          f"{wall:.3f} s of host wall ({ms_iter:.3f} ms an iteration), final loss {fit['final_loss']:.4e} (pose "
          f"phase {fit['pose_loss']:.4e}), peak allocated {peak:.3f} GiB above the phase's start; under torch.profiler "
          f"({FIT_PROFILE_ITERS} iterations): "
          + (f"{kernels:.1f} kernels and {busy:.3f} ms of device busy an iteration ({acts:.1f} activities); top: "
             + "; ".join(f"{n} x{c:.1f} {ms:.4f} ms" for n, c, ms in top[:5]) if acts is not None
             else "no device activity")
          + f"; the CPU's first {FIT_CPU_ITERS} iterations at the same size: {cpu_ms:.1f} ms an iteration "
            f"({host_cpu()})")
    dist = fit_card_vs_cpu(lm2d[:FIT_SLICE], dev, "mediapipe", "fit")
    return {"ms_iter": ms_iter, "wall_s": wall, "kernels": kernels, "busy_ms": busy, "peak_gib": peak,
            "cpu_ms_iter": cpu_ms, "dist": dist}


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
    if sys.argv[1:2] == ["--reference"]:  # PARENT_REFERENCE's contents for this tree
        write_reference(dev, sys.argv[2])
        return 0
    t0 = time.perf_counter()
    walls = {}

    def timed(name, fn, *args):
        start = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - start
        return out

    timed("build", phase_build)
    k, kt = timed("kernel", phase_kernel, dev)
    kb, kw = timed("kernel_bwd", phase_kernel_bwd, dev, kt["extra_ms"])
    serve_launches, fourier_ms = timed("serve", phase_serve, dev)
    full_launches, full_infer, full_requests, full_frames = timed("serve_full", phase_serve_full, dev)
    mesh_launches = timed("serve_mesh", phase_serve_mesh, dev, full_infer, full_requests)
    compact_launches = timed("serve_compact", phase_serve_compact, dev, full_infer, full_requests)
    del full_infer
    audio_launches = timed("serve_audio", phase_serve_audio, dev)
    print(f"ffmpeg: {shutil.which('ffmpeg')}")
    work = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        cli_launches, cli_h264, served = timed("serve_cli", phase_serve_cli, dev, work)
        mesh_cli_launches = timed("serve_mesh_cli", phase_serve_mesh_cli, dev, served)
        hk = timed("h264", phase_h264, dev, served)
        long_launches = timed("serve_long", phase_serve_long, dev, served)
        convert_launches = timed("convert", phase_convert, dev, served)
        app_launches, app_h264 = timed("serve_app", phase_serve_app, dev, served)
        grid_h264 = timed("serve_grid", phase_serve_grid, dev, served, fourier_ms)
        hubert_launches = timed("hubert", phase_hubert, dev, served)
        del served
    finally:
        shutil.rmtree(work, ignore_errors=True)
    timed("quality", phase_quality, dev, full_frames)
    del full_frames
    train_fwd, train_chain, train_wgrad, train_compacted = timed("train", phase_train, dev)
    train_root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        trained_launches, binary = timed("train_cli", phase_train_cli, dev, train_root)
        timed("train_grid", phase_train_grid, dev, binary, train_root)
        disc_launches = timed("train_disc", phase_train_disc, dev, binary, train_root)
    finally:
        shutil.rmtree(train_root, ignore_errors=True)
    refined_launches = timed("train_audio", phase_train_audio, dev)
    onboard_launches, onboard_h264 = timed("onboard", phase_onboard, dev)
    timed("fit", phase_fit, dev)
    print(f"[done] {time.perf_counter() - t0:.1f} s; by phase (host wall): "
          + ", ".join(f"{name} {s:.1f} s" for name, s in walls.items()))
    print(f"[launches] fused_field: {serve_launches} head-only serving + {full_launches} full-frame serving + "
          f"{mesh_launches} full-frame serving over a mesh (one a shard a frame) + {mesh_cli_launches} the CLI "
          f"with --n_devices 2 + "
          f"{compact_launches} full-frame serving on the compact buffer (compact_frac 'auto') + "
          f"{audio_launches} audio-driven serving + {cli_launches} CLI (plain and with --compact_frac auto) and "
          f"streaming + {long_launches} long clip + "
          f"{convert_launches} from the converted a2m + {app_launches} web app (serve_grid: none, its grid heads "
          f"run the float32 field) + {hubert_launches} from bare wavs through HuBERT (the CLI and the stream) + "
          f"{trained_launches} serving from CLI-trained dirs + {disc_launches} serving from "
          f"the FM-trained head + SR dir + {refined_launches} serving "
          f"through the trained postnet + {onboard_launches} served from the onboarded identity's fleet dirs "
          f"(plain and --debug); in train mode: {train_fwd} training; fused_field_bwd_chain: {train_chain} "
          f"training; fused_field_wgrad: {train_wgrad} training ({train_compacted} of each of the three on the "
          f"compact buffer; serve_grid and train_grid launch none: grid heads run the float32 field); h264_intra: "
          f"{cli_h264} CLI mp4 + {grid_h264} serve_grid's infer_once + {app_h264} web app's POST /infer + "
          f"{onboard_h264} onboard (debug_fit.mp4 and the --debug CLI's mp4), one a chunk of 8 frames")
    source = "genefaceplusplus_tpu_torch/csrc/"
    pallas = "genefaceplusplus_tpu/ops/pallas/fused_field.py:"
    print(json.dumps({"kernels": [{
        "name": "fused_field", "route": "cuda", "source": source + "fused_field.cu", "replaces": pallas + "156",
        "launches": (serve_launches + full_launches + mesh_launches + mesh_cli_launches + compact_launches
                     + audio_launches + cli_launches + long_launches
                     + convert_launches + app_launches + hubert_launches + trained_launches + disc_launches
                     + refined_launches + onboard_launches),
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        "library_ms": None}, {
        # B1's train mode takes over _bwd_kernel's forward recompute
        "name": "fused_field_train", "route": "cuda", "source": source + "fused_field.cu", "replaces": pallas + "298",
        "launches": train_fwd, "max_abs_err": kt["max_abs_err"], "ms": kt["ms"],
        "plain_ms": kt["plain_ms"], "bound_ms": kt["bound_ms"], "bound_by": kt["bound_by"],
        "library_ms": None}, {
        # B2's chain: _bwd_kernel's input gradients
        "name": "fused_field_bwd_chain", "route": "cuda", "source": source + "fused_field_bwd.cu",
        "replaces": pallas + "333",
        "launches": train_chain, "max_abs_err": kb["max_abs_err"], "ms": kb["ms"],
        "plain_ms": kb["plain_ms"], "bound_ms": kb["bound_ms"], "bound_by": kb["bound_by"],
        "library_ms": None}, {  # no single PyTorch call computes the fused field or its backward
        "name": "fused_field_wgrad", "route": "cuda", "source": source + "fused_field_wgrad.cu",
        "replaces": pallas + "347",
        "launches": train_wgrad, "max_abs_err": kw["max_abs_err"], "ms": kw["ms"],
        "plain_ms": kw["plain_ms"], "bound_ms": kw["bound_ms"], "bound_by": kw["bound_by"],
        "library_ms": kw["library_ms"]}, {
        # port-only: JAX encodes outside JAX (imageio's libx264 or cv2's mp4v, the writer's _ensure); no
        # PyTorch call encodes H.264 (no NVENC binding, no ffmpeg)
        "name": "h264_intra", "route": "cuda", "source": source + "h264_intra.cu",
        "replaces": "genefaceplusplus_tpu/data/video.py:33",
        "launches": cli_h264 + grid_h264 + app_h264 + onboard_h264, "max_abs_err": hk["max_abs_err"],
        "ms": hk["ms"], "plain_ms": hk["plain_ms"], "bound_ms": hk["bound_ms"], "bound_by": hk["bound_by"],
        "library_ms": hk["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
