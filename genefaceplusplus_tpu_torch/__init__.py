"""GeneFace++ in PyTorch for an NVIDIA H100: the port of `genefaceplusplus_tpu`.

The package mirrors the JAX package's layout (`ops/`, `models/`, `utils/`,
`data/`, `inference/`, `training/`) so each module sits where its JAX
counterpart does. It imports torch, numpy and scipy only: never jax, flax,
yaml, msgpack, cv2 or imageio, and nothing from `genefaceplusplus_tpu` at
run time. The parity tests (`tests/test_torch_*.py`) are the only code that
imports both packages.

Ported so far: the GT-driven serving path (condition encoders, the Fourier
field, interval ray marching with the probe prepass, compositing, the frame
renderer and the render half of `GeneFaceInfer`) for the non-SR head config
(`egs/datasets/May/lm3d_radnerf.yaml`) and for the full frame of
`egs/datasets/May/lm3d_radnerf_torso_sr.yaml` (head at 256^2, torso field,
2x StyleGAN2 super-resolution), and head-NeRF training (`training/tasks/head_task.py:HeadNeRFTask` and
`training/trainer.py:Trainer`), audio-driven frames, and the inference
surface on the JAX package's work dirs: `GeneFaceInfer.from_work_dirs`,
`infer_once`, `inference/cli.py` and `inference/serving.py:stream_infer`
(flax msgpack and YAML read by `utils/msgpack.py` and `config/`, video
written as an uncompressed AVI by `data/video.py`). The field on both paths is the hand-written
CUDA forward kernel `csrc/fused_field.cu`; training's backward is
`csrc/fused_field_bwd.cu` (`ops/fused_field.py`). ROADMAP.md lists what is
still to port.
"""

import torch

__version__ = "0.1.0"


def _settle_cpu_vector_math():
    """Run each MKL vector-math function the port calls once, on one thread.

    On the CPU, torch evaluates exp, log, log2, log10 and sqrt of float32
    tensors with MKL's vector math, split into chunks of 2048 elements
    across threads. When a process's first such call is already split
    across threads, the second thread's chunk can come out of a less
    accurate path: exp off by 1.5e-4 of its value, where it is otherwise
    exact to 1e-7. This was seen in 5 of 320 fresh processes that had run
    an XLA computation before, and only on that first call; in none of 630
    whose first call ran on one element, as the call here does."""
    x = torch.ones(1)
    for fn in (torch.exp, torch.log, torch.log2, torch.log10, torch.sqrt):
        fn(x)


_settle_cpu_vector_math()
