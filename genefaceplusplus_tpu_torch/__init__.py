"""GeneFace++ in PyTorch for an NVIDIA H100: the port of `genefaceplusplus_tpu`.

The package mirrors the JAX package's layout (`ops/`, `models/`, `utils/`,
`data/`, `inference/`) so each module sits where its JAX counterpart does.
It imports torch, numpy and scipy only: never jax, flax, yaml or cv2, and
nothing from `genefaceplusplus_tpu` at run time. The parity tests
(`tests/test_torch_*.py`) are the only code that imports both packages.

Ported so far: the GT-driven head-NeRF serving path of the non-SR config
(`egs/datasets/May/lm3d_radnerf.yaml`): condition encoders, the Fourier
field, interval ray marching with the probe prepass, compositing, the
head-only frame renderer and the render half of `GeneFaceInfer`. The field
on the main path is the hand-written CUDA kernel in `csrc/fused_field.cu`
(`ops/fused_field.py`). ROADMAP.md lists what is still to port.
"""

__version__ = "0.1.0"
