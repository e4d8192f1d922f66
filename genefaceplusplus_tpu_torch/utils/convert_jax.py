"""Weight bridge: the JAX package's flax variables (as numpy arrays) -> the
port's `state_dict`.

flax `Dense` kernels `[in, out]` become `Linear` weights `[out, in]`; flax
`Conv` kernels `[k, in, out]` become `Conv1d` weights `[out, in, k]`;
`Embed.embedding` becomes `Embedding.weight`. The super-resolution's own
leaves named `weight` keep their layout when 2-D (`FullyConnectedLayer`,
already `[out, in]`) and go from HWIO `[kh, kw, in, out]` to OIHW when 4-D;
its scalar `noise_strength` and its `buffers` collection (`noise_const`)
land as they are. The audio-to-motion model's layers: flax's
`ConvTranspose` kernel `[k, in, out]` becomes `ConvTranspose1d`'s `[in,
out, k]` flipped along k (flax does not flip a transposed convolution's
kernel, torch does); `BatchNorm` `scale`/`bias` become `weight`/`bias` and
its `batch_stats` collection's `mean`/`var` the `running_mean`/
`running_var` buffers (`num_batches_tracked` keeps the port's value).
Module paths map `Conv_i` -> `convs.i`, `ConvTranspose_i` -> `deconvs.i`,
`BatchNorm_i` -> `norms.i`, `Dense_i` -> `dense.i`, `blink_encoder_i` ->
`blink_encoder.i`. Every leaf must land on a port tensor (parameter or
buffer) of the same shape, and every port tensor must receive one:
anything else raises. A JAX `TrainState`'s
`params` (and a gradient tree of the same structure) convert the same way,
so a port optimizer can start from them (`TrainState.model.load_state_dict`).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


_MODULES = {"Conv": "convs", "ConvTranspose": "deconvs", "BatchNorm": "norms", "Dense": "dense",
            "blink_encoder": "blink_encoder"}
_BATCHNORM = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _module_name(part: str) -> str:
    m = re.fullmatch(r"(Conv|ConvTranspose|BatchNorm|Dense|blink_encoder)_(\d+)", part)
    if m is None:
        return part
    return f"{_MODULES[m.group(1)]}.{m.group(2)}"


def _leaf(path: Tuple[str, ...], arr: np.ndarray) -> Tuple[str, np.ndarray]:
    *mods, name = path
    key = ".".join(_module_name(p) for p in mods)

    def at(leaf: str) -> str:
        return f"{key}.{leaf}" if key else leaf

    parent = mods[-1] if mods else ""
    if parent.startswith("BatchNorm_"):
        return at(_BATCHNORM[name]), arr
    if name == "kernel" and parent.startswith("ConvTranspose_"):
        return at("weight"), arr[::-1].transpose(1, 2, 0)
    if name == "kernel":
        if arr.ndim == 2:
            return at("weight"), arr.T
        if arr.ndim == 3:
            return at("weight"), arr.transpose(2, 1, 0)
        raise ValueError(f"{'/'.join(path)}: unexpected kernel rank {arr.ndim}")
    if name == "weight" and arr.ndim == 4:
        return at("weight"), arr.transpose(3, 2, 0, 1)
    if name == "embedding":
        return at("weight"), arr
    return at(name), arr


def convert_flax_params(params: Mapping, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Convert flax variables ({'params': ...[, 'buffers': ...][,
    'batch_stats': ...]}, or a bare param tree) for `model`, checking that
    the conversion places every leaf and fills every parameter and buffer
    (BatchNorm's `num_batches_tracked` keeps the model's value)."""
    collections = ("params", "buffers", "batch_stats")
    if "params" in params:
        other = sorted(set(params) - set(collections))
        if other:
            raise KeyError(f"flax collections the port has no tensors for: {other}")
        leaves = [leaf for col in collections if col in params for leaf in _flatten(params[col])]
    else:
        leaves = list(_flatten(params))
    target = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in leaves:
        key, arr = _leaf(path, np.asarray(leaf))
        if key not in target:
            raise KeyError(f"flax leaf {'/'.join(path)} -> {key!r}: no such port parameter")
        if tuple(target[key].shape) != arr.shape:
            raise ValueError(f"flax leaf {'/'.join(path)} -> {key!r}: shape {arr.shape} "
                             f"!= port {tuple(target[key].shape)}")
        if key in out:
            raise KeyError(f"two flax leaves map to {key!r}")
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))
    for key, value in target.items():
        if key.endswith(".num_batches_tracked"):
            out[key] = value.clone()
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"port tensors without a flax leaf: {missing}")
    return out
