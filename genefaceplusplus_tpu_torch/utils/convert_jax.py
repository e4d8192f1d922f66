"""Weight bridge: the JAX package's flax param tree (as numpy arrays) ->
the port's `state_dict`.

flax `Dense` kernels `[in, out]` become `Linear` weights `[out, in]`; flax
`Conv` kernels `[k, in, out]` become `Conv1d` weights `[out, in, k]`;
`Embed.embedding` becomes `Embedding.weight`. Module paths map `Conv_i` ->
`convs.i`, `Dense_i` -> `dense.i`, `blink_encoder_i` -> `blink_encoder.i`.
Every leaf must land on a port parameter of the same shape, and every port
parameter must receive one: anything else raises. A JAX `TrainState`'s
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


def _module_name(part: str) -> str:
    m = re.fullmatch(r"(Conv|Dense|blink_encoder)_(\d+)", part)
    if m is None:
        return part
    head = {"Conv": "convs", "Dense": "dense", "blink_encoder": "blink_encoder"}[m.group(1)]
    return f"{head}.{m.group(2)}"


def _leaf(path: Tuple[str, ...], arr: np.ndarray) -> Tuple[str, np.ndarray]:
    *mods, name = path
    key = ".".join(_module_name(p) for p in mods)
    if name == "kernel":
        if arr.ndim == 2:
            return f"{key}.weight", arr.T
        if arr.ndim == 3:
            return f"{key}.weight", arr.transpose(2, 1, 0)
        raise ValueError(f"{'/'.join(path)}: unexpected kernel rank {arr.ndim}")
    if name == "embedding":
        return f"{key}.weight", arr
    return (f"{key}.{name}" if key else name), arr


def convert_flax_params(params: Mapping, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Convert a flax variables dict ({'params': ...}) for `model`, checking
    that the conversion places every leaf and fills every parameter."""
    tree = params["params"] if "params" in params else params
    target = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(tree):
        key, arr = _leaf(path, np.asarray(leaf))
        if key not in target:
            raise KeyError(f"flax leaf {'/'.join(path)} -> {key!r}: no such port parameter")
        if tuple(target[key].shape) != arr.shape:
            raise ValueError(f"flax leaf {'/'.join(path)} -> {key!r}: shape {arr.shape} "
                             f"!= port {tuple(target[key].shape)}")
        if key in out:
            raise KeyError(f"two flax leaves map to {key!r}")
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"port parameters without a flax leaf: {missing}")
    return out
