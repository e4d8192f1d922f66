"""Weight bridge: the JAX package's flax variables (as numpy arrays) -> the
port's `state_dict`.

flax `Dense` kernels `[in, out]` become `Linear` weights `[out, in]`; flax
`Conv` kernels `[k, in, out]` become `Conv1d` weights `[out, in, k]`, and
2-D ones `[kh, kw, in, out]` `Conv2d` weights `[out, in, kh, kw]` (the
perceptual towers); `Embed.embedding` becomes `Embedding.weight`. The super-resolution's own
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

`unwrap_train_state` takes the variables out of a JAX checkpoint (the
trainer's payload), and `export_flax_params` is the inverse of
`convert_flax_params`: a port model's tensors as the JAX variables tree,
told apart by the port module that holds each tensor (no flax needed).
`export_flax_tree` / `load_flax_tree` / `flax_tree_leaves` do the same for
a `ModuleDict` of models, one variables tree per entry (the SR task's
`{'head': ..., 'sr': ...}`).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

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
        if arr.ndim == 4:
            return at("weight"), arr.transpose(3, 2, 0, 1)
        raise ValueError(f"{'/'.join(path)}: unexpected kernel rank {arr.ndim}")
    if name == "weight" and arr.ndim == 4:
        return at("weight"), arr.transpose(3, 2, 0, 1)
    if name == "embedding":
        return at("weight"), arr
    return at(name), arr


def _collections(params: Mapping):
    """The variables' leaves, (path, array), over the collections the port
    holds; a tree without 'params' is a bare param tree."""
    collections = ("params", "buffers", "batch_stats")
    if "params" in params:
        return [leaf for col in collections if col in params for leaf in _flatten(params[col])]
    return list(_flatten(params))


def _array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):  # a bfloat16 leaf of a msgpack checkpoint
        return leaf.float().numpy()
    return np.asarray(leaf)


def flax_leaves(params: Mapping) -> Dict[str, Tuple[Tuple[str, ...], np.ndarray]]:
    """{port key: (flax path, array in the port's layout)} of every leaf of
    flax variables ({'params': ...[, 'buffers': ...][, 'batch_stats': ...]},
    or a bare param tree)."""
    out: Dict[str, Tuple[Tuple[str, ...], np.ndarray]] = {}
    for path, leaf in _collections(params):
        key, arr = _leaf(path, _array(leaf))
        if key in out:
            raise KeyError(f"two flax leaves map to {key!r}")
        out[key] = (path, arr)
    return out


def convert_flax_params(params: Mapping, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Convert flax variables ({'params': ...[, 'buffers': ...][,
    'batch_stats': ...]}, or a bare param tree) for `model`, checking that
    the conversion places every leaf and fills every parameter and buffer
    (BatchNorm's `num_batches_tracked` keeps the model's value)."""
    if "params" in params:
        other = sorted(set(params) - {"params", "buffers", "batch_stats"})
        if other:
            raise KeyError(f"flax collections the port has no tensors for: {other}")
    target = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for key, (path, arr) in flax_leaves(params).items():
        if key not in target:
            raise KeyError(f"flax leaf {'/'.join(path)} -> {key!r}: no such port parameter")
        if tuple(target[key].shape) != arr.shape:
            raise ValueError(f"flax leaf {'/'.join(path)} -> {key!r}: shape {arr.shape} "
                             f"!= port {tuple(target[key].shape)}")
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))
    for key, value in target.items():
        if key.endswith(".num_batches_tracked"):
            out[key] = value.clone()
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"port tensors without a flax leaf: {missing}")
    return out


def unwrap_train_state(ckpt: Mapping, sub: Optional[str] = None) -> Any:
    """The variables tree of a JAX checkpoint, as JAX's
    `GeneFaceInfer._load_params` finds it: the payload's 'state_dict'; from
    a TrainState (it has 'opt_state'), its 'params', 'torso_params' or
    'variables'; then the `sub` tree ('head', 'sr', 'torso') where present,
    else a 'model' tree where present."""
    state = ckpt.get("state_dict", ckpt)
    if isinstance(state, Mapping) and "opt_state" in state:
        for k in ("params", "torso_params", "variables"):
            if k in state:
                state = state[k]
                break
    if isinstance(state, Mapping):
        if sub is not None and sub in state:
            state = state[sub]
        elif "model" in state:
            state = state["model"]
    return state


_PORT_MODULES = {v: k for k, v in _MODULES.items()}


def _flax_path(module_path: str) -> list:
    """The flax module names of a port module path ('convs.0' -> 'Conv_0')."""
    parts, out, i = module_path.split(".") if module_path else [], [], 0
    while i < len(parts):
        if parts[i] in _PORT_MODULES and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"{_PORT_MODULES[parts[i]]}_{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    return out


def export_flax_params(model: torch.nn.Module,
                       values: Optional[Mapping[str, Optional[torch.Tensor]]] = None) -> Dict[str, Any]:
    """The JAX variables tree of `model`'s tensors (the inverse of
    `convert_flax_params`): {'params': ...[, 'buffers': ...][,
    'batch_stats': ...]} of float32 numpy arrays. `Linear` weights go back
    to `Dense` kernels [in, out]; `Conv1d` weights to `Conv` kernels [k, in,
    out] and `Conv2d` weights to [kh, kw, in, out]; `ConvTranspose1d`
    weights to unflipped `ConvTranspose` kernels; `Embedding` weights to
    `embedding`; BatchNorm's weight and bias to `scale` and `bias` and its
    running statistics to `batch_stats`; other modules' `weight` keeps its
    name (4-D ones go from OIHW to HWIO); other buffers land in `buffers`.
    BatchNorm's `num_batches_tracked` has no flax leaf.

    `values` ({state-dict key: tensor}) replaces the model's tensors of
    those keys, in their layout (an optimizer's moments); a None value
    writes an empty dict, as flax serialises optax's `MaskedNode`."""
    tree: Dict[str, Any] = {}

    def put(col: str, path, leaf: str, arr: Optional[torch.Tensor]):
        node = tree.setdefault(col, {})
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = {} if arr is None else np.array(arr.detach().cpu().float().numpy(), dtype=np.float32)

    params = dict(model.named_parameters())
    for key, t in model.state_dict().items():
        if values is not None and key in values:
            t = values[key]
        mod_path, _, name = key.rpartition(".")
        module = model.get_submodule(mod_path) if mod_path else model
        path = _flax_path(mod_path)

        def layout(fn):
            return None if t is None else fn(t)

        if isinstance(module, torch.nn.modules.batchnorm._BatchNorm):
            if name == "num_batches_tracked":
                continue
            inv = {v: k for k, v in _BATCHNORM.items()}
            put("params" if key in params else "batch_stats", path, inv[name], t)
        elif key not in params:
            put("buffers", path, name, t)
        elif name == "weight" and isinstance(module, torch.nn.Linear):
            put("params", path, "kernel", layout(lambda w: w.t()))
        elif name == "weight" and isinstance(module, torch.nn.ConvTranspose1d):
            put("params", path, "kernel", layout(lambda w: w.flip(-1).permute(2, 0, 1)))
        elif name == "weight" and isinstance(module, torch.nn.Conv1d):
            put("params", path, "kernel", layout(lambda w: w.permute(2, 1, 0)))
        elif name == "weight" and isinstance(module, torch.nn.Conv2d):
            put("params", path, "kernel", layout(lambda w: w.permute(2, 3, 1, 0)))
        elif name == "weight" and isinstance(module, torch.nn.Embedding):
            put("params", path, "embedding", t)
        elif name == "weight" and params[key].dim() == 4:
            put("params", path, "weight", layout(lambda w: w.permute(2, 3, 1, 0)))
        else:
            put("params", path, name, t)
    return tree


def _entries(model: torch.nn.Module):
    """(prefix, model) pairs: a ModuleDict's entries, or the model itself."""
    if isinstance(model, torch.nn.ModuleDict):
        return [(f"{k}.", m) for k, m in model.items()]
    return [("", model)]


def export_flax_tree(model: torch.nn.Module,
                     values: Optional[Mapping[str, Optional[torch.Tensor]]] = None) -> Dict[str, Any]:
    """`export_flax_params`, with a `ModuleDict` as {name: variables tree}
    (`values` keyed by the ModuleDict's own state-dict names)."""
    if not isinstance(model, torch.nn.ModuleDict):
        return export_flax_params(model, values)
    out = {}
    for prefix, m in _entries(model):
        sub = None if values is None else {k[len(prefix):]: v for k, v in values.items()
                                           if k.startswith(prefix)}
        out[prefix[:-1]] = export_flax_params(m, sub)
    return out


def flax_tree_leaves(tree: Mapping, model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """{state-dict key of `model`: array in the port's layout} of the leaves
    a variables tree holds (for a `ModuleDict`, one tree per entry); empty
    dicts (optax's masked leaves) hold none."""
    out: Dict[str, np.ndarray] = {}
    for prefix, _ in _entries(model):
        sub = tree[prefix[:-1]] if prefix else tree
        out.update({prefix + k: arr for k, (_, arr) in flax_leaves(sub).items()})
    return out


def load_flax_tree(model: torch.nn.Module, tree: Mapping):
    """Load a variables tree (for a `ModuleDict`, one per entry) into
    `model`, every leaf and every tensor accounted for
    (`convert_flax_params`)."""
    for prefix, m in _entries(model):
        m.load_state_dict(convert_flax_params(tree[prefix[:-1]] if prefix else tree, m))
