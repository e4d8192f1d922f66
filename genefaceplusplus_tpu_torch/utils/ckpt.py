"""Checkpoint store: step-stamped, atomic files (port of
`genefaceplusplus_tpu/utils/ckpt.py`: `checkpoint_path`, `get_all_ckpts`,
`get_last_checkpoint`, `load_ckpt_file`, `save_checkpoint` (as
`save_flax_checkpoint`), `restore_into`, with the same naming and
retention).

`model_ckpt_steps_{N}.ckpt` holds one of two formats, told apart by the
file's first byte:

- flax msgpack (a msgpack map), the JAX package's work dirs: read by
  `utils/msgpack.py`, and written in JAX's layout by
  `save_flax_checkpoint`, with the work dir's `config.yaml`;
- `torch.save` (a zip archive, `PK`), read only: the port's trainer wrote
  a dict of torch state dicts before it wrote JAX's layout.

Writes are atomic (`.part`, then `os.replace`). Retention keeps the newest
`num_ckpt_keep` plus every `milestone_interval` milestone.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from genefaceplusplus_tpu_torch.config import save_config
from genefaceplusplus_tpu_torch.utils import msgpack

_MSGPACK_MAP = {0xde, 0xdf} | set(range(0x80, 0x90))


def checkpoint_path(work_dir: str, step: int) -> str:
    return os.path.join(work_dir, f"model_ckpt_steps_{step}.ckpt")


def get_all_ckpts(work_dir: str) -> list:
    """Checkpoint paths, newest step first."""
    paths = glob.glob(os.path.join(work_dir, "model_ckpt_steps_*.ckpt"))
    return sorted(paths, key=lambda p: -int(re.findall(r"steps_(\d+)\.ckpt", p)[0]))


def load_ckpt_file(path: str, map_location=None) -> Dict[str, Any]:
    """A checkpoint file's payload: a flax msgpack tree (numpy leaves,
    bfloat16 ones as tensors) or a `torch.save` dict."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:1] and data[0] in _MSGPACK_MAP:
        return msgpack.unpackb(data)
    if data[:2] == b"PK":
        return torch.load(path, map_location=map_location, weights_only=True)
    raise ValueError(f"{path}: neither a flax msgpack checkpoint (a msgpack map) nor a torch.save "
                     f"archive (first bytes {data[:4]!r})")


def get_last_checkpoint(work_dir: str, steps: Optional[int] = None, map_location=None):
    """(ckpt_dict, path) of the newest (or the given step's) checkpoint, or
    (None, None)."""
    if steps is not None:
        path = checkpoint_path(work_dir, steps)
        paths = [path] if os.path.exists(path) else []
    else:
        paths = get_all_ckpts(work_dir)
    if not paths:
        return None, None
    return load_ckpt_file(paths[0], map_location=map_location), paths[0]


def _to_numpy(tree):
    """Every leaf as an array, as JAX's `save_checkpoint` maps them (Python
    scalars become 0-d arrays; bfloat16 tensors stay tensors)."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    if tree is None or (isinstance(tree, torch.Tensor) and tree.dtype == torch.bfloat16):
        return tree
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_flax_checkpoint(work_dir: str, step: int, state: Dict[str, Any], config=None,
                         num_ckpt_keep: int = 1, milestone_interval: int = 100_000) -> str:
    """Atomically write a checkpoint as the JAX package's `save_checkpoint`
    does: the payload `state` plus `global_step` as flax msgpack (numpy,
    numpy-scalar or tensor leaves), `config.yaml` beside it, the same
    retention."""
    os.makedirs(work_dir, exist_ok=True)
    if config is not None:
        save_config(config, work_dir)
    payload = dict(state)
    payload["global_step"] = step
    blob = msgpack.packb(_to_numpy(payload))
    path = checkpoint_path(work_dir, step)
    with open(path + ".part", "wb") as f:
        f.write(blob)
    os.replace(path + ".part", path)
    for old in get_all_ckpts(work_dir)[num_ckpt_keep:]:
        old_step = int(re.findall(r"steps_(\d+)\.ckpt", old)[0])
        if milestone_interval and old_step % milestone_interval == 0:
            continue
        os.remove(old)
    return path


def restore_into(template: Mapping[str, torch.Tensor],
                 loaded: Mapping[str, Any]) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """(state dict, restored keys): each tensor of `template` whose name is
    in `loaded` with the same shape takes the loaded value in the template's
    dtype; the others keep the template's value (JAX's lenient
    `restore_into`, on flat state dicts)."""
    out: Dict[str, torch.Tensor] = {}
    restored: List[str] = []
    for key, t in template.items():
        value = loaded.get(key)
        if value is not None and tuple(np.shape(value)) == tuple(t.shape):
            if not isinstance(value, torch.Tensor):
                value = torch.from_numpy(np.array(value))
            out[key] = value.to(t.dtype).clone()
            restored.append(key)
        else:
            out[key] = t
    return out, restored
