"""Checkpoint store: step-stamped, atomic files (port of
`genefaceplusplus_tpu/utils/ckpt.py`: `checkpoint_path`, `get_all_ckpts`,
`get_last_checkpoint`, `save_checkpoint` with the same naming and
retention).

`model_ckpt_steps_{N}.ckpt` holds a dict of torch state dicts written with
`torch.save` (atomic: `.part` then `os.replace`). Retention keeps the newest
`num_ckpt_keep` plus every `milestone_interval` milestone. A given config
is written beside them as `config.json` (the port reads no YAML). Reading
the JAX package's flax msgpack checkpoints is not ported yet (ROADMAP).
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Any, Dict, Optional

import torch


def checkpoint_path(work_dir: str, step: int) -> str:
    return os.path.join(work_dir, f"model_ckpt_steps_{step}.ckpt")


def get_all_ckpts(work_dir: str) -> list:
    """Checkpoint paths, newest step first."""
    paths = glob.glob(os.path.join(work_dir, "model_ckpt_steps_*.ckpt"))
    return sorted(paths, key=lambda p: -int(re.findall(r"steps_(\d+)\.ckpt", p)[0]))


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
    return torch.load(paths[0], map_location=map_location, weights_only=True), paths[0]


def save_checkpoint(work_dir: str, step: int, state: Dict[str, Any], config=None,
                    num_ckpt_keep: int = 1, milestone_interval: int = 100_000) -> str:
    """Atomically write a step-stamped checkpoint, then apply retention."""
    os.makedirs(work_dir, exist_ok=True)
    if config is not None:
        with open(os.path.join(work_dir, "config.json"), "w") as f:
            json.dump(config, f, indent=1, sort_keys=True, default=str)
    payload = dict(state)
    payload["global_step"] = step
    path = checkpoint_path(work_dir, step)
    tmp = path + ".part"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    for old in get_all_ckpts(work_dir)[num_ckpt_keep:]:
        old_step = int(re.findall(r"steps_(\d+)\.ckpt", old)[0])
        if milestone_interval and old_step % milestone_interval == 0:
            continue
        os.remove(old)
    return path
