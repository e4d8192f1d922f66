"""Local Hugging Face snapshots: a model's JSON files and weights read from
disk, without `transformers`, `safetensors` or the network.

- `snapshot_dir(model_name)`: `model_name` itself where it is a directory
  holding `config.json`, else the hub cache's snapshot of the name's
  `refs/main` (`$HF_HUB_CACHE`, else `$HF_HOME/hub`, else
  `~/.cache/huggingface/hub`; `models--<org>--<name>/snapshots/<rev>/`),
  else None. Nothing is downloaded.
- `read_weights(dir)`: `model.safetensors` through the port's own parser
  of the format (an 8-byte little-endian header length, a JSON header of
  dtype, shape and data offsets, then raw little-endian tensors), else
  `pytorch_model.bin` through `torch.load(..., weights_only=True)`.
- `hubert_state_dict(raw)`: a `HubertModel` or `HubertForCTC` checkpoint's
  tensors under `models/hubert.py`'s names, as
  `HubertModel.from_pretrained` loads them: the `hubert.` prefix stripped,
  the CTC head (`lm_head.*`) and `masked_spec_embed` dropped, and the
  positional convolution's weight norm (`dim=2`; `weight_g`/`weight_v` as
  the released files hold it, or `parametrizations.weight.original0`/
  `original1` as transformers 4.57 writes it) folded into one weight.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from genefaceplusplus_tpu_torch.utils.convert_torch_ckpt import fold_weight_norm

WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin")
SAFETENSORS_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
                      "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
                      "U8": torch.uint8, "BOOL": torch.bool}
POS_CONV = "encoder.pos_conv_embed.conv"


def hub_cache() -> str:
    """The Hugging Face hub cache directory the environment names."""
    if os.environ.get("HF_HUB_CACHE"):
        return os.environ["HF_HUB_CACHE"]
    if os.environ.get("HF_HOME"):
        return os.path.join(os.environ["HF_HOME"], "hub")
    return os.path.join(os.path.expanduser("~"), ".cache", "huggingface", "hub")


def snapshot_dir(model_name: str) -> Optional[str]:
    """The local directory of `model_name` (module docstring), or None."""
    if os.path.isfile(os.path.join(model_name, "config.json")):
        return model_name
    repo = os.path.join(hub_cache(), "models--" + model_name.replace("/", "--"))
    try:
        with open(os.path.join(repo, "refs", "main")) as f:
            rev = f.read().strip()
    except OSError:
        return None
    snap = os.path.join(repo, "snapshots", rev)
    return snap if rev and os.path.isfile(os.path.join(snap, "config.json")) else None


def weights_file(snap: str) -> Optional[str]:
    """The snapshot's weight file (`WEIGHT_FILES` in order), or None."""
    for name in WEIGHT_FILES:
        path = os.path.join(snap, name)
        if os.path.isfile(path):
            return path
    return None


def read_json(snap: str, name: str) -> dict:
    with open(os.path.join(snap, name)) as f:
        return json.load(f)


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a .safetensors file, on the CPU. Raises ValueError
    for a header that does not describe the file."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: shorter than a safetensors header")
        (n,) = struct.unpack("<Q", head)
        if n > size - 8:
            raise ValueError(f"{path}: header length {n} past the end of the file")
        header = json.loads(f.read(n))
    data = np.memmap(path, np.uint8, "r", offset=8 + n) if size > 8 + n else np.zeros(0, np.uint8)
    out = {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(entry["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name} has dtype {entry['dtype']}, which the reader does not know")
        begin, end = entry["data_offsets"]
        shape = [int(s) for s in entry["shape"]]
        nbytes = int(np.prod(shape, dtype=np.int64)) * torch.empty(0, dtype=dtype).element_size()
        if not 0 <= begin <= end <= len(data) or end - begin != nbytes:
            raise ValueError(f"{path}: tensor {name}'s offsets {begin}..{end} do not hold {entry['dtype']} {shape}")
        out[name] = (torch.from_numpy(np.array(data[begin:end])).view(dtype).reshape(shape) if nbytes
                     else torch.empty(shape, dtype=dtype))
    return out


def read_weights(snap: str) -> Dict[str, torch.Tensor]:
    """The snapshot's tensors (`weights_file`), on the CPU."""
    path = weights_file(snap)
    if path is None:
        raise FileNotFoundError(f"{snap}: none of {', '.join(WEIGHT_FILES)}")
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def hubert_state_dict(raw: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`raw` (a HuBERT checkpoint's tensors) under `models/hubert.py`'s names
    in float32 (module docstring)."""
    state = {}
    for key, value in raw.items():
        key = key.removeprefix("hubert.")
        if key.startswith("lm_head.") or key == "masked_spec_embed":
            continue
        key = key.replace("parametrizations.weight.original0", "weight_g")
        key = key.replace("parametrizations.weight.original1", "weight_v")
        state[key] = value.float() if value.is_floating_point() else value
    if f"{POS_CONV}.weight_g" in state:
        wn = {k: state.pop(k).numpy() for k in (f"{POS_CONV}.weight_g", f"{POS_CONV}.weight_v")}
        state[f"{POS_CONV}.weight"] = torch.from_numpy(fold_weight_norm(wn, POS_CONV, dim=2))
    return state
