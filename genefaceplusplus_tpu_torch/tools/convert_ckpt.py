"""Convert a released GeneFace++ checkpoint into a work dir, without flax
(the port's copy of `scripts/convert_ckpt.py`).

The reference saves `{epoch, global_step, optimizer_states, state_dict:
{model: ...}}` with torch's legacy serialization. This writes the work dir
that the JAX package's `convert_file` writes from it: a flax msgpack
checkpoint `{'state_dict': <flax variables>, 'global_step': N}` and a
`config.yaml` merged from `--config` over the source dir's `config.yaml`.
Both packages load it:

    python -m genefaceplusplus_tpu_torch.tools.convert_ckpt \\
        --input checkpoints/audio2motion_vae/model_ckpt_steps_400000.ckpt \\
        --type a2m --out checkpoints/audio2motion_vae_converted
    python -m genefaceplusplus_tpu_torch.inference.cli \\
        --a2m_ckpt checkpoints/audio2motion_vae_converted --torso_ckpt T ...

`--type head` (the grid-encoder head) and `--type disc` (the EG3D
discriminator) raise until the port has those modules.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

from genefaceplusplus_tpu_torch.config import load_config
from genefaceplusplus_tpu_torch.config import yaml_io
from genefaceplusplus_tpu_torch.utils import convert_torch_ckpt as cvt
from genefaceplusplus_tpu_torch.utils.ckpt import save_flax_checkpoint

_WAITING = {
    "head": "the grid-encoder head (convert_radnerf_grid) waits for the grid encoders (ROADMAP queue A, "
            "reference-parity paths: ops/grid_encoder.py)",
    "disc": "the EG3D discriminator (convert_eg3d_disc) waits for the discriminators (ROADMAP queue A, "
            "reference-parity paths: models/eg3d_discriminator.py)",
}


def convert_file(input_path: str, kind: str, out_dir: str, config: Optional[dict] = None) -> str:
    """Convert one reference checkpoint into the work dir `out_dir`; returns
    the checkpoint's path."""
    if kind in _WAITING:
        raise NotImplementedError(f"--type {kind}: {_WAITING[kind]}")
    if kind != "a2m":
        raise ValueError(f"unknown --type {kind!r} (a2m | head | disc)")
    state, step = cvt.load_torch_state_dict(input_path)
    cfg = dict(config or {})
    src_cfg = os.path.join(os.path.dirname(input_path), "config.yaml")
    if os.path.exists(src_cfg):
        cfg = {**(yaml_io.load(src_cfg) or {}), **cfg}
    path = save_flax_checkpoint(out_dir, step, {"state_dict": cvt.convert_pitch_contour_vae(state)}, config=cfg,
                                num_ckpt_keep=100)
    print(f"| converted {len(state)} torch tensors ({kind}) @ step {step} -> {path}")
    return path


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--input", required=True, help="the reference's torch .ckpt file")
    p.add_argument("--type", required=True, choices=["a2m", "head", "disc"])
    p.add_argument("--out", required=True, help="the work dir to write")
    p.add_argument("--config", default="", help="a YAML config whose keys override the source dir's config.yaml")
    args = p.parse_args(argv)
    return convert_file(args.input, args.type, args.out, config=load_config(args.config) if args.config else None)


if __name__ == "__main__":
    main()
