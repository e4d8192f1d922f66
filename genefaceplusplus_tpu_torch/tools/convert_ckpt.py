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
    python -m genefaceplusplus_tpu_torch.tools.convert_ckpt \\
        --input checkpoints/motion2video_nerf/may_head/model_ckpt_steps_250000.ckpt \\
        --type head --grid_size 128 --out checkpoints/may_head_converted
    python -m genefaceplusplus_tpu_torch.inference.cli \\
        --a2m_ckpt checkpoints/audio2motion_vae_converted \\
        --head_ckpt checkpoints/may_head_converted ...

`--type head` converts a grid head (the reference's `tiledgrid` or
`hashgrid`): its params, and in `extra_state` the cascade-0 density grid
and occupancy in spatial order; `config.yaml` gets `grid_type` (default
`tiledgrid`) and `grid_size` where the source config has none.
`--type disc` converts the reference's `disc` sub-model (the EG3D dual
discriminator, eg3d_baseline_run2) at the config's `final_resolution`
(default 512) into the payload `{'state_dict': {'disc': {'params':
...}}}`, and writes its mapping depth into `config.yaml` as
`disc_mapping_layers`; the SR task reads it as its frozen discriminator
(`disc_model_dir`):

    python -m genefaceplusplus_tpu_torch.tools.convert_ckpt \\
        --input checkpoints/eg3d_baseline_run2/model_ckpt_steps_<N>.ckpt \\
        --type disc --out checkpoints/eg3d_disc_converted
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

from genefaceplusplus_tpu_torch.config import load_config
from genefaceplusplus_tpu_torch.config import yaml_io
from genefaceplusplus_tpu_torch.utils import convert_torch_ckpt as cvt
from genefaceplusplus_tpu_torch.utils.ckpt import save_flax_checkpoint

def convert_file(input_path: str, kind: str, out_dir: str, grid_size: int = 128,
                 config: Optional[dict] = None) -> str:
    """Convert one reference checkpoint into the work dir `out_dir`; returns
    the checkpoint's path."""
    if kind not in ("a2m", "head", "disc"):
        raise ValueError(f"unknown --type {kind!r} (a2m | head | disc)")
    state, step = cvt.load_torch_state_dict(input_path, sub_model="disc" if kind == "disc" else "model")
    cfg = dict(config or {})
    src_cfg = os.path.join(os.path.dirname(input_path), "config.yaml")
    if os.path.exists(src_cfg):
        cfg = {**(yaml_io.load(src_cfg) or {}), **cfg}
    if kind == "a2m":
        payload = {"state_dict": cvt.convert_pitch_contour_vae(state)}
    elif kind == "disc":
        out = cvt.convert_eg3d_disc(state, img_resolution=int(cfg.get("final_resolution", 512)))
        payload = {"state_dict": {"disc": {"params": out["params"]}}}
        cfg["disc_mapping_layers"] = int(out["n_mapping_layers"])  # the SR task builds this depth
    else:
        out = cvt.convert_radnerf_grid(state, grid_size=grid_size)
        payload = {"state_dict": {"params": out["params"]}, "extra_state": {}}
        rs = out["render_state"]
        if "density_grid" in rs:  # the trainer's working grid: cascade 0, [H, H, H]
            payload["extra_state"]["density_grid"] = rs["density_grid"][0]
        if "occupancy" in rs:
            payload["extra_state"]["occupancy"] = rs["occupancy"]
        cfg.setdefault("grid_type", "tiledgrid")
        cfg.setdefault("grid_size", grid_size)
    path = save_flax_checkpoint(out_dir, step, payload, config=cfg, num_ckpt_keep=100)
    print(f"| converted {len(state)} torch tensors ({kind}) @ step {step} -> {path}")
    return path


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--input", required=True, help="the reference's torch .ckpt file")
    p.add_argument("--type", required=True, choices=["a2m", "head", "disc"])
    p.add_argument("--out", required=True, help="the work dir to write")
    p.add_argument("--grid_size", type=int, default=128, help="the head's density grid size (--type head)")
    p.add_argument("--config", default="", help="a YAML config whose keys override the source dir's config.yaml")
    args = p.parse_args(argv)
    return convert_file(args.input, args.type, args.out, grid_size=args.grid_size,
                        config=load_config(args.config) if args.config else None)


if __name__ == "__main__":
    main()
