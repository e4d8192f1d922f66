"""Convert a torchvision vgg19 or a vgg_face_dag .pth into the flax msgpack
weights that `training/perceptual.py` reads, without flax (the port's copy
of `scripts/convert_vgg.py`):

    python -m genefaceplusplus_tpu_torch.tools.convert_vgg vgg19.pth vgg19_flax.msgpack
    python -m genefaceplusplus_tpu_torch.tools.convert_vgg vgg_face_dag.pth vggface_flax.msgpack --face

Then `PerceptualLoss(arch="vgg19", weights_path="vgg19_flax.msgpack",
vggface_weights_path="vggface_flax.msgpack")`. The file is unpickled with
`weights_only=True` (a state dict of tensors).
"""

from __future__ import annotations

import sys

import torch

from genefaceplusplus_tpu_torch.utils import msgpack
from genefaceplusplus_tpu_torch.utils.convert_torch_ckpt import convert_vgg19, convert_vggface


def convert_vgg(src: str, dst: str, face: bool = False) -> str:
    """Write the flax variables of the VGG19 (or, with `face`, VGGFace)
    tower from the torch state dict at `src` to `dst`."""
    state = torch.load(src, map_location="cpu", weights_only=True)
    state = state.get("state_dict", state)
    variables = (convert_vggface if face else convert_vgg19)(
        {k: v.numpy() for k, v in state.items() if isinstance(v, torch.Tensor)})
    with open(dst, "wb") as f:
        f.write(msgpack.packb(variables))
    print(f"wrote {dst}")
    return dst


def main(argv=None) -> str:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        raise SystemExit("usage: python -m genefaceplusplus_tpu_torch.tools.convert_vgg SRC.pth DST.msgpack [--face]")
    return convert_vgg(argv[0], argv[1], face="--face" in argv[2:])


if __name__ == "__main__":
    main()
