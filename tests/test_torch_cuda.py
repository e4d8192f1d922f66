"""The CUDA fused-field kernel on the card: it launches, counts, masks the
ragged tile and agrees with its plain version. Imports no jax, so it runs
on a machine with the card and no JAX:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Elsewhere each test skips (no CUDA device). Bounds are chip_smoke.py's:
the kernel and the plain version are two bf16 chains that differ only in
float32 summation order."""

import numpy as np
import pytest
import torch

from genefaceplusplus_tpu_torch.models.radnerf import MAY_LM3D_RADNERF, RADNeRF, RADNeRFConfig
from genefaceplusplus_tpu_torch.ops import fused_field as ff

MAX = {"log_sigma": 0.3, "rgb": 0.08, "amb": 0.02}
MEAN = {"log_sigma": 5e-4, "rgb": 1e-4, "amb": 1e-5}


@pytest.fixture(scope="module")
def cuda_setup():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = RADNeRFConfig.from_hparams(MAY_LM3D_RADNERF)
    model = RADNeRF(cfg, generator=torch.Generator().manual_seed(3)).to(dev).eval()
    w = ff.weights_from_params(model)
    with torch.no_grad():
        cond = model.cal_cond_feat(torch.randn(5, 1, 204, device=dev))
        ab, cb = ff.bias_rows(cond, model.get_individual_code(1), w)
    return dev, w, ab, cb


def _points(n, dev, seed=0):
    rs = np.random.RandomState(seed)
    xyz = torch.from_numpy(rs.uniform(-1, 1, (n, 3)).astype(np.float32)).to(dev)
    d = torch.from_numpy(rs.randn(n, 3).astype(np.float32)).to(dev)
    return xyz, d / d.norm(dim=-1, keepdim=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 64, 300, 65537])
def test_kernel_matches_plain(cuda_setup, n):
    dev, w, ab, cb = cuda_setup
    xyz, d = _points(n, dev)
    before = ff.fused_field.launches
    with torch.no_grad():
        k = ff.fused_field(xyz, d, ab, cb, w)
        p = ff.fused_field_plain(xyz, d, ab, cb, w)
    torch.cuda.synchronize()
    assert ff.fused_field.launches == before + 1
    for name, a, b in (("log_sigma", k[0].log(), p[0].log()), ("rgb", k[1], p[1]), ("amb", k[2], p[2])):
        assert torch.isfinite(a).all()
        e = (a - b).abs()
        assert e.max().item() <= MAX[name], name
        assert e.mean().item() <= MEAN[name] or n < 64, name


@pytest.mark.cuda
def test_ragged_tail_is_independent_of_the_tile(cuda_setup):
    """A point's result must not depend on which tile it lands in."""
    dev, w, ab, cb = cuda_setup
    xyz, d = _points(200, dev, seed=1)
    with torch.no_grad():
        full = ff.fused_field(xyz, d, ab, cb, w)
        tail = ff.fused_field(xyz[130:].contiguous(), d[130:].contiguous(), ab, cb, w)
    for a, b in zip(full, tail):
        torch.testing.assert_close(a[130:], b, rtol=0, atol=0)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_setup):
    dev, w, ab, cb = cuda_setup
    xyz, d = _points(32, dev)
    with pytest.raises(ValueError, match="contiguous"):
        ff.fused_field(xyz.t().contiguous().t(), d, ab, cb, w)
    with pytest.raises(ValueError, match="float32"):
        ff.fused_field(xyz.double(), d, ab, cb, w)
    with pytest.raises(ValueError, match="amb_dim"):
        ff.fused_field(xyz, d, ab, cb, w, amb_dim=2)
    with pytest.raises(ValueError, match="cpu"):
        ff.fused_field(xyz, d.cpu(), ab, cb, w)


@pytest.mark.cuda
def test_serve_on_card_matches_cpu(cuda_setup):
    """The served path on the card (kernel field) vs on the CPU (plain
    field), same weights and request at 64^2: PSNR >= 40 dB per frame, and
    one kernel launch per frame."""
    from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset, synthetic
    from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer

    dev = cuda_setup[0]
    cfg = RADNeRFConfig.from_hparams(MAY_LM3D_RADNERF)
    params = RADNeRF(cfg, generator=torch.Generator().manual_seed(4)).state_dict()
    ds = RADNeRFDataset(synthetic(num_frames=12, H=64, W=64), smo_win_size=cfg.smo_win_size)
    g = np.linspace(-1, 1, cfg.grid_size)
    xx, yy, zz = np.meshgrid(g, g, g, indexing="ij")
    occ = (xx ** 2 + (2.2 * yy) ** 2 + (1.4 * zz) ** 2) < 0.16
    batch = None
    frames = {}
    for d in ("cpu", dev):
        infer = GeneFaceInfer(cfg, params, ds, occ, device=d)
        batch = batch or infer.prepare_gt_batch(range(6))
        before = ff.fused_field.launches
        frames[str(d)] = list(infer.forward_secc2video(batch, {"frames_per_dispatch": 4}))
        launched = ff.fused_field.launches - before
    assert launched == 6
    for a, b in zip(frames["cpu"], frames[str(dev)]):
        mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
        assert mse == 0 or 10 * np.log10(255.0 ** 2 / mse) >= 40.0
