"""chip_smoke.py's train_grid gradient witness on the CPU: `grad_witness`
holds each entry of a device's float32 gradient against the same sums in
float64, within GRID_GRAD_ABS of the entry's terms' absolute sum plus
GRID_GRAD_REL of the tensor's largest entry. It passes two float32 orders
of the same sums whose terms cancel as a grid head's MLP gradients do on
the card (absolute sums 23-67x the largest entry; 53x there), with the
operands moved by float32 differences upstream, and fails a gradient moved
by 1e-3 of its scale in one entry. `Float64Sums` redoes a grid head step's Linear and
grid-table gradient sums in float64: they equal the step's float32
gradients to 1e-5 of each tensor's largest entry; its sums for the Fourier
projections' B and the SR's noise strengths (the SR + FM step's witness)
equal autograd's gradients to 1e-6 of their terms' absolute sums, and so do
its sums for a head's individual code, on the row that the step read."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF, RADNeRFConfig
from genefaceplusplus_tpu_torch.ops.grid_encoder import GridEncodeFunction

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _sums(n=3000, k=48, m=40, offset=1.0, seed=0):
    """A Linear weight gradient g = delta^T a in float64, the absolute sums
    |delta|^T |a|, and two float32 versions: the CPU's, and another order of
    the same sums on operands moved by 1e-6 (a card's float32 forward)."""
    rs = np.random.RandomState(seed)
    a = torch.from_numpy((rs.rand(n, k) + offset).astype(np.float32))
    d = torch.from_numpy((rs.randn(n, m) * 1e-3).astype(np.float32))
    d -= d.mean(0, keepdim=True)  # signed terms around a common mean: they cancel
    g64 = d.double().t() @ a.double()
    spread = d.double().abs().t() @ a.double().abs()
    cpu = d.t() @ a
    a2 = a * (1 + 1e-6 * torch.from_numpy(rs.randn(n, k).astype(np.float32)))
    d2 = d * (1 + 1e-6 * torch.from_numpy(rs.randn(n, m).astype(np.float32)))
    perm = torch.from_numpy(rs.permutation(n))
    card = torch.zeros_like(cpu)
    for i in range(0, n, 1024):  # chunks of permuted rows, summed in turn
        card += d2[perm[i:i + 1024]].t() @ a2[perm[i:i + 1024]]
    return cpu, card, g64, spread


@pytest.mark.parametrize("offset", [0.0, 0.5, 1.0])
def test_witness_passes_two_orders_and_fails_a_perturbation(offset):
    cpu, card, g64, spread = _sums(offset=offset)
    old, err_card, err_cpu, ratio, ok = chip_smoke.grad_witness(card, cpu, g64, spread)
    assert ok, (old, err_card, err_cpu, ratio)
    wrong = card.clone()
    i = int(g64.abs().argmax())
    wrong.view(-1)[i] += 1e-3 * float(g64.abs().max())
    assert not chip_smoke.grad_witness(wrong, cpu, g64, spread)[4], ratio


def test_float64_sums_of_a_grid_head_step():
    cfg = RADNeRFConfig(grid_type="tiledgrid", grid_size=16, desired_resolution=64, log2_hashmap_size=10,
                        individual_embedding_num=4, smo_win_size=3, hidden_dim_sigma=32, hidden_dim_ambient=32,
                        hidden_dim_color=32, geo_feat_dim=16)
    model = RADNeRF(cfg, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    xyz = torch.rand(4000, 3, generator=g) * 1.6 - 0.8
    dirs = torch.nn.functional.normalize(torch.randn(4000, 3, generator=g), dim=-1)
    cond = torch.randn(3, 1, 204, generator=g)
    backward = GridEncodeFunction.backward
    with chip_smoke.Float64Sums(model) as sums:
        cf = model.cal_cond_feat(cond)
        sigma, rgb, amb = model.field(xyz, dirs, cf, model.get_individual_code(1))
        w = torch.randn(4000, 7, generator=g)
        (torch.cat([sigma[:, None], rgb, amb], -1) * w).sum().backward()
    assert GridEncodeFunction.backward is backward  # restored
    named = dict(model.named_parameters())
    tables = {n for n in sums.refs if n.endswith("embeddings")}
    assert {"position_embedder.embeddings", "ambient_embedder.embeddings"} <= tables
    assert any(n.startswith("color_net.dense") for n in sums.refs)
    assert any(n.startswith("cond_prenet.dense") and n.endswith("bias") for n in sums.refs)
    for name, ref in sums.refs.items():
        grad = named[name].grad.double()
        scale = float(ref.abs().max())
        err = float((grad - ref).abs().max())
        assert err <= 1e-5 * scale + 1e-5 * float(sums.spread[name].abs().max()) * 1e-2, (name, err / scale)


@pytest.mark.parametrize("offset", [(0, 0), (2, 3)])
def test_float64_sums_of_fourier_projections_and_noise_strengths(offset):
    """The SR + FM step's extra sums: B of both Fourier encoders (x @ B^T)
    and each SR layer's noise strength (the conv output's gradient times
    the const noise, on a crop at `offset` too)."""
    from genefaceplusplus_tpu_torch.models.superresolution import Superresolution

    cfg = RADNeRFConfig(individual_embedding_num=4, smo_win_size=3, hidden_dim_sigma=32, hidden_dim_ambient=32,
                        hidden_dim_color=32, geo_feat_dim=16)
    model = torch.nn.ModuleDict({"head": RADNeRF(cfg, generator=torch.Generator().manual_seed(0)),
                                 "sr": Superresolution(3, 16, generator=torch.Generator().manual_seed(2))})
    with torch.no_grad():
        for i, (name, p) in enumerate(model["sr"].named_parameters()):
            if name.endswith("noise_strength"):
                p.fill_(0.1 * (i % 3 + 1))
    g = torch.Generator().manual_seed(1)
    xyz = torch.rand(2000, 3, generator=g) * 1.6 - 0.8
    dirs = torch.nn.functional.normalize(torch.randn(2000, 3, generator=g), dim=-1)
    cond = torch.randn(3, 1, 204, generator=g)
    rgb_in = torch.rand(1, 8, 8, 3, generator=g)
    with chip_smoke.Float64Sums(model) as sums:
        head = model["head"]
        sigma, rgb, amb = head.field(xyz, dirs, head.cal_cond_feat(cond), head.get_individual_code(1))
        sr = model["sr"](rgb_in, noise_offset=offset)
        w, w_sr = torch.randn(2000, 7, generator=g), torch.randn(sr.shape, generator=g)
        ((torch.cat([sigma[:, None], rgb, amb], -1) * w).sum() + (sr * w_sr).sum()).backward()
    named = dict(model.named_parameters())
    extra = {n for n in sums.refs if n.endswith(("_embedder.B", "noise_strength"))}
    assert extra == {"head.position_embedder.B", "head.ambient_embedder.B", "sr.block0.conv0.noise_strength",
                     "sr.block0.conv1.noise_strength", "sr.block1.conv0.noise_strength",
                     "sr.block1.conv1.noise_strength"}
    for name in extra:
        ref, grad = sums.refs[name], named[name].grad.double()
        assert ref.shape == grad.shape, name
        err = float((grad - ref).abs().max())
        assert err <= 1e-6 * float(sums.spread[name].abs().max()), (name, err, float(ref.abs().max()))
        assert bool((sums.spread[name] >= ref.abs()).all()), name
    from genefaceplusplus_tpu_torch.models import superresolution
    from genefaceplusplus_tpu_torch.ops import fourier_encoder
    assert superresolution.modulated_conv2d is sums.modulated and fourier_encoder.project is sums.project  # restored


@pytest.mark.parametrize("index", [2, -1])
def test_float64_sums_of_individual_codes(index):
    """The individual code's gradient, a sum over the points of the color
    net's input gradient, redone in float64 on the row JAX's gather reads
    (a negative index wraps), under a ModuleDict's prefix; the head's
    get_individual_code is its class's again afterwards."""
    cfg = RADNeRFConfig(individual_embedding_num=5, smo_win_size=3, hidden_dim_sigma=32, hidden_dim_ambient=32,
                        hidden_dim_color=32, geo_feat_dim=16)
    model = torch.nn.ModuleDict({"head": RADNeRF(cfg, generator=torch.Generator().manual_seed(0))})
    head = model["head"]
    g = torch.Generator().manual_seed(3)
    xyz = torch.rand(3000, 3, generator=g) * 1.6 - 0.8
    dirs = torch.nn.functional.normalize(torch.randn(3000, 3, generator=g), dim=-1)
    cond = torch.randn(3, 1, 204, generator=g)
    with chip_smoke.Float64Sums(model) as sums:
        sigma, rgb, amb = head.field(xyz, dirs, head.cal_cond_feat(cond), head.get_individual_code(index))
        w = torch.randn(3000, 7, generator=g)
        (torch.cat([sigma[:, None], rgb, amb], -1) * w).sum().backward()
    assert "get_individual_code" not in vars(head)  # restored
    ref, spread = sums.refs["head.individual_embeddings"], sums.spread["head.individual_embeddings"]
    grad = head.individual_embeddings.grad.double()
    row = index % cfg.individual_embedding_num
    assert ref.shape == grad.shape and float(grad[row].abs().max()) > 0
    assert bool((ref[torch.arange(len(ref)) != row] == 0).all())
    err = float((grad - ref).abs().max())
    assert err <= 1e-6 * float(spread.abs().max()), (err, float(ref.abs().max()))
    assert bool((spread >= ref.abs()).all())
