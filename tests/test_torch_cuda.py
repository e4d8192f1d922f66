"""The CUDA fused-field kernels (forward and backward) on the card: they
launch, count, mask the ragged tile and agree with their plain versions,
and a fused train step on the card agrees with the CPU. Imports no jax, so
it runs on a machine with the card and no JAX:

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
        cond = model.cal_cond_feat(torch.randn(5, 1, 204, generator=torch.Generator().manual_seed(4)).to(dev))
        ab, cb = ff.bias_rows(cond, model.get_individual_code(1), w)
    return dev, w, ab, cb


def _points(n, dev, seed=0):
    rs = np.random.RandomState(seed)
    xyz = torch.from_numpy(rs.uniform(-1, 1, (n, 3)).astype(np.float32)).to(dev)
    d = torch.from_numpy(rs.randn(n, 3).astype(np.float32)).to(dev)
    return xyz, d / d.norm(dim=-1, keepdim=True)


# the forward's ragged edges: a consumer tile (FWD_TILE points) and a
# persistent block step (FWD_STEP) +- 1, and more steps than an H100 has
# SMs (132), so that every persistent block loops
EDGES = [ff.FWD_TILE - 1, ff.FWD_TILE + 1, ff.FWD_STEP - 1, ff.FWD_STEP + 1, 2 * 132 * ff.FWD_STEP + 77]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 64, 300, 65537] + EDGES)
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
    """A point's result must not depend on which tile it lands in: the tail
    from FWD_TILE + 3 on crosses tile and block-step boundaries at other
    points than the whole set does."""
    dev, w, ab, cb = cuda_setup
    n, start = 2 * ff.FWD_STEP + ff.FWD_TILE + 9, ff.FWD_TILE + 3
    xyz, d = _points(n, dev, seed=1)
    with torch.no_grad():
        full = ff.fused_field(xyz, d, ab, cb, w)
        tail = ff.fused_field(xyz[start:].contiguous(), d[start:].contiguous(), ab, cb, w)
    for a, b in zip(full, tail):
        torch.testing.assert_close(a[start:], b, rtol=0, atol=0)


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


# ---- the backward kernel -------------------------------------------------

def _out_grads(n, dev, seed=5):
    g = torch.Generator().manual_seed(seed)
    return tuple((torch.randn(s, generator=g) * 1e-2).to(dev) for s in ((n,), (n, 3), (n, 3)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 64, 300, 65537])
def test_backward_kernel_matches_plain(cuda_setup, n):
    """All 14 blocks vs the plain version: over the clean points (forward
    outputs within chip_smoke.FWD_CLEAN of the plain forward) within
    BWD_CLEAN at n = 65,537 and cosine >= 0.9995, max |d| <= 0.05 of the
    largest entry below it (measured over six seeds: 0.99992691 and 0.0166
    at n = 300, where one point's flipped gradient rounding carries an
    entry); over all points cosine >= 0.95 (one point whose forward rounds
    differently moves its whole gradient: measured 0.973 at n = 1), and
    BWD_ALL at n = 65,537."""
    import chip_smoke

    dev, w, ab, cb = cuda_setup
    xyz, d = _points(n, dev, seed=7)
    gs, gr, ga = _out_grads(n, dev)
    before = ff.fused_field_backward.launches
    with torch.no_grad():
        k = ff.fused_field_backward(xyz, d, ab, cb, w, gs, gr, ga)
        torch.cuda.synchronize()
        assert ff.fused_field_backward.launches == before + 1
        for (name, shape, _), a in zip(ff.GRAD_BLOCKS, k):
            assert a.shape == shape and torch.isfinite(a).all(), name
        stats, _ = chip_smoke.backward_vs_plain(xyz, d, ab, cb, w, gs, gr, ga)
    if n == 65537:
        assert not chip_smoke.bwd_failures(stats), chip_smoke.bwd_failures(stats)
        return
    for name, cos, _, rel in stats["clean"]:
        assert cos >= 0.9995 and rel <= 0.05, (name, cos, rel)
    for name, cos, _, _ in stats["all"]:
        assert cos >= 0.95, (name, cos)


@pytest.mark.cuda
def test_backward_split_sums_and_determinism(cuda_setup):
    """A point's contribution does not depend on its tile: the gradients of
    200 points equal those of points 0..129 plus those of 130..199 up to
    float32 summation order (1e-5 of each block's largest entry); and two
    launches give bit-identical gradients."""
    dev, w, ab, cb = cuda_setup
    xyz, d = _points(200, dev, seed=8)
    gs, gr, ga = _out_grads(200, dev, seed=9)
    with torch.no_grad():
        full = ff.fused_field_backward(xyz, d, ab, cb, w, gs, gr, ga)
        again = ff.fused_field_backward(xyz, d, ab, cb, w, gs, gr, ga)
        parts = [ff.fused_field_backward(*(t[s].contiguous() for t in (xyz, d)), ab, cb, w,
                                         *(t[s].contiguous() for t in (gs, gr, ga)))
                 for s in (slice(0, 130), slice(130, 200))]
    for (name, _, _), f, f2, a, b in zip(ff.GRAD_BLOCKS, full, again, *parts):
        assert torch.equal(f, f2), name
        torch.testing.assert_close(a + b, f, rtol=0, atol=1e-5 * max(f.abs().max().item(), 1e-30))


@pytest.mark.cuda
def test_backward_wrapper_refuses_what_the_kernel_does_not_take(cuda_setup):
    dev, w, ab, cb = cuda_setup
    xyz, d = _points(32, dev)
    gs, gr, ga = _out_grads(32, dev)
    with pytest.raises(ValueError, match="contiguous"):
        ff.fused_field_backward(xyz, d, ab, cb, w, gs, gr.t().contiguous().t(), ga)
    with pytest.raises(ValueError, match="float32"):
        ff.fused_field_backward(xyz, d, ab, cb, w, gs.double(), gr, ga)
    with pytest.raises(ValueError, match="amb_dim"):
        ff.fused_field_backward(xyz, d, ab, cb, w, gs, gr, ga[:, :2].contiguous(), amb_dim=2)
    with pytest.raises(ValueError, match="cpu"):
        ff.fused_field_backward(xyz, d, ab, cb, w, gs.cpu(), gr, ga)


@pytest.mark.cuda
def test_fused_train_step_on_card_matches_cpu(cuda_setup):
    """One make_train_step with use_fused_field on the card (both kernels)
    vs the same step on the CPU (plain versions): same params, batch,
    occupancy and noise at 64^2 x 8 samples. Losses rtol 1e-3, the whole
    gradient's cosine >= 0.99 (bf16 chains, float32 sums in other orders:
    tests/test_torch_train.py's fused-path bounds); one forward and one
    backward launch."""
    from genefaceplusplus_tpu_torch.models.renderer import RenderOptions
    from genefaceplusplus_tpu_torch.training import radnerf_task as rt
    from genefaceplusplus_tpu_torch.training.schedulers import make_radnerf_optimizer
    from genefaceplusplus_tpu_torch.utils.rays import pixel_rays

    dev = cuda_setup[0]
    cfg = RADNeRFConfig.from_hparams({**MAY_LM3D_RADNERF, "grid_size": 32})
    init = RADNeRF(cfg, generator=torch.Generator().manual_seed(6)).state_dict()
    g = torch.Generator().manual_seed(7)
    R = 4096
    pose = torch.eye(4)
    pose[2, 3] = -2.5  # looking down +z at the head-sized occupancy
    inds = torch.randint(0, 64 * 64, (1, R), generator=g)
    ro, rd = pixel_rays(pose[None], (128.0, 128.0, 32.0, 32.0), 64, 64, inds)
    batch = {"rays_o": ro[0], "rays_d": rd[0], "cond": torch.randn(5, 1, 204, generator=g),
             "gt_rgb": torch.rand(R, 3, generator=g), "bg_color": torch.rand(R, 3, generator=g),
             "face_mask": torch.rand(R, generator=g) > 0.5, "idx": torch.tensor(3),
             "eye_area_percent": torch.full((1, 1), 0.25)}
    lin = torch.linspace(-1, 1, 32)
    xx, yy, zz = torch.meshgrid(lin, lin, lin, indexing="ij")
    occ = (xx ** 2 + (2.2 * yy) ** 2 + (1.4 * zz) ** 2) < 0.3
    noise = torch.rand(R, generator=g)
    step = rt.make_train_step(RenderOptions(num_samples=8, perturb=True), use_fused_field=True)
    out = {}
    for device in ("cpu", dev):
        model = RADNeRF(cfg).to(device)
        model.load_state_dict(init)
        state = rt.create_train_state(model, make_radnerf_optimizer(), torch.Generator(device=device))
        state.global_step = 1000
        fwd, bwd = ff.fused_field.launches, ff.fused_field_backward.launches
        _, metrics = step(state, {k: v.to(device) for k, v in batch.items()}, occ.to(device), noise.to(device))
        launched = (ff.fused_field.launches - fwd, ff.fused_field_backward.launches - bwd)
        grads = torch.cat([p.grad.detach().double().cpu().flatten() for p in model.parameters()])
        out[str(device)] = ({k: float(v) for k, v in metrics.items()}, grads, launched)
    (m_c, g_c, l_c), (m_g, g_g, l_g) = out["cpu"], out[str(dev)]
    assert l_c == (0, 0) and l_g == (1, 1)
    assert g_c.norm() > 0  # the rays hit the occupied region
    for k in ("mse_loss", "weights_entropy_loss", "ambient_loss", "total_loss"):
        np.testing.assert_allclose(m_g[k], m_c[k], rtol=1e-3, err_msg=k)
    assert (g_c @ g_g).item() / (g_c.norm() * g_g.norm()).item() >= 0.99


# ---- the backward's two kernels: the tile chain and the weight gradients --

@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, ff.WGRAD_CHUNK - 1, ff.WGRAD_CHUNK + 1, 25 * ff.WGRAD_CHUNK + 77,
                               140 * ff.WGRAD_CHUNK + 77])
def test_wgrad_kernel_matches_plain(cuda_setup, n):
    """The weight-gradient kernel vs fused_field_wgrad_plain on the same
    seeded operands (uniform in [-0.25, 1)): float32 sums of the same bf16
    products, in other orders and, in the kernel, through the tensor cores'
    float32 accumulation. Within chip_smoke.WGRAD_MAX_REL (5e-5) of each
    block's largest entry (printed; on an H100 1.28e-5 to 1.43e-5 at every
    n > 1: a rounding of the tensor cores' sums, not one that grows with
    the number of points), at one point, on both sides of a chunk
    boundary, and with more chunks than an H100 has SMs (132), so that
    every item's grid runs more than one wave. Every launch counted; two
    launches bit-identical."""
    import chip_smoke

    dev = cuda_setup[0]
    rs = np.random.RandomState(n % 1000)
    ops = {name: torch.from_numpy(rs.uniform(-0.25, 1.0, (n, rows)).astype(np.float32)).to(dev).bfloat16()
           for name, rows in ff.WGRAD_OPERANDS}
    buf = ff.pack_operands(ops)
    before = ff.fused_field_wgrad.launches
    with torch.no_grad():
        k = ff.fused_field_wgrad(buf, n)
        k2 = ff.fused_field_wgrad(buf, n)
        p = ff.fused_field_wgrad_plain(ops)
    torch.cuda.synchronize()
    assert ff.fused_field_wgrad.launches == before + 2
    worst = 0.0
    for (name, shape, _), a, a2, b in zip(ff.GRAD_BLOCKS, k, k2, p):
        assert a.shape == shape and torch.equal(a, a2), name
        worst = max(worst, (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30))
        torch.testing.assert_close(a, b, rtol=0, atol=chip_smoke.WGRAD_MAX_REL * b.abs().max().item(), msg=name)
    print(f"[wgrad] n = {n}: max |kernel - plain| / max |plain| over the blocks {worst:.3e}")


GRADIENT_OPERANDS = {"gc1a", "gc1b", "gaproj", "gproj", "gs1", "ga1", "ga2", "gs2", "gsig", "grgb", "gamb"}
RELU_OPERANDS = ("a1", "a2", "s1", "s2", "c1")  # the hidden layers whose ReLU masks gate the gradients
# measured on an H100 at n = 300 and 65,537: the masks agree on 264 of 264
# and 57,208 of 57,214 clean points, where every operand is within 3.9e-3
# (one bf16 step of an entry near its largest) of its largest entry
CHAIN_MASKS_AGREE = 0.99  # least share of clean points whose five ReLU masks agree
CHAIN_MAX_REL = 1e-2  # on those points, any operand vs plain, of its largest entry


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 300, 65537])
def test_chain_operands_match_plain(cuda_setup, n):
    """The chain's operands vs fused_field_bwd_operands_plain. Both are
    bf16 roundings of float32 values that the card sums in other orders
    (tensor-core tiles, the Fourier phase's FMA chain vs a float32 matmul),
    so a rounding can flip, and a flipped ReLU mask moves a point's
    gradients by whole entries. On the points whose forward is clean
    (chip_smoke.FWD_CLEAN) each operand differs in at most 3 % of its
    entries. On the clean points whose ReLU masks (a1, a2, s1, s2, c1) are
    the same in both, at least CHAIN_MASKS_AGREE of them, every operand,
    gradients included, is within CHAIN_MAX_REL of its largest entry: a
    few bf16 steps, so an operand written to the wrong place or corrupted
    on those points fails. bf16(xyz) is equal everywhere, and the buffer
    holds zeros past n."""
    import chip_smoke

    dev, w, ab, cb = cuda_setup
    xyz, d = _points(n, dev, seed=7)
    gs, gr, ga = _out_grads(n, dev)
    before = ff.fused_field_bwd_chain.launches
    with torch.no_grad():
        buf = ff.fused_field_bwd_chain(xyz, d, ab, cb, w, gs, gr, ga)
        torch.cuda.synchronize()
        assert ff.fused_field_bwd_chain.launches == before + 1
        k = ff.unpack_operands(buf, ff.operand_points(n))
        p = ff.fused_field_bwd_operands_plain(xyz, d, ab, cb, w, gs, gr, ga)
        fk, fp = ff.fused_field(xyz, d, ab, cb, w), ff.fused_field_plain(xyz, d, ab, cb, w)
    moved = torch.stack([(fk[0].log() - fp[0].log()).abs(), (fk[1] - fp[1]).abs().amax(-1),
                         (fk[2] - fp[2]).abs().amax(-1)], -1).amax(-1)
    clean = moved <= chip_smoke.FWD_CLEAN
    agree = clean.clone()
    for name in RELU_OPERANDS:
        agree &= ((k[name][:n] > 0) == (p[name] > 0)).all(-1)
    n_clean, n_agree = int(clean.sum()), int(agree.sum())
    worst, share = {}, {}
    for name, _ in ff.WGRAD_OPERANDS:
        a, b = k[name][:n].float(), p[name].float()
        assert not k[name][n:].float().any(), name
        assert torch.isfinite(a).all(), name
        diff = (a != b)[clean]
        share[name] = diff.float().mean().item() if n_clean else 0.0
        assert share[name] <= 0.03 or diff.sum().item() <= 2, (name, share[name])
        if n_agree:
            worst[name] = (a - b).abs()[agree].max().item() / max(b.abs().max().item(), 1e-30)
    print(f"[chain] n = {n}: {n_clean} clean points, {n_agree} of them with the same ReLU masks; "
          f"max |chain - plain| / max |plain| there: "
          + ", ".join(f"{k_}={v:.2e}" for k_, v in worst.items())
          + "; share of clean entries that differ: " + ", ".join(f"{k_}={v:.4f}" for k_, v in share.items()))
    assert n_agree >= CHAIN_MASKS_AGREE * n_clean, (n_agree, n_clean)
    for name, rel in worst.items():
        assert rel <= CHAIN_MAX_REL, (name, rel)
    assert torch.equal(k["xyzb"][:n].float(), p["xyzb"])
