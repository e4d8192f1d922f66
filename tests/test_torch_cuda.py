"""The CUDA fused-field kernels (the forward in both modes, the backward's
chain and weight gradients) on the card: they launch, count, mask the
ragged tile and agree with their plain versions, the train mode's
outputs equal the serving mode's,
and a fused train step on the card agrees with the CPU; the full frame
(head + torso + float32 SR) on the card agrees with the CPU, and the
float32 SR, the audio-to-motion model and the SR and torso training steps
do so with cuDNN's TF32 flag on. Imports no jax, so it runs on a machine with the card and no JAX:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Elsewhere each test skips (no CUDA device). Bounds are chip_smoke.py's:
the kernel and the plain version are two bf16 chains that differ only in
float32 summation order. The work-dir tests write JAX-layout work dirs
with the port's own writer and load them on the card and on the CPU."""

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


def _fused_step_card_and_cpu(dev, opts):
    """One make_train_step with use_fused_field and `opts` on the CPU (plain
    versions) and on the card (the kernels), same params, batch, occupancy
    and noise at 64^2 x 8 samples: {device: (metrics, gradient, (forward,
    backward) launches)}."""
    from genefaceplusplus_tpu_torch.training import radnerf_task as rt
    from genefaceplusplus_tpu_torch.training.schedulers import make_radnerf_optimizer
    from genefaceplusplus_tpu_torch.utils.rays import pixel_rays

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
    step = rt.make_train_step(opts, use_fused_field=True)
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
    return out


def _step_card_vs_cpu(out, dev):
    (m_c, g_c, l_c), (m_g, g_g, l_g) = out["cpu"], out[str(dev)]
    assert l_c == (0, 0) and l_g == (1, 1)
    assert g_c.norm() > 0  # the rays hit the occupied region
    for k in ("mse_loss", "weights_entropy_loss", "ambient_loss", "total_loss"):
        np.testing.assert_allclose(m_g[k], m_c[k], rtol=1e-3, err_msg=k)
    assert (g_c @ g_g).item() / (g_c.norm() * g_g.norm()).item() >= 0.99


@pytest.mark.cuda
def test_fused_train_step_on_card_matches_cpu(cuda_setup):
    """One make_train_step with use_fused_field on the card (both kernels)
    vs the same step on the CPU (plain versions): same params, batch,
    occupancy and noise at 64^2 x 8 samples. Losses rtol 1e-3, the whole
    gradient's cosine >= 0.99 (bf16 chains, float32 sums in other orders:
    tests/test_torch_train.py's fused-path bounds); one forward and one
    backward launch."""
    from genefaceplusplus_tpu_torch.models.renderer import RenderOptions

    dev = cuda_setup[0]
    _step_card_vs_cpu(_fused_step_card_and_cpu(dev, RenderOptions(num_samples=8, perturb=True)), dev)


@pytest.mark.cuda
def test_compacted_fused_train_step_on_card_matches_cpu(cuda_setup):
    """The same step with compact_frac 0.5 (B1's train mode, the chain and
    the weight gradients on the compact buffer of M = 16,384 points) on the
    card vs its plain version on the CPU, at the bounds above; and the
    card's compacted step against its full-slot step (the budget covers the
    live samples: losses rtol 1e-3, gradient cosine >= 0.99)."""
    from genefaceplusplus_tpu_torch.models.renderer import RenderOptions

    dev = cuda_setup[0]
    compact = _fused_step_card_and_cpu(dev, RenderOptions(num_samples=8, perturb=True, compact_frac=0.5))
    _step_card_vs_cpu(compact, dev)
    full = _fused_step_card_and_cpu(dev, RenderOptions(num_samples=8, perturb=True))[str(dev)]
    (m_c, g_c, _), (m_f, g_f, _) = compact[str(dev)], full
    np.testing.assert_allclose(m_c["total_loss"], m_f["total_loss"], rtol=1e-3)
    assert (g_c @ g_f).item() / (g_c.norm() * g_f.norm()).item() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [512, 1024, "crop"])
def test_kernel_on_a_compacted_buffer(cuda_setup, budget):
    """B1 on the compact buffer of live samples (renderer.compact_slots) at
    M = 512, 1,024 and a head crop's budget (288 x 224 rays x 10 samples,
    a live fraction of 0.3 x 1.25): against its plain version on the same
    buffer (the bounds above), and scattered back, equal bit for bit to B1
    on all N slots at the live samples (a point's result does not depend on
    its tile)."""
    from genefaceplusplus_tpu_torch.models.renderer import compact_slots, scatter_slots

    dev, w, ab, cb = cuda_setup
    R, S = (288 * 224, 10) if budget == "crop" else (4096, 8)
    N = R * S
    frac = 0.375 if budget == "crop" else budget / N
    rs = np.random.RandomState(9)
    mask = torch.from_numpy(rs.rand(R, S) < (0.3 if budget == "crop" else 0.9 * frac)).to(dev)
    src, _, dest = compact_slots(mask, frac)
    assert src.shape[0] == (budget if budget != "crop" else ((int(frac * N) + 511) // 512) * 512)
    xyz, d = _points(N, dev, seed=3)
    before = ff.fused_field.launches
    with torch.no_grad():
        k = ff.fused_field(xyz[src], d[src], ab, cb, w)
        p = ff.fused_field_plain(xyz[src], d[src], ab, cb, w)
        full = ff.fused_field(xyz, d, ab, cb, w)
    assert ff.fused_field.launches == before + 2
    for name, a, b in (("log_sigma", k[0].log(), p[0].log()), ("rgb", k[1], p[1]), ("amb", k[2], p[2])):
        assert torch.isfinite(a).all()
        e = (a - b).abs()
        assert e.max().item() <= MAX[name] and e.mean().item() <= MEAN[name], name
    live = mask.reshape(-1)
    for a, b in zip(k, full):
        torch.testing.assert_close(scatter_slots(a, dest, N)[live], b[live], rtol=0, atol=0)


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


RELU_OPERANDS = ("a1", "a2", "s1", "s2", "c1")  # the hidden layers whose ReLU masks gate the gradients
# measured on an H100 at n = 300 and 65,537: the masks agree on 264 of 264
# and 57,208 of 57,214 clean points, where every operand is within 3.9e-3
# (one bf16 step of an entry near its largest) of its largest entry
CHAIN_MASKS_AGREE = 0.99  # least share of clean points whose five ReLU masks agree
CHAIN_MAX_REL = 1e-2  # on those points, any operand vs plain, of its largest entry


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 64, 300, 65537] + EDGES)
def test_train_mode_outputs_equal_serving(cuda_setup, n):
    """B1's train mode gives the serving outputs bit for bit, counts its
    launch in both counters, and writes zeros past n: the activation
    operands' padded rows, the ReLU mask words."""
    dev, w, ab, cb = cuda_setup
    xyz, d = _points(n, dev, seed=3)
    before = (ff.fused_field.launches, ff.fused_field_forward_train.launches)
    with torch.no_grad():
        serve = ff.fused_field(xyz, d, ab, cb, w)
        fwd = ff.fused_field_forward_train(xyz, d, ab, cb, w)
    torch.cuda.synchronize()
    assert (ff.fused_field.launches, ff.fused_field_forward_train.launches) == (before[0] + 2, before[1] + 1)
    for a, b in zip(fwd[:3], serve):
        assert torch.equal(a, b)
    padded = ff.unpack_operands(fwd.ops, ff.operand_points(n))
    for name in ff.OPERAND_WRITERS["fused_field"]:
        assert not padded[name][n:].float().any(), name
    assert not fwd.relu[:, n:].any()
    assert set(fwd.gate.unique().tolist()) <= {0, 1}


def _witness(k, p, k_relu, p_relu, clean, names, n):
    """On the clean points whose five ReLU masks agree (bool [n, 5, 128]),
    the largest |kernel - plain| / max |plain| of each named operand, and
    the share of clean entries that differ (each at most 3 %)."""
    agree = clean & (k_relu == p_relu).flatten(1).all(-1)
    n_clean, n_agree = int(clean.sum()), int(agree.sum())
    worst, share = {}, {}
    for name in names:
        a, b = k[name][:n].float(), p[name].float()
        assert torch.isfinite(a).all(), name
        diff = (a != b)[clean]
        share[name] = diff.float().mean().item() if n_clean else 0.0
        assert share[name] <= 0.03 or diff.sum().item() <= 2, (name, share[name])
        if n_agree:
            worst[name] = (a - b).abs()[agree].max().item() / max(b.abs().max().item(), 1e-30)
    return n_clean, n_agree, worst, share


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 300, 65537])
def test_train_mode_operands_match_plain(cuda_setup, n):
    """B1's train mode's activation operands, ReLU masks and gate vs
    fused_field_train_plain, held as test_chain_operands_match_plain holds
    the buffer: on the clean points at least CHAIN_MASKS_AGREE of them with
    the same five masks, and there every activation operand within
    CHAIN_MAX_REL of its largest entry; bf16(xyz) equal everywhere."""
    import chip_smoke

    dev, w, ab, cb = cuda_setup
    xyz, d = _points(n, dev, seed=7)
    with torch.no_grad():
        fwd = ff.fused_field_forward_train(xyz, d, ab, cb, w)
        plain = ff.fused_field_train_plain(xyz, d, ab, cb, w)
    k = ff.unpack_operands(fwd.ops, n)
    clean = chip_smoke.clean_points(fwd[:3], plain[:3])
    n_clean, n_agree, worst, share = _witness(k, plain.ops, ff.unpack_relu_masks(fwd.relu, n), plain.relu, clean,
                                              ff.OPERAND_WRITERS["fused_field"], n)
    gates = (fwd.gate.bool() == plain.gate).float().mean().item()
    print(f"[train mode] n = {n}: {n_clean} clean points, {n_agree} of them with the same ReLU masks; gates "
          f"equal {gates:.6f}; max |kernel - plain| / max |plain| there: "
          + ", ".join(f"{k_}={v:.2e}" for k_, v in worst.items()))
    assert n_agree >= CHAIN_MASKS_AGREE * n_clean, (n_agree, n_clean)
    for name, rel in worst.items():
        assert rel <= CHAIN_MAX_REL, (name, rel)
    assert torch.equal(k["xyzb"].float(), plain.ops["xyzb"])
    assert gates >= CHAIN_MASKS_AGREE


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 300, 65537])
def test_chain_operands_match_plain(cuda_setup, n):
    """The operand buffer after B1's train mode and the chain vs
    fused_field_bwd_operands_plain (the train mode's plain version, then
    the chain's). Both are bf16 roundings of float32 values that the card
    sums in other orders (tensor-core tiles, the Fourier phase's FMA chain
    vs a float32 matmul), so a rounding can flip, and a flipped ReLU mask
    moves a point's gradients by whole entries. On the points whose
    forward is clean (chip_smoke.FWD_CLEAN) each operand differs in at most
    3 % of its entries. On the clean points whose ReLU masks (a1, a2, s1,
    s2, c1) are the same in both, at least CHAIN_MASKS_AGREE of them, every
    operand, gradients included, is within CHAIN_MAX_REL of its largest
    entry: a few bf16 steps, so an operand written to the wrong place or
    corrupted on those points fails. bf16(xyz) is equal everywhere, the
    buffer holds zeros past n, and a second chain launch on the same
    buffer writes the same values."""
    import chip_smoke

    dev, w, ab, cb = cuda_setup
    xyz, d = _points(n, dev, seed=7)
    gs, gr, ga = _out_grads(n, dev)
    before = ff.fused_field_bwd_chain.launches
    with torch.no_grad():
        fwd = ff.fused_field_forward_train(xyz, d, ab, cb, w)
        buf = ff.fused_field_bwd_chain(xyz, fwd, w, gs, gr, ga).clone()
        again = ff.fused_field_bwd_chain(xyz, fwd, w, gs, gr, ga)
        torch.cuda.synchronize()
        assert ff.fused_field_bwd_chain.launches == before + 2
        assert torch.equal(buf, again)
        k = ff.unpack_operands(buf, ff.operand_points(n))
        p = ff.fused_field_bwd_operands_plain(xyz, d, ab, cb, w, gs, gr, ga)
        fp = ff.fused_field_plain(xyz, d, ab, cb, w)
    for name, _ in ff.WGRAD_OPERANDS:
        assert not k[name][n:].float().any(), name
    clean = chip_smoke.clean_points(fwd[:3], fp)
    k_relu = torch.stack([k[name][:n] > 0 for name in RELU_OPERANDS], 1)
    p_relu = torch.stack([p[name] > 0 for name in RELU_OPERANDS], 1)
    n_clean, n_agree, worst, share = _witness(k, p, k_relu, p_relu, clean, [name for name, _ in ff.WGRAD_OPERANDS], n)
    print(f"[chain] n = {n}: {n_clean} clean points, {n_agree} of them with the same ReLU masks; "
          f"max |chain - plain| / max |plain| there: "
          + ", ".join(f"{k_}={v:.2e}" for k_, v in worst.items())
          + "; share of clean entries that differ: " + ", ".join(f"{k_}={v:.4f}" for k_, v in share.items()))
    assert n_agree >= CHAIN_MASKS_AGREE * n_clean, (n_agree, n_clean)
    for name, rel in worst.items():
        assert rel <= CHAIN_MAX_REL, (name, rel)
    assert torch.equal(k["xyzb"][:n].float(), p["xyzb"])


# the chain's ragged edges, with its tile (OPERAND_TILE, 64 points) and its
# block step of three consumer tiles (192 points): one point, a tile +- 1
# (64 and 65 leave the step's last tile wholly past n), a step - 1, a step
# + 1 (the second step's first tile holds one point, its others lie wholly
# past n), and more than twice as many steps as an H100 has SMs (132), so
# that every persistent block loops
CHAIN_EDGES = [1, 63, 64, 65, 191, 193, 2 * 132 * 192 + 77]


@pytest.mark.cuda
@pytest.mark.parametrize("n", CHAIN_EDGES)
def test_chain_on_plain_inputs_at_ragged_n(cuda_setup, n):
    """The chain alone, on the plain train mode's outputs, ReLU masks and
    gate packed as the train mode writes them, vs fused_field_chain_plain
    on the same: the masks are the same on both sides, and only the
    products' float32 summation order differs (wgmma tiles vs float32
    matmuls), which can flip a bf16 rounding by one step but no mask. So
    every gradient operand is within CHAIN_MAX_REL of its largest entry at
    every point, its rows past n are zero, and the activation half of the
    buffer is left as it was. Each launch counted."""
    dev, w, ab, cb = cuda_setup
    xyz, d = _points(n, dev, seed=13)
    gs, gr, ga = _out_grads(n, dev, seed=14)
    before = ff.fused_field_bwd_chain.launches
    with torch.no_grad():
        plain = ff.fused_field_train_plain(xyz, d, ab, cb, w)
        fwd = ff.FieldTrainOutputs(plain.sigma.contiguous(), plain.rgb.contiguous(), plain.amb.contiguous(),
                                   ff.pack_operands(plain.ops), ff.pack_relu_masks(plain.relu),
                                   plain.gate.to(torch.uint8))
        acts = fwd.ops.clone()
        buf = ff.fused_field_bwd_chain(xyz, fwd, w, gs, gr, ga)
        want = ff.fused_field_chain_plain(xyz, plain, w, gs, gr, ga)
    torch.cuda.synchronize()
    assert ff.fused_field_bwd_chain.launches == before + 1
    k, k0 = ff.unpack_operands(buf, ff.operand_points(n)), ff.unpack_operands(acts, ff.operand_points(n))
    for name in ff.OPERAND_WRITERS["fused_field"]:
        assert torch.equal(k[name], k0[name]), name
    worst = {}
    for name in ff.OPERAND_WRITERS["fused_field_bwd"]:
        assert not k[name][n:].float().any(), name
        a, b = k[name][:n].float(), want[name].float()
        assert torch.isfinite(a).all(), name
        worst[name] = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
    print(f"[chain] n = {n}, plain inputs: max |chain - plain| / max |plain| "
          + ", ".join(f"{k_}={v:.2e}" for k_, v in worst.items()))
    for name, rel in worst.items():
        assert rel <= CHAIN_MAX_REL, (name, rel)


@pytest.mark.cuda
def test_fused_field_train_after_an_in_place_update(cuda_setup):
    """Two steps of fused_field_train on the same weight tensors with an
    in-place update between them (as an optimizer steps them): the second
    backward's gradients equal, bit for bit, those of fused_field_backward
    on freshly packed copies of the updated weights, and agree with the
    plain backward as test_backward_kernel_matches_plain holds it. A chain
    stream packed before the update (stale) fails both."""
    import chip_smoke

    dev, w0, _, _ = cuda_setup
    n = 3000
    xyz, d = _points(n, dev, seed=15)
    gs, gr, ga = _out_grads(n, dev, seed=16)
    g = torch.Generator().manual_seed(17)
    cond = (torch.randn(1, 64, generator=g) * 0.5).to(dev).requires_grad_()
    ind = (torch.randn(4, generator=g) * 0.5).to(dev).requires_grad_()
    w = ff.FieldWeights(*[t.clone().requires_grad_() for t in w0])

    def step():
        s, c, a = ff.fused_field_train(xyz, d, cond, ind, w)
        return torch.autograd.grad((s * gs).sum() + (c * gr).sum() + (a * ga).sum(), [cond, ind, *w])

    first = step()
    with torch.no_grad():
        for t, gt in zip(w, first[2:]):
            t.sub_(gt.to(t.dtype) * (0.5 * t.abs().max() / gt.abs().max().clamp_min(1e-30)).to(t.dtype))
    second = step()
    with torch.no_grad():
        fresh = ff.FieldWeights(*[t.detach().clone() for t in w])
        ab, cb = ff.bias_rows(cond.detach(), ind.detach(), fresh)
        blocks = ff.fused_field_backward(xyz, d, ab, cb, fresh, gs, gr, ga)
        stats, _ = chip_smoke.backward_vs_plain(xyz, d, ab, cb, fresh, gs, gr, ga)
    assert not torch.equal(first[2], second[2])  # the update moved the gradients
    assert torch.equal(second[2], blocks[0])  # pos_B, float32
    assert torch.equal(second[4], blocks[3].to(second[4].dtype))  # amb_w2, bf16 as the weight
    for name, cos, _, rel in stats["clean"]:
        assert cos >= 0.9995 and rel <= 0.05, (name, cos, rel)


@pytest.mark.cuda
def test_fused_field_train_backward_twice_on_card(cuda_setup):
    """fused_field_train on the card: the forward launches the train mode
    once, each backward the chain and the weight gradients once (no
    forward), a second backward on the same graph gives the same
    gradients, and they equal fused_field_backward's from the same inputs."""
    dev, w0, _, _ = cuda_setup
    xyz, d = _points(3000, dev, seed=11)
    gs, gr, ga = _out_grads(3000, dev)
    g = torch.Generator().manual_seed(12)
    cond = (torch.randn(1, 64, generator=g) * 0.5).to(dev).requires_grad_()
    ind = (torch.randn(4, generator=g) * 0.5).to(dev).requires_grad_()
    w = ff.FieldWeights(*[t.clone().requires_grad_() for t in w0])

    def counts():
        return (ff.fused_field.launches, ff.fused_field_forward_train.launches,
                ff.fused_field_bwd_chain.launches, ff.fused_field_wgrad.launches)

    c0 = counts()
    s, c, a = ff.fused_field_train(xyz, d, cond, ind, w)
    c1 = counts()
    loss = (s * gs).sum() + (c * gr).sum() + (a * ga).sum()
    first = torch.autograd.grad(loss, [cond, ind, *w], retain_graph=True)
    second = torch.autograd.grad(loss, [cond, ind, *w])
    c2 = counts()
    assert [y - x for x, y in zip(c0, c1)] == [1, 1, 0, 0]
    assert [y - x for x, y in zip(c1, c2)] == [0, 0, 2, 2]
    for g1, g2 in zip(first, second):
        assert torch.equal(g1, g2)
    with torch.no_grad():
        frozen = ff.FieldWeights(*[t.detach() for t in w])
        ab, cb = ff.bias_rows(cond.detach(), ind.detach(), frozen)
        blocks = ff.fused_field_backward(xyz, d, ab, cb, frozen, gs, gr, ga)
    assert torch.equal(first[2], blocks[0])  # pos_B, float32


# ---- the full frame: head + torso + 2x SR ---------------------------------

def _full_frame_infer(dev, sr_dtype):
    """GeneFaceInfer at the torso_sr widths (lm3d_radnerf_sr head, torso,
    SR) on a synthetic 128^2 identity loaded with_sr (raw 64^2), the
    bench's head occupancy and torso grid, SR noise strengths non-zero."""
    import chip_smoke
    from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset, synthetic
    from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer
    from genefaceplusplus_tpu_torch.models.radnerf_torso import TorsoField
    from genefaceplusplus_tpu_torch.models.superresolution import Superresolution, SynthesisLayer

    cfg, tcfg = chip_smoke.sr_head_config(), chip_smoke.torso_config()
    sr = Superresolution(3, 256, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        for i, layer in enumerate(m for m in sr.modules() if isinstance(m, SynthesisLayer)):
            layer.noise_strength.fill_(0.1 + 0.05 * i)
    ds = RADNeRFDataset(synthetic(num_frames=6, H=128, W=128), smo_win_size=cfg.smo_win_size, with_sr=True)
    return GeneFaceInfer(
        cfg, RADNeRF(cfg, generator=torch.Generator().manual_seed(5)).state_dict(), ds,
        chip_smoke.bench_occupancy(cfg.grid_size), device=dev, torso_cfg=tcfg,
        torso_params=TorsoField(tcfg, generator=torch.Generator().manual_seed(6)).state_dict(),
        torso_occupancy_2d=chip_smoke.bench_torso_grid(tcfg.grid_size), sr_params=sr.state_dict(),
        sr_dtype=sr_dtype)


# the full frame, card vs CPU, float32 throughout: the head's float32 MLP
# products sum in another order on the card, and compositing, the
# head-aware torso and the SR carry that on. Measured at
# 64^2 raw (one H100): max |d| 5.06e-4 (rgb_map), 7.2e-4 (torso_alpha),
# 3.8e-4 (sr_rgb_map); mean 1.1e-5 or less. Each stage alone, on the same
# inputs, holds 1e-4 (the two tests after this one).
FULL_FRAME_MAX, FULL_FRAME_MEAN = 2e-3, 1e-4


@pytest.mark.cuda
def test_full_frame_on_card_matches_cpu(cuda_setup):
    """One frame through render_full_frame with the float32 model field,
    the torso and float32 SR, crops as loaded, on the card and on the CPU:
    the raw composite, torso alpha and the SR frame within FULL_FRAME_MAX,
    their means within FULL_FRAME_MEAN."""
    from genefaceplusplus_tpu_torch.models.full_renderer import render_full_frame
    from genefaceplusplus_tpu_torch.utils.audio_features import get_audio_features_batch
    from genefaceplusplus_tpu_torch.utils.rays import pixel_rays

    dev = cuda_setup[0]
    outs = {}
    for d in ("cpu", dev):
        infer = _full_frame_infer(d, torch.float32)
        ds = infer.dataset
        batch = infer.prepare_gt_batch([2])
        with torch.no_grad():
            ro, rd = pixel_rays(torch.as_tensor(batch["poses"], device=d), ds.intrinsics, ds.H, ds.W)
            win = get_audio_features_batch(torch.as_tensor(batch["cond"], device=d),
                                           torch.arange(1, device=d), infer.head_cfg.smo_win_size)[0]
            out = render_full_frame(
                infer.head_model, ro[0], rd[0], win, infer.occupancy, infer.bg_color,
                infer.render_options({}), (ds.H, ds.W),
                eye_area_percent=torch.as_tensor(batch["eye_area_percent"], device=d),
                torso_model=infer.torso_model, bg_coords=infer.bg_coords,
                lm68=torch.as_tensor(batch["lm68"], device=d), occupancy_2d=infer.torso_occupancy_2d,
                sr_model=infer.sr_model, torso_crop=infer.torso_crop, sr_crop=infer.sr_crop,
                sr_bg=infer.sr_bg)
        outs[str(d)] = {k: getattr(out, k).cpu() for k in ("rgb_map", "torso_alpha", "sr_rgb_map")}
    assert outs["cpu"]["sr_rgb_map"].shape == (128, 128, 3)
    for k, ref in outs["cpu"].items():
        e = (outs[str(dev)][k] - ref).abs()
        print(f"[full_frame] card vs cpu {k}: max |d| {e.max().item():.3e}, mean {e.mean().item():.3e}")
        assert e.max().item() <= FULL_FRAME_MAX and e.mean().item() <= FULL_FRAME_MEAN, k


@pytest.mark.cuda
def test_torso_on_card_matches_cpu(cuda_setup):
    """The torso field at the torso_sr widths on the same inputs (pixel
    coords, jaw landmarks, head rgb and weights sum) on the card and the
    CPU: within 1e-4."""
    import chip_smoke
    from genefaceplusplus_tpu_torch.models.radnerf_torso import TorsoField

    dev = cuda_setup[0]
    model = TorsoField(chip_smoke.torso_config(), generator=torch.Generator().manual_seed(6)).eval()
    g = torch.Generator().manual_seed(10)
    n = 65536
    args = (torch.rand((n, 2), generator=g) * 2 - 1, torch.rand((1, 68, 2), generator=g),
            model.get_individual_code(0).detach(), torch.rand((n, 3), generator=g),
            torch.rand((n, 1), generator=g))
    with torch.no_grad():
        ref = model(*args)
        got = model.to(dev)(*(a.to(dev) for a in args))
    for name in ("alpha", "color", "deform"):
        err = (getattr(got, name).cpu() - getattr(ref, name)).abs().max().item()
        print(f"[torso] card vs cpu {name}: max |d| {err:.3e}")
        assert err <= 1e-4, (name, err)


@pytest.mark.cuda
def test_float32_sr_ignores_the_cudnn_tf32_flag(cuda_setup):
    """float32 SR on the card with torch.backends.cudnn.allow_tf32 left at
    its default (True) vs the CPU, within 1e-4 (TF32 convolutions would
    miss by ~1e-3); the flag is as it was afterwards."""
    from genefaceplusplus_tpu_torch.models.superresolution import Superresolution, SynthesisLayer

    dev = cuda_setup[0]
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    sr = Superresolution(3, 256, generator=torch.Generator().manual_seed(8)).eval()
    with torch.no_grad():
        for i, layer in enumerate(m for m in sr.modules() if isinstance(m, SynthesisLayer)):
            layer.noise_strength.fill_(0.2 + 0.05 * i)
    rgb = torch.rand((1, 128, 128, 3), generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        ref = sr(rgb)
        got = sr.to(dev)(rgb.to(dev)).cpu()
    assert torch.backends.cudnn.allow_tf32
    err = (got - ref).abs().max().item()
    print(f"[sr] float32 SR card vs cpu with cudnn.allow_tf32=True: max |d| {err:.3e}")
    assert err <= 1e-4, err


@pytest.mark.cuda
def test_a2m_on_card_matches_cpu_with_tf32_on(cuda_setup):
    """The full-width May a2m (PitchContourVAEModel; chip_smoke.py's seeded
    weights, with non-zero flow `post` convs and BatchNorm statistics) on
    4 s of seeded features, card vs CPU with the same draw and
    torch.backends.cudnn.allow_tf32 left on: within chip_smoke.A2M_CARD_MAX
    (its float32 convolutions clear the flag for the call)."""
    import chip_smoke
    from genefaceplusplus_tpu_torch.models.audio2motion.vae_model import a2m_batch, a2m_model_from_hparams

    dev = cuda_setup[0]
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    hp = chip_smoke.a2m_hparams()
    model = a2m_model_from_hparams(hp)
    model.load_state_dict(chip_smoke.seeded_a2m_params(hp, 3))
    model.eval()
    rs = np.random.RandomState(5)
    hubert = rs.randn(200, 1024).astype(np.float32)
    f0 = (np.abs(rs.randn(200)) * 60 + 100).astype(np.float32)
    noise = torch.randn((1, model.vae.latent_length(100), 16), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        ref, _ = model(a2m_batch(hubert, f0, 0.4, "cpu"), train=False, temperature=0.2, noise=noise)
        got, _ = model.to(dev)(a2m_batch(hubert, f0, 0.4, dev), train=False, temperature=0.2, noise=noise)
    assert torch.backends.cudnn.allow_tf32
    err = (got.cpu() - ref).abs().max().item()
    print(f"[a2m] card vs cpu with cudnn.allow_tf32=True: max |d| {err:.3e} on outputs up to "
          f"{ref.abs().max().item():.4f}")
    assert err <= chip_smoke.A2M_CARD_MAX, err


def _write_work_dirs(root):
    """JAX-layout work dirs written by the port (the card's machine has no
    JAX): a small a2m, a head + SR at raw 32^2 over a 64^2 dataset, a torso,
    and a head-only identity at 32^2."""
    import os

    from genefaceplusplus_tpu_torch.data.dataset import synthetic
    from genefaceplusplus_tpu_torch.models.audio2motion.vae_model import a2m_model_from_hparams
    from genefaceplusplus_tpu_torch.models.radnerf_torso import TorsoConfig, TorsoField
    from genefaceplusplus_tpu_torch.models.superresolution import Superresolution
    from genefaceplusplus_tpu_torch.utils.ckpt import save_flax_checkpoint
    from genefaceplusplus_tpu_torch.utils.convert_jax import export_flax_params

    binary = os.path.join(root, "binary")
    for vid, size in (("sr64", 64), ("head32", 32)):
        os.makedirs(os.path.join(binary, vid))
        np.save(os.path.join(binary, vid, "trainval_dataset.npy"), synthetic(num_frames=12, H=size, W=size),
                allow_pickle=True)
    a2m_hp = {"use_pitch": True, "audio_in_dim": 64, "a2m_hidden_channels": 32, "a2m_enc_layers": 2,
              "a2m_dec_layers": 2, "a2m_flow_hidden": 16, "a2m_flow_blocks": 2}
    head = {"grid_size": 16, "smo_win_size": 3, "individual_embedding_num": 16, "add_eye_blink_cond": True,
            "binary_data_dir": binary}
    sr_head = dict(head, with_sr=True, sr_dtype="bfloat16", video_id="sr64")
    torso_hp = {"with_sr": True, "torso_head_aware": True, "individual_embedding_num": 16, "grid_size": 16}
    occ = np.zeros((16,) * 3, bool)
    occ[5:11, 6:10, 5:11] = True
    grid = np.zeros((16, 16), np.float32)
    grid[11:15, 6:10] = 1.0
    g = torch.Generator().manual_seed
    d = {k: os.path.join(root, k) for k in ("a2m", "head_sr", "torso", "head")}
    save_flax_checkpoint(d["a2m"], 1, {"state_dict": {"variables": export_flax_params(
        a2m_model_from_hparams(a2m_hp, generator=g(5))), "opt_state": {}}}, config=a2m_hp)
    sr_cfg = RADNeRFConfig.from_hparams(sr_head)
    save_flax_checkpoint(d["head_sr"], 1, {
        "state_dict": {"params": {"head": export_flax_params(RADNeRF(sr_cfg, generator=g(6))),
                                  "sr": export_flax_params(Superresolution(3, 256, generator=g(7)))}, "opt_state": {}},
        "extra_state": {"occupancy": occ}}, config=sr_head)
    tcfg = TorsoConfig.from_hparams(torso_hp)
    save_flax_checkpoint(d["torso"], 1, {"state_dict": {"torso_params": export_flax_params(TorsoField(tcfg, generator=g(8))),
                                                        "opt_state": {}}, "extra_state": {"torso_grid": grid}},
                         config=dict(torso_hp, head_model_dir=d["head_sr"]))
    h_cfg = dict(head, video_id="head32")
    save_flax_checkpoint(d["head"], 1, {"state_dict": {"params": export_flax_params(
        RADNeRF(RADNeRFConfig.from_hparams(h_cfg), generator=g(9))), "opt_state": {}},
        "extra_state": {"occupancy": occ}}, config=h_cfg)
    return d


@pytest.mark.cuda
def test_work_dirs_load_on_the_card_as_on_the_cpu(cuda_setup, tmp_path):
    """from_work_dirs on the card loads the tensors, grids and crops it loads
    on the CPU, bit for bit."""
    from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer

    d = _write_work_dirs(str(tmp_path))
    card = GeneFaceInfer.from_work_dirs(audio2secc_dir=d["a2m"], torso_model_dir=d["torso"], device="cuda")
    cpu = GeneFaceInfer.from_work_dirs(audio2secc_dir=d["a2m"], torso_model_dir=d["torso"], device="cpu")
    for name in ("head_model", "torso_model", "sr_model", "a2m_model"):
        a, b = getattr(card, name).state_dict(), getattr(cpu, name).state_dict()
        assert set(a) == set(b) and all(a[k].is_cuda and torch.equal(a[k].cpu(), b[k]) for k in a), name
    assert torch.equal(card.occupancy.cpu(), cpu.occupancy)
    assert torch.equal(card.torso_occupancy_2d.cpu(), cpu.torso_occupancy_2d)
    assert (card.head_crop, card.torso_crop, card.sr_crop) == (cpu.head_crop, cpu.torso_crop, cpu.sr_crop)


@pytest.mark.cuda
def test_stream_resume_tail_is_exact_on_the_card(cuda_setup, tmp_path):
    """A stream resumed at a chunk boundary on the card (the generator
    replayed to the second chunk's draw) gives the uninterrupted stream's
    tail bit for bit."""
    from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer
    from genefaceplusplus_tpu_torch.inference.serving import stream_infer

    d = _write_work_dirs(str(tmp_path))
    infer = GeneFaceInfer.from_work_dirs(audio2secc_dir=d["a2m"], head_model_dir=d["head"], device="cuda")
    rs = np.random.RandomState(0)
    t = np.arange(int(2.6 * 16000)) / 16000.0
    wav = (0.3 * np.sin(2 * np.pi * (120.0 + 40.0 * t) * t)).astype(np.float32)
    inp = {"hubert_full": rs.randn(150, 64).astype(np.float32)}
    infer.generator.manual_seed(42)
    full = list(stream_infer(infer, wav, dict(inp), chunk_seconds=1.0))
    k = 24
    infer.generator.manual_seed(42)
    torch.randn((1, infer.a2m_model.vae.latent_length(k), 16), generator=infer.generator, device="cuda")
    resumed = list(stream_infer(infer, wav, dict(inp, resume_from_frame=k), chunk_seconds=1.0))
    assert len(full) > k and len(resumed) == len(full) - k
    for a, b in zip(resumed, full[k:]):
        np.testing.assert_array_equal(a, b)


def _seeded_optax(tree, rs, moment=None):
    """An optax-layout optimizer state (RADNeRFAdam.export_optax) with its
    moments seeded (mu ~ N(0, 1e-3), nu ~ U(1e-4, 1e-3)) and every count
    10: an update is then smooth in the gradient (Adam's first step from
    zero moments is lr x sign(g))."""
    if isinstance(tree, dict):
        return {k: _seeded_optax(v, rs, k if k in ("mu", "nu") else moment) for k, v in tree.items()}
    if moment is None:  # a step count
        return np.asarray(10, np.int32)
    if moment == "mu":
        return np.asarray(rs.randn(*tree.shape) * 1e-3, np.float32)
    return np.asarray(rs.uniform(1e-4, 1e-3, tree.shape), np.float32)


def _step_on(task_fn, device, prepare, step_args):
    task = task_fn(device)
    state = task.create_state()
    prepare(task, state)
    state.opt.load_optax(_seeded_optax(state.opt.export_optax(), np.random.RandomState(3)))
    state, metrics = task.train_step(state, *step_args(device))
    params = {k: v.detach().float().cpu() for k, v in state.model.state_dict().items()}
    return {k: float(v) for k, v in metrics.items()}, params


def _card_vs_cpu(task_fn, prepare, step_args, keys, rtol, atol, what):
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default; the float32 convolutions clear it
    m_c, p_c = _step_on(task_fn, "cpu", prepare, step_args)
    m_g, p_g = _step_on(task_fn, dev, prepare, step_args)
    assert torch.backends.cudnn.allow_tf32
    for k in keys:
        assert np.isfinite(m_g[k]) and m_c[k] > 0, k
        np.testing.assert_allclose(m_g[k], m_c[k], rtol=rtol, err_msg=k)
    worst = max(((p_g[k] - p_c[k]).abs().max().item(), k) for k in p_c)
    print(f"[{what}] card vs cpu: losses {[(k, abs(m_g[k] - m_c[k]) / m_c[k]) for k in keys]}; "
          f"updated params max |d| {worst[0]:.3e} ({worst[1]})")
    assert worst[0] <= atol, worst


def _identity(size, seed=0):
    from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset, synthetic

    d = synthetic(num_frames=8, H=size, W=size, seed=seed)
    rs = np.random.RandomState(seed + 1)
    for s in d["train_samples"] + d["val_samples"]:
        t = rs.rand(size, size, 4).astype(np.float32)
        t[..., 3] = t[..., 3] > 0.5
        s["torso_img"] = t
    return RADNeRFDataset(d, smo_win_size=3, with_sr=True)


def _head_occupancy(grid):
    lin = torch.linspace(-1, 1, grid)
    xx, yy, zz = torch.meshgrid(lin, lin, lin, indexing="ij")
    return (xx ** 2 + (2.2 * yy) ** 2 + (1.4 * zz) ** 2) < 0.3


@pytest.mark.cuda
def test_sr_step_on_card_matches_cpu(cuda_setup):
    """One head + SR train step (float32 SR; every term on: SR mse, the
    perceptual terms on the raw, SR and lip-crop frames) at the May SR
    widths over a 128^2 identity (64^2 renders), card vs CPU from the same
    weights, Adam state, occupancy and noise, with cuDNN's TF32 flag on:
    losses rtol 1e-4 and updated parameters within 2e-5 (measured on an
    H100: 9.3e-7 and 1.9e-6)."""
    from genefaceplusplus_tpu_torch.models.radnerf import MAY_LM3D_RADNERF_SR
    from genefaceplusplus_tpu_torch.training.tasks.sr_task import SRHeadNeRFTask, SRTaskConfig

    assert cuda_setup  # skips without a card
    ds = _identity(128)
    cfg = RADNeRFConfig.from_hparams({**MAY_LM3D_RADNERF_SR, "grid_size": 32, "individual_embedding_num": 16})
    tcfg = SRTaskConfig(n_rays=ds.H * ds.W, lpips_start_iters=0, lip_window=32, sr_dtype="float32")
    noise = torch.rand(ds.H * ds.W, generator=torch.Generator().manual_seed(5))

    def prepare(task, state):
        task.occupancy = _head_occupancy(32).to(task.device)

    _card_vs_cpu(lambda dev: SRHeadNeRFTask(ds, cfg, tcfg, seed=5, device=dev), prepare,
                 lambda dev: ({"frame_idx": 2}, noise.to(dev)),
                 ["mse_loss", "sr_mse_loss", "lpips_loss", "sr_lpips_loss", "sr_lip_lpips_loss", "total_loss"],
                 1e-4, 2e-5, "sr step")


@pytest.mark.cuda
def test_torso_step_on_card_matches_cpu(cuda_setup):
    """One torso train step at the May torso_sr widths over the frozen
    (seeded) head at a 128^2 identity (64^2 frames), card vs CPU from the
    same weights, Adam state and occupancy, with cuDNN's TF32 flag on:
    losses rtol 1e-4, updated torso parameters within 2e-5 (measured on an
    H100: 3.3e-6 and 4.3e-7)."""
    from genefaceplusplus_tpu_torch.models.radnerf import MAY_LM3D_RADNERF_TORSO_SR
    from genefaceplusplus_tpu_torch.training.tasks.torso_task import TorsoNeRFTask

    assert cuda_setup  # skips without a card
    ds = _identity(128, seed=2)
    hp = {**MAY_LM3D_RADNERF_TORSO_SR, "grid_size": 32, "individual_embedding_num": 16,
          "lambda_torso_deform": 0.01, "head_model_dir": ""}
    cfg = RADNeRFConfig.from_hparams(hp)

    def prepare(task, state):
        task.occupancy = _head_occupancy(32).to(task.device)

    _card_vs_cpu(lambda dev: TorsoNeRFTask(ds, cfg, hp, seed=5, device=dev), prepare,
                 lambda dev: ({"frame_idx": 3},), ["mse_loss", "torso_entropy", "deform_reg", "total_loss"],
                 1e-4, 2e-5, "torso step")


def _rel_errors(got, ref):
    """{name: max |got - ref| / max |ref|} over two dicts of CPU tensors."""
    return {k: ((got[k] - ref[k]).abs().max() / ref[k].abs().max().clamp_min(1e-30)).item() for k in ref}


@pytest.mark.cuda
def test_a2m_step_on_card_matches_cpu(cuda_setup):
    """One A2MTask step of the full-width May a2m (11,840,768 variables) at
    batch 8 x 64 frames, card vs CPU from the same weights, seeded Adam
    state, windows and posterior noise, with cuDNN's TF32 flag on: losses
    rtol 1e-5; the gradients, the updated parameters and the BatchNorm
    statistics within 1e-5 of each tensor's largest entry (the a2m's
    convolutions run in full float32 forward and backward)."""
    from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset, synthetic
    from genefaceplusplus_tpu_torch.training.tasks.a2m_task import A2MTask, A2MTaskConfig

    assert cuda_setup  # skips without a card
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    ds = RADNeRFDataset(synthetic(num_frames=300, H=16, W=16, seed=4))
    starts = torch.tensor([0, 17, 40, 66, 101, 150, 171, 190])
    noise = torch.randn((8, 16, 16), generator=torch.Generator().manual_seed(6))
    out = {}
    for dev in ("cpu", "cuda"):
        task = A2MTask(ds, A2MTaskConfig(), seed=5, device=dev)
        state = task.create_state()
        state.opt.load_optax(_seeded_optax(state.opt.export_optax(), np.random.RandomState(3)))
        state, metrics = task.train_step(state, {"starts": starts.to(dev)}, noise=noise)
        out[dev] = ({k: float(v) for k, v in metrics.items()},
                    {n: p.grad.cpu() for n, p in state.model.named_parameters()},
                    {k: v.cpu() for k, v in state.model.state_dict().items() if not k.endswith("tracked")})
    assert torch.backends.cudnn.allow_tf32
    (m_c, g_c, p_c), (m_g, g_g, p_g) = out["cpu"], out["cuda"]
    grads, params = _rel_errors(g_g, g_c), _rel_errors(p_g, p_c)
    wg, wp = max(grads.items(), key=lambda kv: kv[1]), max(params.items(), key=lambda kv: kv[1])
    print(f"[a2m step] card vs cpu, cudnn.allow_tf32=True: losses "
          f"{[(k, abs(m_g[k] - m_c[k]) / abs(m_c[k])) for k in m_c]}; gradients max |d| / max |g| {wg[1]:.3e} "
          f"({wg[0]}); updated tensors {wp[1]:.3e} ({wp[0]})")
    for k in m_c:
        np.testing.assert_allclose(m_g[k], m_c[k], rtol=1e-5, err_msg=k)
    assert wg[1] <= 1e-5 and wp[1] <= 1e-5, (wg, wp)


@pytest.mark.cuda
def test_perceptual_gradient_on_card_matches_cpu(cuda_setup):
    """The gradient of the small perceptual loss (the lip and SR steps') on
    128^2 images, card vs CPU, with cuDNN's TF32 flag on: within 1e-5 of
    its largest entry, and the loss rtol 1e-5."""
    from genefaceplusplus_tpu_torch.training.perceptual import PerceptualLoss

    assert cuda_setup  # skips without a card
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    g = torch.Generator().manual_seed(11)
    pred, gt = torch.rand((2, 128, 128, 3), generator=g), torch.rand((2, 128, 128, 3), generator=g)
    out = {}
    for dev in ("cpu", "cuda"):
        loss_fn = PerceptualLoss(seed=0, device=dev)
        x = pred.to(dev).detach().requires_grad_(True)
        loss = loss_fn(x, gt.to(dev))
        loss.backward()
        out[dev] = (loss.item(), x.grad.cpu())
    assert torch.backends.cudnn.allow_tf32
    rel = _rel_errors({"grad": out["cuda"][1]}, {"grad": out["cpu"][1]})["grad"]
    print(f"[perceptual] card vs cpu, cudnn.allow_tf32=True: loss {out['cuda'][0]:.6e} vs {out['cpu'][0]:.6e}; "
          f"gradient max |d| / max |g| {rel:.3e}")
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    assert rel <= 1e-5, rel


@pytest.mark.cuda
def test_eg3d_discriminator_on_card_matches_cpu(cuda_setup):
    """The EG3D dual discriminator at the reference's widths (channel_base
    32768, channel_max 512, 8 mapping layers) at 64^2, batch 2, seeded
    weights and inputs, with cuDNN's TF32 flag on: the logits and each
    feature map within 1e-4 of their largest |value|, card vs CPU; the
    feature-matching loss's gradients with respect to both images, the
    card's and the CPU's float32 each against the CPU's float64: the card
    within 4x the CPU's distance + 1e-4 (max |d| over the largest entry,
    and the L2 distance): an L1 of lrelu features is not smooth, so float32
    rounding flips some signs and kinks on either device (chip_smoke.py's
    DISC_ORDER_K)."""
    from genefaceplusplus_tpu_torch.models.eg3d_discriminator import EG3DDualDiscriminator, feature_matching_loss

    assert cuda_setup  # skips without a card
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default; the float32 convolutions clear it
    g = torch.Generator().manual_seed(21)
    img, raw = torch.rand((2, 3, 64, 64), generator=g), torch.rand((2, 3, 32, 32), generator=g)
    real, real_raw = torch.rand((2, 3, 64, 64), generator=g), torch.rand((2, 3, 32, 32), generator=g)
    cam = torch.randn((2, 25), generator=g)
    disc = EG3DDualDiscriminator(img_resolution=64, generator=torch.Generator().manual_seed(22)).requires_grad_(False)
    out = {}
    for name, dev, dt in (("cpu", "cpu", torch.float32), ("cuda", "cuda", torch.float32), ("f64", "cpu", torch.float64)):
        d = disc.to(dev, dt)
        x, r = img.to(dev, dt).detach().requires_grad_(True), raw.to(dev, dt).detach().requires_grad_(True)
        logits, feats = d(x, r, cam.to(dev, dt))
        _, target = d(real.to(dev, dt), real_raw.to(dev, dt), cam.to(dev, dt))
        feature_matching_loss(feats, target).backward()
        out[name] = {"logits": logits.detach().double().cpu(),
                     **{f"feat{i}": f.detach().double().cpu() for i, f in enumerate(feats)},
                     "grad_image": x.grad.double().cpu(), "grad_raw": r.grad.double().cpu()}
    fwd = {k: v for k, v in _rel_errors(out["cuda"], out["cpu"]).items() if not k.startswith("grad")}
    print(f"[eg3d disc] card vs cpu, max |d| / max |ref|: {fwd}")
    assert max(fwd.values()) <= 1e-4, fwd
    for k in ("grad_image", "grad_raw"):
        g64 = out["f64"][k]
        dist = {who: ((out[who][k] - g64).abs().max().item() / g64.abs().max().item(),
                      ((out[who][k] - g64).norm() / g64.norm()).item()) for who in ("cuda", "cpu")}
        print(f"[eg3d disc] {k} against float64 (max, L2): card {dist['cuda']}, cpu {dist['cpu']}")
        assert all(dist["cuda"][i] <= 4.0 * dist["cpu"][i] + 1e-4 for i in (0, 1)), (k, dist)


@pytest.mark.cuda
def test_lmd_v2_on_card_matches_cpu(cuda_setup):
    """The v2 landmark detector (seeded weights) on 4 seeded 512^2 frames
    through detect_lmd, card vs CPU: landmarks within 1e-4 px-scale of
    their largest, peak probabilities within 1e-5."""
    from genefaceplusplus_tpu_torch.metrics import lmd
    from genefaceplusplus_tpu_torch.utils.convert_jax import export_flax_params

    assert cuda_setup  # skips without a card
    params = export_flax_params(lmd.lm_detector("v2", generator=torch.Generator().manual_seed(5)))
    frames = np.random.RandomState(6).randint(0, 255, (4, 512, 512, 3), dtype=np.uint8)
    lms = {dev: lmd.detect_lms(frames, "", params=params, device=dev) for dev in ("cpu", "cuda")}
    conf = {dev: lmd.detect_lmd(frames, lms["cpu"], "", arch="v2", per_landmark=True, with_conf=True,
                                params=params, device=dev)[1] for dev in ("cpu", "cuda")}
    d_lms = np.abs(lms["cuda"] - lms["cpu"]).max() / np.abs(lms["cpu"]).max()
    d_conf = np.abs(conf["cuda"] - conf["cpu"]).max()
    print(f"[lmd v2] card vs cpu: landmarks {d_lms:.3e} of the largest, peak probabilities {d_conf:.3e}")
    assert d_lms <= 1e-4 and d_conf <= 1e-5


@pytest.mark.cuda
def test_sr_fm_step_on_card_matches_cpu(cuda_setup):
    """test_sr_step_on_card_matches_cpu's step with the frozen EG3D
    discriminator's feature matching on (lambda_dual_fm 0.1, the
    discriminator seeded alike on both, at the SR's 128^2): the losses, the
    feature-matching loss included, rtol 1e-4, updated parameters within
    2e-5."""
    from genefaceplusplus_tpu_torch.models.radnerf import MAY_LM3D_RADNERF_SR
    from genefaceplusplus_tpu_torch.training.tasks.sr_task import SRHeadNeRFTask, SRTaskConfig

    assert cuda_setup  # skips without a card
    ds = _identity(128)
    cfg = RADNeRFConfig.from_hparams({**MAY_LM3D_RADNERF_SR, "grid_size": 32, "individual_embedding_num": 16})
    tcfg = SRTaskConfig(n_rays=ds.H * ds.W, lpips_start_iters=0, lip_window=32, sr_dtype="float32",
                        lambda_dual_fm=0.1)
    noise = torch.rand(ds.H * ds.W, generator=torch.Generator().manual_seed(5))

    def prepare(task, state):
        task.occupancy = _head_occupancy(32).to(task.device)

    _card_vs_cpu(lambda dev: SRHeadNeRFTask(ds, cfg, tcfg, seed=5, device=dev), prepare,
                 lambda dev: ({"frame_idx": 2}, noise.to(dev)),
                 ["mse_loss", "sr_mse_loss", "lpips_loss", "sr_lpips_loss", "sr_lip_lpips_loss",
                  "dual_feature_matching_loss", "total_loss"],
                 1e-4, 2e-5, "sr + fm step")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,qp", [((3, 64, 96), 22), ((2, 136, 200), 22), ((2, 48, 64), 4)])
def test_h264_intra_writes_the_plain_bytes(shape, qp):
    """The H.264 kernel's slices equal encode_plain's byte for byte (integer
    arithmetic throughout), cropped sizes and the I_PCM escape included: its
    framed units, compacted and split by frame, equal access_units' of the
    plain RBSPs; one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from genefaceplusplus_tpu_torch.data import h264
    from genefaceplusplus_tpu_torch.ops import h264_encode as he

    frames = torch.from_numpy(np.random.RandomState(sum(shape)).randint(0, 256, shape + (3,)).astype(np.uint8))
    plain = h264.encode_plain(frames, 1, qp)
    before = he.h264_intra.launches
    units, lengths = he.h264_intra(frames.cuda(), 1, qp)
    torch.cuda.synchronize()
    assert he.h264_intra.launches == before + 1
    assert he.split_access_units(he.copy_units(units, lengths), shape[0]) == \
        h264.access_units(plain.rows, plain.bits, shape[0])


@pytest.mark.cuda
@pytest.mark.parametrize("qp", [4, 22])
def test_h264_intra_takes_frames_past_shared_memory(qp):
    """Frames WIDE (4,096) pixels wide, whose slice words do not fit the
    kernel's shared memory: the kernel keeps them in each slice's row of the
    output (the returned units a view of wider rows) and still writes
    encode_plain's bytes, the I_PCM escape included at QP 4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from genefaceplusplus_tpu_torch.data import h264
    from genefaceplusplus_tpu_torch.ops import h264_encode as he
    from genefaceplusplus_tpu_torch.testing import WIDE, wide_frames

    frames = torch.from_numpy(wide_frames())
    plain = h264.encode_plain(frames, 0, qp)
    units, lengths = he.h264_intra(frames.cuda(), 0, qp)
    assert units.shape == (3, h264.unit_bytes(WIDE)) and units.stride(0) > units.shape[1]
    assert he.split_access_units(he.copy_units(units, lengths), 1) == h264.access_units(plain.rows, plain.bits, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 2 * ff.FWD_STEP + 3, 1_000_003])
def test_kernel_over_a_mesh_equals_one_launch(cuda_setup, n):
    """B1 over a mesh (`parallel.mesh.map_blocks`): the first two cards, or
    two streams of one card, each shard launching its block with its
    device's replica of the weights; the outputs equal one launch's bit for
    bit (the kernel is per point), one launch a shard (an empty block
    launches nothing)."""
    from genefaceplusplus_tpu_torch.parallel import mesh as pm

    dev, w, ab, cb = cuda_setup
    mesh = pm.make_mesh(2) if torch.cuda.device_count() >= 2 else pm.Mesh([dev, dev])
    ws, biases = pm.replicated(mesh, w), pm.broadcast(mesh, ab, cb)
    xyz, d = _points(n, dev, seed=n)
    ff.fused_field.device_launches.clear()
    with torch.no_grad():
        one = ff.fused_field(xyz, d, ab, cb, w)
        sharded = pm.map_blocks(mesh, lambda i, x, y: ff.fused_field(x, y, *biases[i], ws[i]), xyz, d)
    torch.cuda.synchronize()
    for a, b in zip(one, sharded):
        assert b.device == xyz.device and torch.equal(a, b)
    want = {}
    for block, dv in zip(torch.tensor_split(xyz, mesh.size), mesh.devices):
        want[str(dv)] = want.get(str(dv), 0) + (block.shape[0] > 0)
    want[str(xyz.device)] += 1  # the single launch
    assert dict(ff.fused_field.device_launches) == {k: v for k, v in want.items() if v}
