"""The backward's split into a tile chain and a weight-gradient kernel, on
the CPU: the plain operands followed by the plain weight-gradient products
equal the one-function plain backward they replace; the operand buffer's
layout (the chain's transposing store and its inverse); and the
weight-gradient kernel's product table against GRAD_BLOCKS. The kernels
themselves are compared with these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from genefaceplusplus_tpu_torch.ops import fused_field as ff


def _backward_plain_one_function(xyz, dirs, amb_bias, col_bias, w, g_sigma, g_rgb, g_amb, amb_dim=3):
    """The plain backward as one function, before it was split into
    operands and weight gradients (kept here as the reference)."""
    relu = torch.relu
    f = [t.float() for t in w]
    pos_B, amb_w1, amb_w2, amb_w3, amb_B, sig_w1, sig_w2, sig_w3, col_w1, col_w2 = f
    xyz, dirs = xyz.float(), dirs.float()
    dev = xyz.device

    # ---- forward recompute ----
    proj = ff.project(xyz, pos_B[:3])
    sin_p, cos_p = ff.fast_sin(proj), ff.fast_cos(proj)
    pos_feat = ff._r(torch.cat([sin_p, cos_p], dim=-1))
    a1 = relu(pos_feat @ amb_w1[:256] + amb_bias)
    a1b = ff._r(a1)
    a2 = relu(a1b @ amb_w2)
    a2b = ff._r(a2)
    amb_pos = ff.fast_tanh(a2b @ amb_w3[:, :amb_dim])
    aproj = ff.project(amb_pos, amb_B[:amb_dim])
    sin_a, cos_a = ff.fast_sin(aproj), ff.fast_cos(aproj)
    amb_feat = ff._r(torch.cat([sin_a, cos_a], dim=-1))
    s1 = relu(pos_feat @ sig_w1[:256] + amb_feat @ sig_w1[256:384])
    s1b = ff._r(s1)
    s2 = relu(s1b @ sig_w2)
    s2b = ff._r(s2)
    sig_out = s2b @ sig_w3[:, :129]
    sig_logit = sig_out[:, 0]
    sigma = torch.exp(torch.clamp(sig_logit, -15.0, 15.0))
    geo = ff._r(sig_out[:, 1:129])
    sh = ff._r(ff._sh16(dirs))
    c1 = relu(sh @ col_w1[:16] + geo @ col_w1[16:144] + col_bias)
    c1b = ff._r(c1)
    rgb = 1.0 / (1.0 + torch.exp(-(c1b @ col_w2[:, :3])))

    def padded(live, shape):
        out = torch.zeros(shape, dtype=torch.float32, device=dev)
        out[: live.shape[0], : live.shape[1]] = live
        return out

    # ---- backward ----
    g_rgb_logit = ff._r(g_rgb.float() * rgb * (1.0 - rgb))
    g_col_w2 = padded(c1b.t() @ g_rgb_logit, (128, 128))
    g_c1 = ff._r((g_rgb_logit @ col_w2[:, :3].t()) * (c1 > 0.0))
    g_col_w1s = sh.t() @ g_c1
    g_col_w1g = geo.t() @ g_c1
    g_col_bias = padded(g_c1.sum(0, keepdim=True), (8, 128))
    g_geo = g_c1 @ col_w1[16:144].t()

    in_range = (sig_logit > -15.0) & (sig_logit < 15.0)
    g_sig0 = torch.where(in_range, g_sigma.float() * sigma, torch.zeros_like(sigma))
    g_sig_out = ff._r(torch.cat([g_sig0[:, None], g_geo], dim=-1))  # [N, 129]
    g_sig_w3 = padded(s2b.t() @ g_sig_out, (128, 256))
    g_s2 = ff._r((g_sig_out @ sig_w3[:, :129].t()) * (s2 > 0.0))
    g_sig_w2 = s1b.t() @ g_s2
    g_s1 = ff._r((g_s2 @ sig_w2.t()) * (s1 > 0.0))
    g_sig_w1p = pos_feat.t() @ g_s1
    g_sig_w1a = amb_feat.t() @ g_s1
    g_pos_feat_s = g_s1 @ sig_w1[:256].t()
    g_amb_feat = g_s1 @ sig_w1[256:384].t()

    g_aproj = g_amb_feat[:, :64] * cos_a - g_amb_feat[:, 64:] * sin_a
    g_amb_B = padded(ff._r(amb_pos).t() @ ff._r(g_aproj), (128, 64))
    g_amb_pos = ff._r(g_aproj) @ ff._r(amb_B[:amb_dim]).t() + g_amb.float()
    g_amb_logit = ff._r(g_amb_pos * (1.0 - amb_pos * amb_pos))
    g_amb_w3 = padded(a2b.t() @ g_amb_logit, (128, 128))
    g_a2 = ff._r((g_amb_logit @ amb_w3[:, :amb_dim].t()) * (a2 > 0.0))
    g_amb_w2 = a1b.t() @ g_a2
    g_a1 = ff._r((g_a2 @ amb_w2.t()) * (a1 > 0.0))
    g_amb_w1p = pos_feat.t() @ g_a1
    g_amb_bias = padded(g_a1.sum(0, keepdim=True), (8, 128))
    g_pos_feat = g_pos_feat_s + g_a1 @ amb_w1[:256].t()

    g_proj = g_pos_feat[:, :128] * cos_p - g_pos_feat[:, 128:] * sin_p
    g_pos_B = padded(ff._r(xyz).t() @ ff._r(g_proj), (8, 128))
    return (g_pos_B, g_amb_w1p, g_amb_bias, g_amb_w2, g_amb_w3, g_amb_B,
            g_sig_w1p, g_sig_w1a, g_sig_w2, g_sig_w3, g_col_w1s, g_col_w1g,
            g_col_bias, g_col_w2)


def _field(n, seed):
    """Seeded inputs at realistic ranges (Fourier phases, ReLUs, tanh)."""
    rs = np.random.RandomState(seed)
    shapes = {k: s for k, (s, _) in ff.FIELD_SHAPES.items()}
    mats = {k: (rs.randn(*s) * 0.1).astype(np.float32) for k, s in shapes.items()}
    for k in ("pos_B", "amb_B"):
        mats[k][3:] = 0.0
        mats[k][:3] *= 30.0
    mats["amb_w3"] *= 5.0
    w = ff.FieldWeights(**{k: torch.from_numpy(v).to(ff.FIELD_SHAPES[k][1]) for k, v in mats.items()})
    xyz = torch.from_numpy(rs.uniform(-1, 1, (n, 3)).astype(np.float32))
    d = torch.from_numpy(rs.randn(n, 3).astype(np.float32))
    d = d / d.norm(dim=-1, keepdim=True)
    ab, cb = (torch.from_numpy((rs.randn(128) * 0.3).astype(np.float32)) for _ in range(2))
    gs, gr, ga = (torch.from_numpy(rs.randn(*s).astype(np.float32)) for s in ((n,), (n, 3), (n, 3)))
    return xyz, d, ab, cb, w, gs, gr, ga


@pytest.mark.parametrize("n", [1, 63, 65, 300])
def test_operands_then_wgrad_equal_the_one_function_backward(n):
    """Same math, same bf16 rounding points; only float32 summation order
    may differ (sig_w3's columns are reordered in its operand): every block
    within 1e-5 of its largest entry, and the operands are bf16 values."""
    args = _field(n, n)
    ops = ff.fused_field_bwd_operands_plain(*args)
    assert [k for k in ops] == [name for name, _ in ff.WGRAD_OPERANDS]
    for name, rows in ff.WGRAD_OPERANDS:
        assert tuple(ops[name].shape) == (n, rows), name
        torch.testing.assert_close(ops[name], ops[name].to(torch.bfloat16).float(), rtol=0, atol=0)
    new = ff.fused_field_wgrad_plain(ops)
    ref = _backward_plain_one_function(*args)
    assert all(torch.equal(a, b) for a, b in zip(ff.fused_field_backward_plain(*args), new))
    for (name, shape, _), a, b in zip(ff.GRAD_BLOCKS, new, ref):
        assert tuple(a.shape) == shape, name
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * max(b.abs().max().item(), 1e-30), msg=name)


def _chain_store(x: torch.Tensor) -> torch.Tensor:
    """Twin of fused_field_bwd.cu's store_operand: [npad, R] -> flat, tile
    by tile, 16-byte chunk u of a tile holding features 8 j + u % 8, points
    16 s + 8 h .. + 7, with s = u / 2R, (j, h) = core matrix (u % 2R) / 8."""
    npad, R = x.shape
    out = torch.empty(npad * R, dtype=x.dtype)
    u = torch.arange(64 * R // 8)
    s, cm = u // (2 * R), (u % (2 * R)) // 8
    f, p0 = (cm // 2) * 8 + u % 8, s * 16 + (cm % 2) * 8
    p = p0[:, None] + torch.arange(8)
    for t in range(npad // 64):
        out[t * 64 * R:(t + 1) * 64 * R] = x[t * 64 + p, f[:, None]].flatten()
    return out


@pytest.mark.parametrize("n", [1, 64, 130])
def test_operand_layout_round_trip(n):
    """pack_operands (the chain's store, through pack_kmajor) equals the
    store's own index formula, unpack_operands inverts it bit for bit, and
    the points past n are zero."""
    rs = np.random.RandomState(n)
    ops = {name: torch.from_numpy(rs.randn(n, rows).astype(np.float32)).to(torch.bfloat16)
           for name, rows in ff.WGRAD_OPERANDS}
    buf = ff.pack_operands(ops)
    npad = ff.operand_points(n)
    assert npad % ff.OPERAND_TILE == 0 and npad - n < ff.OPERAND_TILE
    assert buf.dtype == torch.bfloat16 and buf.numel() == npad * ff.OPERAND_ROWS
    off = 0
    for name, rows in ff.WGRAD_OPERANDS:
        twin = _chain_store(F.pad(ops[name], (0, 0, 0, npad - n)))
        assert torch.equal(buf[off: off + npad * rows], twin), name
        off += npad * rows
    back = ff.unpack_operands(buf, n)
    assert all(torch.equal(back[k], ops[k]) for k in ops)
    padded = ff.unpack_operands(buf, npad)
    assert all(not padded[k][n:].float().any() for k in ops)


def _wgrad_by_products(ops):
    """The weight gradients by WGRAD_ITEMS' products, as the kernel forms
    them (M^T . N per product, transposed where marked), and how many times
    each entry of the 14 blocks was written."""
    n = ops["x0"].shape[0]
    blocks = {name: torch.zeros(shape) for name, shape, _ in ff.GRAD_BLOCKS}
    hits = {name: torch.zeros(shape, dtype=torch.int32) for name, shape, _ in ff.GRAD_BLOCKS}
    ones = torch.zeros(n, 8)
    ones[:, 0] = 1.0
    for names, prods in ff.WGRAD_ITEMS:
        for m, mb, nop, nrow, nw, blk, r0, c0, live, trans in prods:
            assert m in names and (nop == ff.ONES or nop in names)
            a = ops[m].float()[:, 64 * mb: 64 * mb + 64]
            b = ones if nop == ff.ONES else ops[nop].float()[:, nrow: nrow + nw]
            d = (a.t() @ b)[:, :live]
            if trans:
                d = d.t()
            blocks[blk][r0: r0 + d.shape[0], c0: c0 + d.shape[1]] += d
            hits[blk][r0: r0 + d.shape[0], c0: c0 + d.shape[1]] += 1
    return blocks, hits


def test_product_table_maps_onto_grad_blocks():
    """Every live entry of every block is written by exactly one product,
    nothing outside the live regions, and the products give the plain
    weight gradients (transposed outputs and bias rows included); the
    flat table the CUDA library is checked against describes the same."""
    args = _field(100, 11)
    ops = ff.fused_field_bwd_operands_plain(*args)
    blocks, hits = _wgrad_by_products(ops)
    for (name, shape, (r, c)), ref in zip(ff.GRAD_BLOCKS, ff.fused_field_wgrad_plain(ops)):
        live = torch.zeros(shape, dtype=torch.int32)
        live[:r, :c] = 1
        assert torch.equal(hits[name], live), name
        torch.testing.assert_close(blocks[name], ref, rtol=0, atol=1e-5 * max(ref.abs().max().item(), 1e-30),
                                   msg=name)
    assert ff.PACKED_SIZE == 151232 and ff.OPERAND_ROWS == 2168
    t = ff.wgrad_table()
    assert t[0] == len(ff.WGRAD_OPERANDS) and t[1 + len(ff.WGRAD_OPERANDS)] == len(ff.GRAD_BLOCKS)
    assert len(t) == 2 + len(ff.WGRAD_OPERANDS) + 2 * len(ff.GRAD_BLOCKS) + 2 + sum(
        2 + len(o) + 10 * len(p) for o, p in ff.WGRAD_ITEMS)


@pytest.mark.parametrize("n", [1, 65])
def test_chain_and_wgrad_take_cuda_tensors_only(n):
    """The backward's two kernel wrappers have no plain route: on CPU (or
    any other non-CUDA) tensors they raise and count nothing, while
    fused_field_backward gives the plain gradients on the CPU."""
    args = _field(n, 20 + n)
    buf = ff.pack_operands(ff.fused_field_bwd_operands_plain(*args))
    before = (ff.fused_field_bwd_chain.launches, ff.fused_field_wgrad.launches, ff.fused_field_backward.launches)
    with pytest.raises(ValueError, match="unsupported device cpu"):
        ff.fused_field_bwd_chain(*args)
    with pytest.raises(ValueError, match="unsupported device cpu"):
        ff.fused_field_wgrad(buf, n)
    with pytest.raises(ValueError, match="unsupported device meta"):
        ff.fused_field_wgrad(torch.empty(buf.shape, dtype=buf.dtype, device="meta"), n)
    for a, b in zip(ff.fused_field_wgrad_plain(ff.unpack_operands(buf, n)), ff.fused_field_backward(*args)):
        assert torch.equal(a, b)
    assert (ff.fused_field_bwd_chain.launches, ff.fused_field_wgrad.launches,
            ff.fused_field_backward.launches) == before
