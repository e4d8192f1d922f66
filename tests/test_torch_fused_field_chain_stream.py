"""The backward chain's packed weight stream (`ops/fused_field.py`:
`CHAIN_LAYERS`, `pack_chain_weights`, `chain_weights`) on the CPU: each
product's B block read back through csrc/sm90.cuh's K-major layout, the
stream's length and chunks, a product-by-product emulation of the chain
from the stream against `fused_field_chain_plain` (every product of the
chain read from the stream once, in the kernel's column order) and against
the JAX package's `_fused_backward` through it, and the cache per
FieldWeights version. The kernel itself runs on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genefaceplusplus_tpu.ops.pallas import fused_field as JF
from genefaceplusplus_tpu_torch.ops import fused_field as ff
from genefaceplusplus_tpu_torch.ops.fastmath import fast_cos, fast_sin
from genefaceplusplus_tpu_torch.ops.fourier_encoder import project

NAMES = [name for name, *_ in ff.CHAIN_LAYERS]


def _sentinel_weights(seed=11):
    """Random FieldWeights whose entries no input-gradient product reads
    (cond / ind / padding rows, SH rows of col_w1, padded columns) hold
    7.0, which no live entry (|x| < 1) does."""
    g = torch.Generator().manual_seed(seed)
    w = {name: (torch.rand(shape, generator=g) * 2 - 1).to(dtype) for name, (shape, dtype) in ff.FIELD_SHAPES.items()}
    for name, sl in (("amb_w1", np.s_[256:]), ("amb_w3", np.s_[:, 3:]), ("sig_w3", np.s_[:, 129:]),
                     ("col_w1", np.s_[:16]), ("col_w1", np.s_[144:]), ("col_w2", np.s_[:, 3:])):
        w[name][sl] = 7.0
    return ff.FieldWeights(**w)


def _offsets():
    """{name: (element offset, N, K)} of each product's block in the stream."""
    out, off = {}, 0
    for name, n, k, _ in ff.CHAIN_LAYERS:
        out[name] = (off, n, k)
        off += n * k
    return out


def _unpack(packed, name):
    """Product `name`'s B operand [N, K], read back from the flat stream by
    the layout's index formula (csrc/sm90.cuh), independently of
    pack_kmajor: k16 step s is N x 16 values, core matrix (row group j, k
    half h) at (2 j + h) x 64, its rows 8 values apart."""
    off, n, k = _offsets()[name]
    s, r, kk = np.meshgrid(np.arange(k // 16), np.arange(n), np.arange(16), indexing="ij")
    idx = off + s * n * 16 + ((r // 8) * 2 + kk // 8) * 64 + (r % 8) * 8 + kk % 8
    out = np.full((n, k), np.nan, np.float32)
    out[r, 16 * s + kk] = packed[idx]
    return out


def _want(w, name):
    """The B block Tentpole-style: the live block of W itself ([in, out]),
    K zero-padded; the position halves' rows 64 sin features then the same
    64 cos features, K = sig_w1's columns then amb_w1's."""
    f = {k: getattr(w, k).float().numpy() for k in ff.FIELD_SHAPES}
    pos = np.concatenate([f["sig_w1"][:256], f["amb_w1"][:256]], axis=1)
    lo = np.r_[0:64, 128:192]
    return {
        "col_w2": np.pad(f["col_w2"][:, :3], ((0, 0), (0, 13))),
        "col_w1": f["col_w1"][16:144],
        "sig_w3": np.pad(f["sig_w3"][:, :129], ((0, 0), (0, 15))),
        "sig_w2": f["sig_w2"],
        "sig_w1a": f["sig_w1"][256:384],
        "amb_w3": np.pad(f["amb_w3"][:, :3], ((0, 0), (0, 13))),
        "amb_w2": f["amb_w2"],
        "pos_lo": pos[lo],
        "pos_hi": pos[lo + 64],
    }[name]


@pytest.mark.parametrize("name", NAMES)
def test_chain_stream_holds_each_product_block(name):
    w = _sentinel_weights()
    packed = ff.pack_chain_weights(w).float().numpy()
    assert not (packed == 7.0).any()  # no padding, SH, cond or ind row reaches the stream
    np.testing.assert_array_equal(_unpack(packed, name), _want(w, name))  # bf16 values, exact in float32


def test_chain_stream_length_and_chunks():
    """The stream is the table's sum (153,600 bf16, ~300 KB), every product
    is N = 128 (m64n128), and its chunks are whole k16 steps of at most the
    kernel's 16 KB stage, each a multiple of 16 bytes (bulk copies)."""
    packed = ff.pack_chain_weights(_sentinel_weights())
    assert packed.dtype == torch.bfloat16
    assert packed.numel() == sum(n * k for _, n, k, _ in ff.CHAIN_LAYERS) == 153_600
    for _, n, k, chunk in ff.CHAIN_LAYERS:
        assert n == 128 and k % 16 == 0 and (k // 16) % chunk == 0
        assert chunk * n * 32 <= 16384 and (chunk * n * 32) % 16 == 0
    assert sorted(ff.CHAIN_POS_ROWS["pos_lo"] + ff.CHAIN_POS_ROWS["pos_hi"]) == list(range(256))


def _emulated_chain(xyz, fwd, w, g_sigma, g_rgb, g_amb):
    """The chain's products as the kernel computes them, every B operand
    read from the packed stream (`_unpack`): the sigma column first in
    sig_w3's K, the position gradient from two accumulators whose columns c
    and c + 64 are a sin feature and its cos feature. float32 sums."""
    packed = ff.pack_chain_weights(w).float().numpy()
    B = {name: torch.from_numpy(_unpack(packed, name)) for name in NAMES}
    r = lambda x: x.to(torch.bfloat16).float()
    m_a1, m_a2, m_s1, m_s2, m_c1 = fwd.relu.unbind(1)
    n = xyz.shape[0]
    g_rgb_logit = r(torch.nn.functional.pad(g_rgb * fwd.rgb * (1.0 - fwd.rgb), (0, 13)))
    g_c1 = r(g_rgb_logit @ B["col_w2"].t() * m_c1)
    g_geo = g_c1 @ B["col_w1"].t()
    g_sig0 = torch.where(fwd.gate, g_sigma * fwd.sigma, torch.zeros_like(fwd.sigma))
    g_sig_out = r(torch.cat([g_sig0[:, None], g_geo, torch.zeros(n, 15)], dim=1))
    g_s2 = r(g_sig_out @ B["sig_w3"].t() * m_s2)
    g_s1 = r(g_s2 @ B["sig_w2"].t() * m_s1)
    g_amb_feat = g_s1 @ B["sig_w1a"].t()
    amb_B = w.amb_B.float()[:3]
    aproj = project(fwd.amb, amb_B)
    g_aproj = r(g_amb_feat[:, :64] * fast_cos(aproj) - g_amb_feat[:, 64:] * fast_sin(aproj))
    g_amb_logit = r((g_aproj @ r(amb_B).t() + g_amb) * (1.0 - fwd.amb * fwd.amb))
    g_a2 = r(torch.nn.functional.pad(g_amb_logit, (0, 13)) @ B["amb_w3"].t() * m_a2)
    g_a1 = r(g_a2 @ B["amb_w2"].t() * m_a1)
    proj = project(xyz, w.pos_B.float()[:3])
    g_proj = torch.zeros(n, 128)
    for half, name in enumerate(("pos_lo", "pos_hi")):
        acc = torch.cat([g_s1, g_a1], dim=1) @ B[name].t()  # columns: sin 64 half + c, then cos
        f = slice(64 * half, 64 * half + 64)
        g_proj[:, f] = r(acc[:, :64] * fast_cos(proj[:, f]) - acc[:, 64:] * fast_sin(proj[:, f]))
    return {"gc1a": g_c1[:, :64], "gc1b": g_c1[:, 64:], "gaproj": g_aproj, "gproj": g_proj, "gs1": g_s1,
            "ga1": g_a1, "ga2": g_a2, "gs2": g_s2,
            "gsig": torch.cat([g_sig_out[:, 1:129], g_sig_out[:, :1], torch.zeros(n, 7)], dim=1),
            "grgb": g_rgb_logit[:, :8], "gamb": torch.nn.functional.pad(g_amb_logit, (0, 5))}


def _inputs(n, seed):
    """Seeded points, output gradients and realistic FieldWeights (the
    Fourier phases, ReLUs and tanh all in range), and the plain train
    mode's result on them."""
    rs = np.random.RandomState(seed)
    rnd = lambda *s: (rs.randn(*s) * 0.1).astype(np.float32)
    mats = {name: rnd(*shape) for name, (shape, _) in ff.FIELD_SHAPES.items()}
    for name in ("pos_B", "amb_B"):
        mats[name][3:] = 0.0
        mats[name][:3] *= 30.0
    mats["amb_w3"] *= 5.0
    w = ff.FieldWeights(**{k: torch.from_numpy(v).to(ff.FIELD_SHAPES[k][1]) for k, v in mats.items()})
    xyz = torch.from_numpy(rs.uniform(-1, 1, (n, 3)).astype(np.float32))
    d = torch.from_numpy(rs.randn(n, 3).astype(np.float32))
    d = d / d.norm(dim=-1, keepdim=True)
    ab, cb = ff.bias_rows(torch.from_numpy(rnd(1, 64)), torch.from_numpy(rnd(4)), w)
    gs, gr, ga = (torch.from_numpy(rnd(*s)) for s in ((n,), (n, 3), (n, 3)))
    return xyz, d, ab, cb, w, gs, gr, ga


@pytest.mark.parametrize("n,seed", [(1, 0), (64, 1), (301, 2)])
def test_emulated_chain_from_the_stream_matches_the_plain_chain(n, seed):
    """Each product of `fused_field_chain_plain` taken from the stream, in
    the kernel's column orders, gives the plain chain's operands: both are
    float32 sums of the same bf16 products in other orders (the stream's
    padded K adds exact zeros), so they agree to a bf16 step of an entry
    near the largest (1e-2 of each operand's largest entry, the card
    tests' CHAIN_MAX_REL) and exactly on all but a few entries. A block in
    the wrong place, a transposed block or a sin/cos row order that does
    not pair would move whole columns."""
    xyz, d, ab, cb, w, gs, gr, ga = _inputs(n, seed)
    fwd = ff.fused_field_train_plain(xyz, d, ab, cb, w)
    want = ff.fused_field_chain_plain(xyz, fwd, w, gs, gr, ga)
    got = _emulated_chain(xyz, fwd, w, gs, gr, ga)
    assert set(got) == set(want) == set(ff.OPERAND_WRITERS["fused_field_bwd"])
    for name in want:
        a, b = got[name], want[name]
        assert a.shape == b.shape, name
        scale = max(b.abs().max().item(), 1e-30)
        assert (a - b).abs().max().item() <= 1e-2 * scale, name
        assert (a != b).float().mean().item() <= 0.03, name


def test_emulated_chain_from_the_stream_matches_jax_backward():
    """The weight gradients of the emulated chain's operands (the port's
    `fused_field_wgrad_plain` on the train mode's activations and the
    stream-emulated gradients) against the JAX package's `_fused_backward`
    (Pallas interpret mode) on the same 256 points: the chain read from the
    stream computes the JAX backward's input gradients. Both are bf16-in /
    f32-sum chains with the same rounding points in other summation orders,
    and a flipped bf16 rounding of one point's gradient carries a share of
    an entry: each of the 14 blocks within 2e-2 of its largest entry
    (measured over four seeds: 8.6e-3 at most) and cosine >= 0.999."""
    n = 256
    xyz, d, ab, cb, w, gs, gr, ga = _inputs(n, 5)
    fwd = ff.fused_field_train_plain(xyz, d, ab, cb, w)
    ops = {**fwd.ops, **_emulated_chain(xyz, fwd, w, gs, gr, ga)}
    got = ff.fused_field_wgrad_plain(ops)
    wj = {k: jnp.asarray(getattr(w, k).float().numpy(), jnp.float32 if k in ("pos_B", "amb_B") else jnp.bfloat16)
          for k in ff.FIELD_SHAPES}
    mats = (wj["pos_B"], wj["amb_w1"][:256], wj["amb_w2"], wj["amb_w3"], wj["amb_B"], wj["sig_w1"][:256],
            wj["sig_w1"][256:384], wj["sig_w2"], wj["sig_w3"], wj["col_w1"][:16], wj["col_w1"][16:144],
            wj["col_w2"])

    def pad(a, width):
        out = np.zeros((n, width), np.float32)
        out[:n, : a.shape[1]] = a
        return jnp.asarray(out)

    gout = np.zeros((n, 128), np.float32)
    gout[:n, 0], gout[:n, 1:4], gout[:n, 4:7] = gs.numpy(), gr.numpy(), ga.numpy()
    want = JF._fused_backward(pad(xyz.numpy(), 8), pad(d.numpy(), 8), jnp.asarray(ab.numpy()[None]),
                              jnp.asarray(cb.numpy()[None]), mats, jnp.asarray(gout), 3, 64, True)
    for (name, _, _), a, b in zip(ff.GRAD_BLOCKS, got, want):
        a, b = a.double().numpy().ravel(), np.asarray(b, np.float64).ravel()
        assert a.shape == b.shape, name
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() <= 2e-2 * scale, name
        if np.linalg.norm(b) > 0:
            assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.999, name


def test_chain_weights_are_cached_per_field_weights_version():
    """The same tensor for unchanged weights; a new pack after an in-place
    update (a train step updates the weights in place: a stale stream
    would give the old weights' gradients) and for other tensors; the
    forward's stream is cached apart."""
    w = _sentinel_weights()
    first = ff.chain_weights(w)
    assert ff.chain_weights(w) is first
    assert ff.packed_weights(w) is not first and ff.packed_weights(w).numel() != first.numel()
    assert ff.chain_weights(w._replace(sig_w2=w.sig_w2.clone())) is not first  # other tensors
    w.sig_w2.add_(0.25)  # in place: a new version
    again = ff.chain_weights(w)
    assert again is not first and not torch.equal(again, first)
    torch.testing.assert_close(again, ff.pack_chain_weights(w), rtol=0, atol=0)
    assert ff.chain_weights(ff.FieldWeights(*(t.clone() for t in w))) is not again  # a new FieldWeights
    w.pos_B.mul_(2.0)  # a weight the stream does not hold still bumps the version: repacked, same values
    third = ff.chain_weights(w)
    assert third is not again
    torch.testing.assert_close(third, again, rtol=0, atol=0)


def test_chain_weights_of_inference_tensors():
    """Weights made under inference_mode have no version counter: they
    pack, and the pack is cached by identity."""
    with torch.inference_mode():
        w = ff.FieldWeights(*(t.clone() for t in _sentinel_weights()))
    assert all(t.is_inference() for t in w)
    first = ff.chain_weights(w)
    assert ff.chain_weights(w) is first
    torch.testing.assert_close(first, ff.pack_chain_weights(_sentinel_weights()), rtol=0, atol=0)
    assert ff.chain_weights(w._replace(amb_w2=w.amb_w2.clone())) is not first
