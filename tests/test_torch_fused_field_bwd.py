"""The port's fused-field backward (plain version on the CPU), its autograd
wrapper, the differentiable weight folding and trunc_exp's backward vs the
JAX package: `_fused_backward` and `fused_field_train` in Pallas interpret
mode (N <= 64, one or two tiles), `weights_from_params_jnp` and
`trunc_exp` under jax.grad. The CUDA backward kernel is compared with the
plain version on the card by tests/test_torch_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genefaceplusplus_tpu.models.radnerf import RADNeRF as JRADNeRF
from genefaceplusplus_tpu.models.radnerf import RADNeRFConfig as JConfig
from genefaceplusplus_tpu.ops.trunc_exp import trunc_exp as j_trunc_exp
from genefaceplusplus_tpu.ops.pallas import fused_field as JF
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF as TRADNeRF
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRFConfig as TConfig
from genefaceplusplus_tpu_torch.ops import fused_field as ff
from genefaceplusplus_tpu_torch.ops.trunc_exp import trunc_exp
from genefaceplusplus_tpu_torch.utils.convert_jax import convert_flax_params

FLAGSHIP = dict(smo_win_size=3, individual_embedding_num=8)


def _weights(seed):
    """Random FieldWeights in both packages (identical values): scaled so
    the Fourier phases, ReLUs and the tanh all see realistic ranges."""
    rs = np.random.RandomState(seed)
    r = lambda *s: (rs.randn(*s) * 0.1).astype(np.float32)
    pos_B = r(8, 128)
    pos_B[3:] = 0.0
    pos_B[:3] *= 30.0
    amb_B = r(128, 64)
    amb_B[3:] = 0.0
    amb_B[:3] *= 30.0
    mats = dict(pos_B=pos_B, amb_w1=r(384, 128), amb_w2=r(128, 128), amb_w3=r(128, 128) * 5,
                amb_B=amb_B, sig_w1=r(384, 128), sig_w2=r(128, 128), sig_w3=r(128, 256),
                col_w1=r(256, 128), col_w2=r(128, 128))
    wj = JF.FieldWeights(**{k: jnp.asarray(v, jnp.float32 if k in ("pos_B", "amb_B") else jnp.bfloat16)
                            for k, v in mats.items()})
    wt = ff.FieldWeights(**{k: torch.from_numpy(np.array(getattr(wj, k).astype(jnp.float32)))
                            .to(ff.FIELD_SHAPES[k][1]) for k in mats})
    return wj, wt


def _points(n, seed):
    rs = np.random.RandomState(seed)
    xyz = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return xyz, d, rs


def _close_grad(a, b, name, min_cos, max_rel):
    """a (port) vs b (JAX): cosine >= min_cos, norm ratio within
    (1 - min_cos) + max_rel of 1, and max |a - b| <= max_rel * max |b|."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    assert a.shape == b.shape, name
    nb = np.linalg.norm(b)
    if nb == 0.0:
        assert np.abs(a).max() == 0.0, f"{name}: JAX gradient is zero, port's is not"
        return
    cos = float(a @ b) / max(np.linalg.norm(a) * nb, 1e-300)
    assert cos >= min_cos, f"{name}: cosine {cos}"
    assert abs(np.linalg.norm(a) / nb - 1.0) <= 1.0 - min_cos + max_rel, f"{name}: norm ratio"
    rel = np.abs(a - b).max() / np.abs(b).max()
    assert rel <= max_rel, f"{name}: max |d| / max {rel}"


@pytest.mark.parametrize("n,tile", [(40, 32), (64, 64)])
def test_backward_plain_matches_pallas_interpret(n, tile):
    """All 14 gradient blocks. Both are the same bf16-in / f32-sum chain
    with the same rounding points; only float32 summation order differs,
    which can flip the bf16 rounding of one point's intermediate gradient:
    a step of 2^-8 (3.9e-3) in that point's share, and with <= 64 points one
    point can carry most of an entry. Bounds: cosine >= 0.9999 and max |d|
    <= 1e-2 of the block's largest entry (measured here: 2e-3 at most)."""
    wj, wt = _weights(0)
    xyz, d, rs = _points(n, 1)
    cond = (rs.randn(1, 64) * 0.5).astype(np.float32)
    ind = (rs.randn(4) * 0.5).astype(np.float32)
    gs, gr, ga = (rs.randn(n).astype(np.float32), rs.randn(n, 3).astype(np.float32),
                  rs.randn(n, 3).astype(np.float32))
    ab, cb = ff.bias_rows(torch.from_numpy(cond), torch.from_numpy(ind), wt)
    g_t = ff.fused_field_backward(torch.from_numpy(xyz), torch.from_numpy(d), ab, cb, wt,
                                  torch.from_numpy(gs), torch.from_numpy(gr), torch.from_numpy(ga))

    n_pad = -(-n // tile) * tile

    def pad(a, w):
        out = np.zeros((n_pad, w), np.float32)
        out[:n, : a.shape[1]] = a
        return jnp.asarray(out)

    gout = np.zeros((n_pad, 128), np.float32)
    gout[:n, 0], gout[:n, 1:4], gout[:n, 4:7] = gs, gr, ga
    mats = (wj.pos_B, wj.amb_w1[:256], wj.amb_w2, wj.amb_w3, wj.amb_B, wj.sig_w1[:256],
            wj.sig_w1[256:384], wj.sig_w2, wj.sig_w3, wj.col_w1[:16], wj.col_w1[16:144], wj.col_w2)
    g_j = JF._fused_backward(pad(xyz, 8), pad(d, 8), jnp.asarray(ab.numpy()[None]),
                             jnp.asarray(cb.numpy()[None]), mats, jnp.asarray(gout), 3, tile, True)
    assert len(g_t) == len(g_j) == len(ff.GRAD_BLOCKS) == 14
    for (name, shape, _), a, b in zip(ff.GRAD_BLOCKS, g_t, g_j):
        assert tuple(a.shape) == tuple(b.shape) == shape, name
        _close_grad(a.numpy(), b, name, min_cos=0.9999, max_rel=1e-2)


@pytest.mark.parametrize("ind_dim", [4, 0])
def test_fused_field_train_autograd_matches_jax_grad(ind_dim):
    """torch autograd through fused_field_train (CPU: plain forward and
    backward) vs jax.grad of fused_field_train(interpret=True): cond, ind and
    every FieldWeights field. The MLP matrix grads are bf16 in both (the
    VJP casts to each weight's dtype), so they agree to a bf16 step:
    cosine >= 0.9999, max |d| <= 1e-2 of the largest entry."""
    n, amb_dim = 48, 3
    wj, wt = _weights(2)
    xyz, d, rs = _points(n, 3)
    cond = (rs.randn(1, 64) * 0.5).astype(np.float32)
    ind = (rs.randn(ind_dim) * 0.5).astype(np.float32)
    coefs = (rs.randn(n).astype(np.float32), rs.randn(n, 3).astype(np.float32),
             rs.randn(n, amb_dim).astype(np.float32))

    def loss_j(cond, ind, w):
        s, c, a = JF.fused_field_train(jnp.asarray(xyz), jnp.asarray(d), cond, ind, w,
                                       amb_dim=amb_dim, tile=32, interpret=True)
        return jnp.sum(s * coefs[0]) + jnp.sum(c * coefs[1]) + jnp.sum(a * coefs[2])

    g_j = jax.grad(loss_j, argnums=(0, 1, 2))(jnp.asarray(cond), jnp.asarray(ind), wj)

    cond_t = torch.from_numpy(cond).requires_grad_()
    ind_t = torch.from_numpy(ind).requires_grad_()
    w_t = ff.FieldWeights(*[t.clone().requires_grad_() for t in wt])
    xyz_t = torch.from_numpy(xyz).requires_grad_()
    s, c, a = ff.fused_field_train(xyz_t, torch.from_numpy(d), cond_t, ind_t, w_t, amb_dim=amb_dim)
    loss = (s * torch.from_numpy(coefs[0])).sum() + (c * torch.from_numpy(coefs[1])).sum() \
        + (a * torch.from_numpy(coefs[2])).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss), float(loss_j(jnp.asarray(cond), jnp.asarray(ind), wj)),
                               rtol=1e-4)

    _close_grad(cond_t.grad.numpy(), g_j[0], "cond_feat", 0.9999, 1e-2)
    if ind_dim:
        _close_grad(ind_t.grad.numpy(), g_j[1], "ind_code", 0.9999, 1e-2)
    else:
        assert ind_t.grad is None or float(ind_t.grad.abs().sum()) == 0.0
    for name, a_t, b_j in zip(wt._fields, w_t, g_j[2]):
        assert a_t.grad.dtype == a_t.dtype, name  # each weight's own dtype, as the JAX VJP
        assert str(b_j.dtype) == str(a_t.dtype).replace("torch.", ""), name
        _close_grad(a_t.grad.float().numpy(), np.asarray(b_j.astype(jnp.float32)), name, 0.9999, 1e-2)
    # xyz and dirs come from the marcher: no gradient (JAX returns zeros)
    assert xyz_t.grad is None or float(xyz_t.grad.abs().sum()) == 0.0


def test_differentiable_folding_grads_match_jax():
    """FieldWeights cotangents through weights_from_params(differentiable)
    reach the flax parameters as they do through weights_from_params_jnp:
    transposes, padding, 2pi/bound factors and the bf16 casts. f32 math on
    both sides: atol 1e-5 relative to each gradient's largest entry."""
    jm = JRADNeRF(JConfig(**FLAGSHIP, bound=1.5))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((8, 3)), jnp.ones((8, 3)),
                     jnp.zeros((3, 1, 204)))
    tm = TRADNeRF(TConfig(**FLAGSHIP, bound=1.5))
    tm.load_state_dict(convert_flax_params(jax.tree.map(np.asarray, params), tm))
    rs = np.random.RandomState(4)
    coefs = {k: rs.randn(*s).astype(np.float32) for k, (s, _) in ff.FIELD_SHAPES.items()}

    def loss_j(p):
        w = JF.weights_from_params_jnp(p, jm.cfg, bound=1.5)
        return sum(jnp.sum(getattr(w, k).astype(jnp.float32) * coefs[k]) for k in coefs)

    g_j = convert_flax_params(jax.tree.map(np.asarray, jax.jit(jax.grad(loss_j))(params)), tm)
    w_t = ff.weights_from_params(tm, bound=1.5, differentiable=True)
    sum((getattr(w_t, k).float() * torch.from_numpy(coefs[k])).sum() for k in coefs).backward()
    folded = ("position_embedder.B", "ambient_embedder.B", "ambient_net", "sigma_net", "color_net")
    checked = 0
    for name, p in tm.named_parameters():
        if not name.startswith(folded):
            assert p.grad is None, name  # the fold touches the field only
            continue
        ref = g_j[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=1e-5 * max(np.abs(ref).max(), 1e-6), err_msg=name)
        checked += 1
    assert checked == 2 + 8  # both Bs and the 8 (bias-free) dense layers
    # without `differentiable` the fold stays outside the graph, as before
    assert not ff.weights_from_params(tm).amb_w1.requires_grad


def test_trunc_exp_backward_matches_jax():
    """Forward exp(x); backward g * exp(clip(x, -15, 15)): at +-20 it
    differs from exp's own derivative by e^5."""
    x = np.asarray([-20.0, -15.5, -3.0, 0.0, 2.5, 15.5, 20.0], np.float32)
    g_j = np.asarray(jax.grad(lambda v: jnp.sum(j_trunc_exp(v)))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    y = trunc_exp(xt)
    y.sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.exp(x.astype(np.float64)), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), g_j, rtol=1e-6)
    assert abs(float(xt.grad[-1]) - np.exp(15.0)) < 1e-6 * np.exp(15.0)
    assert float(xt.grad[-1]) < np.exp(20.0) / 100.0  # plain exp's derivative would be e^20


def test_backward_routes_cpu_to_plain_and_refuses_other_devices():
    wj, wt = _weights(5)
    xyz, d, rs = _points(16, 6)
    ab, cb = ff.bias_rows(torch.zeros(1, 64), None, wt)
    gs, gr, ga = torch.ones(16), torch.ones(16, 3), torch.ones(16, 3)
    before = ff.fused_field_backward.launches
    out = ff.fused_field_backward(torch.from_numpy(xyz), torch.from_numpy(d), ab, cb, wt, gs, gr, ga)
    ref = ff.fused_field_backward_plain(torch.from_numpy(xyz), torch.from_numpy(d), ab, cb, wt, gs, gr, ga)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert ff.fused_field_backward.launches == before  # the plain path launches nothing
    meta = torch.empty((16, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ff.fused_field_backward(meta, meta, ab, cb, wt, gs, gr, ga)
