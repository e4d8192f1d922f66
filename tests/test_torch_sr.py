"""The super-resolution stage of the port vs the JAX package: bias_act,
upfirdn2d, conv2d_resample (the folded-FIR subpixel path, its lhs-dilation
fallback and the two-pass generic path), FullyConnectedLayer,
modulated_conv2d, SynthesisLayer with const noise at an offset, and
Superresolution, on the same numpy-seeded inputs and the same weights
through the bridge (`utils/convert_jax.py`), on the CPU.

Tolerances: atol 1e-4 for every float32 module (float summation order
only); bf16 modules at the bar JAX's own bf16 SR is held to against its
float32 SR (tests/test_superresolution.py: PSNR > 35 dB)."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genefaceplusplus_tpu.models import superresolution as jsr
from genefaceplusplus_tpu.ops import bias_act as jba
from genefaceplusplus_tpu.ops import upfirdn2d as jup
from genefaceplusplus_tpu_torch.models import superresolution as tsr
from genefaceplusplus_tpu_torch.ops import bias_act as tba
from genefaceplusplus_tpu_torch.ops import upfirdn2d as tup
from genefaceplusplus_tpu_torch.utils.convert_jax import convert_flax_params

ATOL = 1e-4
MIN_BF16_PSNR = 35.0


def _nchw(a):  # numpy NHWC -> torch NCHW
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):  # torch NCHW -> numpy NHWC
    return t.float().permute(0, 2, 3, 1).numpy()


def _hwio_to_oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1)))


def _psnr(a, ref):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(ref, np.float64)) ** 2))
    return np.inf if mse == 0 else 10 * np.log10(max(np.ptp(ref), 1e-9) ** 2 / mse)


def _with_noise(variables, strength=0.3):
    """flax SR variables with every noise_strength non-zero (it initialises
    to 0, which would leave the noise path and its offset untested)."""
    flat = flax.traverse_util.flatten_dict(variables)
    for i, k in enumerate(sorted(flat)):
        if k[-1] == "noise_strength":
            flat[k] = jnp.asarray(strength + 0.05 * i, jnp.float32)
    return flax.traverse_util.unflatten_dict(flat)


@pytest.mark.parametrize("act", ["linear", "relu", "lrelu", "tanh", "sigmoid"])
@pytest.mark.parametrize("clamp", [None, 0.7])
def test_bias_act_matches_jax(act, clamp):
    rs = np.random.RandomState(0)
    x = rs.randn(2, 5, 4, 6).astype(np.float32)
    b = rs.randn(6).astype(np.float32)
    ref = np.asarray(jba.bias_act(jnp.asarray(x), jnp.asarray(b), act=act, clamp=clamp))
    got = tba.bias_act(_nchw(x), torch.from_numpy(b), act=act, clamp=clamp)
    np.testing.assert_allclose(_nhwc(got), ref, atol=1e-6, rtol=1e-6)
    ref = np.asarray(jba.bias_act(jnp.asarray(x), None, act=act, gain=0.5))
    got = tba.bias_act(torch.from_numpy(x), None, act=act, gain=0.5, dim=-1)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-6)


# (up, down, padding (px0, px1, py0, py1), flip_filter): up 1 and 2, down 2,
# asymmetric and negative padding, both flips
UPFIRDN_CASES = [
    (1, 1, (1, 2, 0, 3), False),
    (2, 1, (2, 1, 2, 1), False),
    (2, 1, (1, 3, 2, 0), True),
    (1, 2, (1, 1, 2, 1), False),
    (2, 2, (3, 0, 1, 2), True),
    (2, 1, (-1, 2, 0, -2), False),
]


@pytest.mark.parametrize("up,down,padding,flip", UPFIRDN_CASES)
def test_upfirdn2d_matches_jax(up, down, padding, flip):
    rs = np.random.RandomState(up * 10 + down)
    x = rs.randn(2, 9, 11, 3).astype(np.float32)
    f = rs.rand(3, 4).astype(np.float32)  # asymmetric, so the flips matter
    ref = np.asarray(jup.upfirdn2d(jnp.asarray(x), f, up=up, down=down, padding=padding,
                                   gain=1.5, flip_filter=flip))
    got = _nhwc(tup.upfirdn2d(_nchw(x), f, up=up, down=down, padding=padding, gain=1.5,
                              flip_filter=flip))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_up_and_downsample2d_match_jax():
    x = np.random.RandomState(1).randn(1, 8, 10, 2).astype(np.float32)
    f = tup.setup_filter([1, 3, 3, 1])
    np.testing.assert_array_equal(f, jup.setup_filter([1, 3, 3, 1]))
    for jfn, tfn in ((jup.upsample2d, tup.upsample2d), (jup.downsample2d, tup.downsample2d)):
        ref = np.asarray(jfn(jnp.asarray(x), f))
        got = _nhwc(tfn(_nchw(x), f))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=ATOL)


def _generic_up_conv(x, w, f, up, padding, flip_weight):
    """The two-pass formulation in the port: upfirdn2d (zero insertion +
    FIR) then a VALID conv (x NCHW, w OIHW)."""
    fw, fh = f.shape[-1], f.shape[-2]
    px0, px1, py0, py1 = tup._parse_padding(padding)
    px0 += (fw + up - 1) // 2
    px1 += (fw - up) // 2
    py0 += (fh + up - 1) // 2
    py1 += (fh - up) // 2
    z = tup.upfirdn2d(x, f, up=up, padding=(px0, px1, py0, py1), gain=up ** 2)
    return tup.conv2d(z, w if flip_weight else torch.flip(w, dims=(2, 3)))


# (H, kernel, up, padding, flip_weight, subpixel): JAX's own subpixel cases
# plus an odd output size, which falls back to the lhs-dilation form
RESAMPLE_CASES = [
    (16, 3, 2, 1, False, True), (16, 3, 2, 1, True, True), (16, 1, 2, 0, False, True),
    (17, 3, 2, 1, False, True), (16, 3, 4, 1, False, True), (8, 5, 2, 2, True, True),
    (9, 3, 2, (1, 0, 1, 0), False, False),
]


@pytest.mark.parametrize("H,k,up,pad,flip,subpixel", RESAMPLE_CASES)
def test_conv2d_resample_up_matches_jax_and_generic(H, k, up, pad, flip, subpixel):
    rs = np.random.RandomState(H + k)
    f = tup.setup_filter([1, 3, 3, 1])
    x = rs.randn(2, H, H, 8).astype(np.float32)
    w = rs.randn(k, k, 8, 5).astype(np.float32)
    ref = np.asarray(jup.conv2d_resample(jnp.asarray(x), jnp.asarray(w), f=f, up=up, padding=pad,
                                         flip_weight=flip))
    xt, wt = _nchw(x), _hwio_to_oihw(w)
    got = _nhwc(tup.conv2d_resample(xt, wt, f=f, up=up, padding=pad, flip_weight=flip))
    generic = _nhwc(_generic_up_conv(xt, wt, f, up, pad, flip))
    assert got.shape == ref.shape == generic.shape
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_allclose(generic, ref, atol=ATOL)
    np.testing.assert_allclose(got, generic, atol=ATOL)
    # which form the folded path took
    px0, px1, py0, py1 = tup._parse_padding(pad)
    lo, hi = (4 + up - 1) // 2, (4 - up) // 2 + up - 1  # the 4-tap filter's pads, lhs-dilation form
    c = tup._fold_filter(wt, np.asarray(f)[::-1, ::-1] * up ** 2)
    y = tup._conv2d_up_subpixel(xt, c, up, py0 + lo, py1 + hi, px0 + lo, px1 + hi)
    assert (y is not None) == subpixel


def test_conv2d_resample_plain_and_down_match_jax():
    rs = np.random.RandomState(3)
    f = tup.setup_filter([1, 3, 3, 1])
    x = rs.randn(1, 12, 12, 4).astype(np.float32)
    for k, down, pad, flip in ((3, 1, 1, True), (3, 1, 1, False), (1, 1, 0, True), (3, 2, 1, False)):
        w = rs.randn(k, k, 4, 6).astype(np.float32)
        ref = np.asarray(jup.conv2d_resample(jnp.asarray(x), jnp.asarray(w), f=f if down > 1 else None,
                                             down=down, padding=pad, flip_weight=flip))
        got = _nhwc(tup.conv2d_resample(_nchw(x), _hwio_to_oihw(w), f=f if down > 1 else None,
                                        down=down, padding=pad, flip_weight=flip))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=ATOL)


def test_fully_connected_matches_jax():
    x = np.random.RandomState(4).randn(3, 16).astype(np.float32)
    jm = jsr.FullyConnectedLayer(8, activation="lrelu", lr_multiplier=0.5, bias_init=0.3)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": {"weight": v["params"]["weight"], "bias": v["params"]["bias"] + 0.2}}
    tm = tsr.FullyConnectedLayer(16, 8, activation="lrelu", lr_multiplier=0.5, bias_init=0.3)
    tm.load_state_dict(convert_flax_params(jax.tree.map(np.asarray, v), tm))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))), atol=ATOL)


@pytest.mark.parametrize("demodulate", [True, False])
@pytest.mark.parametrize("up", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_modulated_conv2d_matches_jax(demodulate, up, dtype):
    rs = np.random.RandomState(5 + up)
    x = rs.rand(2, 10, 10, 6).astype(np.float32)
    w = rs.randn(3, 3, 6, 4).astype(np.float32)
    styles = (rs.rand(2, 6) + 0.5).astype(np.float32)
    noise = rs.randn(1, 10 * up, 10 * up, 1).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    f = jsr.RESAMPLE_FILTER
    ref = np.asarray(jsr.modulated_conv2d(
        jnp.asarray(x, jdt), jnp.asarray(w), jnp.asarray(styles), noise=jnp.asarray(noise), up=up,
        padding=1, resample_filter=f, demodulate=demodulate, flip_weight=up == 1)).astype(np.float32)
    with torch.no_grad():
        got = _nhwc(tsr.modulated_conv2d(
            _nchw(x).to(tdt), _hwio_to_oihw(w), torch.from_numpy(styles), noise=_nchw(noise), up=up,
            padding=1, resample_filter=f, demodulate=demodulate, flip_weight=up == 1))
    assert got.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=1e-5)
    else:
        assert _psnr(got, ref) > MIN_BF16_PSNR


def _layer_pair(up, resolution, in_ch=5, out_ch=7, seed=0):
    jm = jsr.SynthesisLayer(out_ch, 16, resolution, up=up)
    x0 = jnp.zeros((1, resolution // up, resolution // up, in_ch))
    v = _with_noise(jm.init(jax.random.PRNGKey(seed), x0, jnp.ones((1, 16))))
    tm = tsr.SynthesisLayer(in_ch, out_ch, 16, resolution, up=up)
    tm.load_state_dict(convert_flax_params(jax.tree.map(np.asarray, v), tm))
    return jm, v, tm


@pytest.mark.parametrize("up", [1, 2])
def test_synthesis_layer_noise_at_offset_matches_jax(up):
    """Non-zero noise_strength, SR on a crop: the const noise is sliced at
    noise_offset (in the layer's output resolution), as in JAX."""
    jm, v, tm = _layer_pair(up, resolution=24)
    assert tm.noise_strength.item() != 0.0
    rs = np.random.RandomState(6)
    x = rs.randn(2, 6, 8, 5).astype(np.float32)  # a 6x8 crop of the 24/up input
    w = rs.randn(2, 16).astype(np.float32)
    off = (3 * up, 2 * up)
    ref = np.asarray(jm.apply(v, jnp.asarray(x), jnp.asarray(w), noise_offset=off))
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x), torch.from_numpy(w), noise_offset=off))
        no_noise = _nhwc(tm(_nchw(x), torch.from_numpy(w), noise_mode="none"))
    assert got.shape == ref.shape == (2, 6 * up, 8 * up, 7)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    assert np.abs(got - no_noise).max() > 1e-2  # the noise path is exercised
    with pytest.raises(ValueError, match="random"):  # a training mode, not ported
        tm(_nchw(x), torch.from_numpy(w), noise_mode="random")


def _sr_pair(R, dtype="float32", seed=1):
    jm = jsr.Superresolution(channels=3, input_resolution=R, dtype=getattr(jnp, dtype))
    v = _with_noise(jsr.Superresolution(channels=3, input_resolution=R).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, R, R, 3))))
    tm = tsr.Superresolution(3, R, dtype=getattr(torch, dtype))
    tm.load_state_dict(convert_flax_params(jax.tree.map(np.asarray, v), tm))
    return jm, v, tm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_superresolution_matches_jax(dtype):
    """Batch 2 at input 16^2, whole and on a crop at an offset."""
    jm, v, tm = _sr_pair(16, dtype)
    rgb = np.random.RandomState(7).rand(2, 16, 16, 3).astype(np.float32)
    for crop, off in ((np.s_[:, :, :], (0, 0)), (np.s_[:, 3:13, 5:11], (3, 5))):
        x = rgb[crop]
        ref = np.asarray(jm.apply(v, jnp.asarray(x), noise_offset=off))
        with torch.no_grad():
            got = tm(torch.from_numpy(x), noise_offset=off).numpy()
        assert got.shape == ref.shape == (2, 2 * x.shape[1], 2 * x.shape[2], 3)
        assert got.dtype == np.float32  # the img/skip sum stays float32
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, atol=ATOL)
        else:
            psnr = _psnr(got, ref)
            assert psnr > MIN_BF16_PSNR, psnr


def test_sr_bridge_places_every_leaf_and_carries_noise_const():
    jm, v, tm = _sr_pair(8)
    vn = jax.tree.map(np.asarray, v)
    sd = convert_flax_params(vn, tm)
    n_params, n_buffers = len(jax.tree.leaves(vn["params"])), len(jax.tree.leaves(vn["buffers"]))
    assert n_buffers == 4 and len(sd) == n_params + n_buffers == len(tm.state_dict())
    for layer in ("block0.conv0", "block0.conv1", "block1.conv0", "block1.conv1"):
        b, l = layer.split(".")
        np.testing.assert_array_equal(sd[f"{layer}.noise_const"].numpy(), vn["buffers"][b][l]["noise_const"])
        np.testing.assert_array_equal(sd[f"{layer}.weight"].numpy(),
                                      vn["params"][b][l]["weight"].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(sd[f"{layer}.affine.weight"].numpy(),
                                      vn["params"][b][l]["affine"]["weight"])
        assert sd[f"{layer}.noise_strength"].shape == ()
    with pytest.raises(KeyError, match="noise_const"):
        convert_flax_params({"params": vn["params"]}, tm)
    with pytest.raises(KeyError, match="stray"):
        convert_flax_params(dict(vn, stray={}), tm)
