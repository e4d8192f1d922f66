"""The audio-to-motion model of the port vs the JAX package: f0_to_coarse
(bins exactly equal), WN, the coupling flow (forward, inverse, and
inverse o forward = identity), the FVAE's inference (JAX's own noise, and
temperature 0) and train-mode forward (JAX's encoder noise) in each branch
(prior flow on/off, sqz_prior, the 71-channel decoders),
PitchContourVAEModel and VAEModel in both modes, the ConvTranspose flip,
and the weight bridge on the a2m tree at full width, on the same
numpy-seeded inputs and weights, on the CPU.

Weights: flax's init, then every zero-initialised `post` conv and every
BatchNorm's running statistics set to seeded non-trivial values (at init
the prior flow is the identity and the statistics 0 and 1, which would
test neither). Float32 throughout: atol 1e-4 (measured below 2e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genefaceplusplus_tpu.models.audio2motion import flow as j_flow
from genefaceplusplus_tpu.models.audio2motion import fvae as j_fvae
from genefaceplusplus_tpu.models.audio2motion import vae_model as j_vae
from genefaceplusplus_tpu.models.audio2motion import wavenet as j_wn
from genefaceplusplus_tpu.utils.pitch import coarse_to_f0 as j_coarse_to_f0
from genefaceplusplus_tpu.utils.pitch import f0_to_coarse as j_f0_to_coarse
from genefaceplusplus_tpu_torch.models.audio2motion import flow as t_flow
from genefaceplusplus_tpu_torch.models.audio2motion import fvae as t_fvae
from genefaceplusplus_tpu_torch.models.audio2motion import vae_model as t_vae
from genefaceplusplus_tpu_torch.models.audio2motion import wavenet as t_wn
from genefaceplusplus_tpu_torch.utils.convert_jax import convert_flax_params
from genefaceplusplus_tpu_torch.utils.pitch import coarse_to_f0, f0_to_coarse

ATOL = 1e-4
SMALL = dict(hidden_channels=32, enc_n_layers=2, dec_n_layers=2, flow_hidden=16, flow_n_blocks=2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _seeded(variables, seed):
    """flax variables with every `post` leaf and every BatchNorm statistic
    drawn from `seed`."""
    rs = np.random.RandomState(seed)

    def fill(path, x):
        if any(getattr(k, "key", None) == "post" for k in path):
            return (rs.randn(*x.shape) * 0.1).astype(np.float32)
        return x

    out = jax.tree_util.tree_map_with_path(fill, _np(variables))
    if "batch_stats" in out:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, x: (rs.randn(*x.shape) * 0.1 if p[-1].key == "mean" else rs.uniform(0.5, 1.5, x.shape)
                          ).astype(np.float32), out["batch_stats"])
    return out


_INITS = {}


def _pair(j_model, t_model, *init_args, seed=0, **init_kw):
    """(variables, port model loaded from them); the flax init of equal
    modules is made once."""
    key = (repr(j_model), seed)
    if key not in _INITS:
        variables = jax.jit(lambda: j_model.init(jax.random.PRNGKey(seed), *init_args, **init_kw))()
        _INITS[key] = _seeded(variables, seed + 100)
    variables = dict(_INITS[key])
    t_model.load_state_dict(convert_flax_params(variables, t_model))
    return variables, t_model.eval()


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _apply(j_model, variables, *args, **kw):
    """`j_model.apply` as one compiled program (eager flax compiles each
    primitive on its own, which costs more CPU time than the test)."""
    return jax.jit(lambda v, *a: j_model.apply(v, *a, **kw))(variables, *args)


# ---------------------------------------------------------------- pitch


def test_f0_to_coarse_bins_equal_jax():
    rs = np.random.RandomState(0)
    f0 = np.concatenate([np.zeros(8), rs.uniform(0, 1500, 4000), rs.uniform(40, 60, 500),
                         np.asarray([50.0, 80.0, 750.0, 1100.0, 1200.0])]).astype(np.float32)
    ref = np.asarray(j_f0_to_coarse(jnp.asarray(f0)))
    got = f0_to_coarse(torch.from_numpy(f0)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.min() == 1 and got.max() == 255 and len(np.unique(got)) > 200


def test_coarse_to_f0_matches_jax():
    coarse = np.arange(1, 256, dtype=np.int32)
    ref = np.asarray(j_coarse_to_f0(jnp.asarray(coarse)))
    got = coarse_to_f0(torch.from_numpy(coarse.astype(np.int64))).numpy()
    assert got[0] == 0.0
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=ATOL)


# ---------------------------------------------------------------- WN, flow


@pytest.mark.parametrize("gin", [0, 8])
def test_wn_matches_jax(gin):
    rs = np.random.RandomState(gin)
    B, T, H = 2, 20, 16
    x = rs.randn(B, T, H).astype(np.float32)
    mask = np.ones((B, T, 1), np.float32)
    mask[1, 15:] = 0.0
    g = rs.randn(B, T, 8).astype(np.float32) if gin else None
    jm = j_wn.WN(H, 5, 2, 3, gin_channels=gin)
    tm = t_wn.WN(H, 5, 2, 3, gin_channels=gin)
    args = (jnp.asarray(x), jnp.asarray(mask), None if g is None else jnp.asarray(g))
    v, tm = _pair(jm, tm, *args)
    assert sorted(n for n, _ in tm.named_children()) == sorted(v["params"])  # JAX's names
    ref = np.asarray(_apply(jm, v, *args))
    with torch.no_grad():
        got = tm(_t(x), _t(mask), None if g is None else _t(g)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    assert np.abs(got[1, 15:]).max() == 0.0


@pytest.mark.parametrize("masked", [False, True])
def test_coupling_block_matches_jax_and_inverts(masked):
    rs = np.random.RandomState(3)
    B, T, C = 2, 12, 16
    x = rs.randn(B, T, C).astype(np.float32)
    g = rs.randn(B, T, 8).astype(np.float32)
    mask = np.ones((B, T, 1), np.float32)
    if masked:
        mask[0, 9:] = 0.0
    m_arg = jnp.asarray(mask) if masked else None
    jm = j_flow.ResidualCouplingBlock(C, 16, 3, 1, 2, n_flows=4, gin_channels=8)
    tm = t_flow.ResidualCouplingBlock(C, 16, 3, 1, 2, n_flows=4, gin_channels=8)
    v, tm = _pair(jm, tm, jnp.asarray(x), m_arg, g=jnp.asarray(g))
    t_mask = _t(mask) if masked else None
    with torch.no_grad():
        for reverse in (False, True):
            ref = np.asarray(_apply(jm, v, jnp.asarray(x), m_arg, g=jnp.asarray(g), reverse=reverse))
            got = tm(_t(x), t_mask, g=_t(g), reverse=reverse).numpy()
            np.testing.assert_allclose(got, ref, atol=ATOL)
            assert np.abs(got - x).max() > 1e-2  # the seeded `post` convs move the flow
        back = tm(tm(_t(x), t_mask, g=_t(g)), t_mask, g=_t(g), reverse=True).numpy()
    live = mask[..., 0] > 0  # the coupling zeroes the masked frames' shifted halves
    np.testing.assert_allclose(back[live], x[live], atol=1e-5)


# ---------------------------------------------------------------- FVAE


FVAE_VARIANTS = {
    "prior_flow": {},
    "no_prior_flow": {"use_prior_flow": False},
    "sqz_prior": {"sqz_prior": True},
    "exp_pose_71": {"in_out_channels": 71},
}


def _fvae_pair(kw):
    common = dict(hidden_channels=16, latent_size=8, kernel_size=5, enc_n_layers=2, dec_n_layers=2,
                  gin_channels=8, strides=(4,), flow_hidden=16, flow_kernel_size=3, flow_n_blocks=2)
    common.setdefault("in_out_channels", 12)
    common.update(kw)
    rs = np.random.RandomState(5)
    B, T = 2, 24
    x = rs.randn(B, T, common["in_out_channels"]).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, 20:] = 0.0
    g = rs.randn(B, T, 8).astype(np.float32)
    jm, tm = j_fvae.FVAE(**common), t_fvae.FVAE(**common)
    v, tm = _pair(jm, tm, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(g), infer=False,
                  rng=jax.random.PRNGKey(7))
    return jm, tm, v, x, mask, g, common


@pytest.mark.parametrize("variant", list(FVAE_VARIANTS))
def test_fvae_inference_matches_jax(variant):
    jm, tm, v, x, mask, g, c = _fvae_pair(FVAE_VARIANTS[variant])
    rng = jax.random.PRNGKey(11)
    T_sqz = tm.latent_length(x.shape[1])
    noise = np.asarray(jax.random.normal(rng, (2, T_sqz, c["latent_size"])))  # JAX's own draw
    run = jax.jit(lambda v_, temp: jm.apply(v_, None, jnp.asarray(mask), jnp.asarray(g), infer=True,
                                            temperature=temp, rng=rng))
    for temp in (0.7, 0.0):
        ref, ref_z = run(v, temp)
        with torch.no_grad():
            got, got_z = tm(None, _t(mask), _t(g), infer=True, temperature=temp,
                            noise=None if temp == 0.0 else noise)
        assert got.shape == ref.shape == (2, x.shape[1], c["in_out_channels"])
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
        np.testing.assert_allclose(got_z.numpy(), np.asarray(ref_z), atol=ATOL)


@pytest.mark.parametrize("variant", list(FVAE_VARIANTS))
def test_fvae_train_forward_matches_jax(variant):
    jm, tm, v, x, mask, g, c = _fvae_pair(FVAE_VARIANTS[variant])
    rng = jax.random.PRNGKey(13)
    eps = np.asarray(jax.random.normal(rng, (2, tm.latent_length(x.shape[1]), c["latent_size"])))
    ref = _apply(jm, v, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(g), infer=False, rng=rng)
    with torch.no_grad():
        got = tm(_t(x), _t(mask), _t(g), infer=False, noise=eps)
    for name, a, b in zip(("x_recon", "loss_kl", "z_p", "m_q", "logs_q"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, err_msg=name)


def test_fvae_draws_from_a_generator_and_checks_noise():
    jm, tm, v, x, mask, g, c = _fvae_pair({})
    with torch.no_grad():
        a, _ = tm(None, _t(mask), _t(g), infer=True, temperature=1.0, generator=torch.Generator().manual_seed(3))
        b, _ = tm(None, _t(mask), _t(g), infer=True, temperature=1.0, generator=torch.Generator().manual_seed(3))
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        with pytest.raises(ValueError, match="`noise` or a torch.Generator"):
            tm(None, _t(mask), _t(g), infer=True, temperature=1.0)
        with pytest.raises(ValueError, match="noise of shape"):
            tm(None, _t(mask), _t(g), infer=True, noise=torch.zeros(2, 3, c["latent_size"]))


def test_conv_transpose_flip_matches_flax():
    """flax's ConvTranspose (kernel [k, in, out]) does not flip its kernel;
    torch's ConvTranspose1d (weight [in, out, k]) does: the bridge flips."""
    import flax.linen as fnn

    rs = np.random.RandomState(0)
    x = rs.randn(2, 5, 4).astype(np.float32)
    jm = fnn.ConvTranspose(3, kernel_size=(4,), strides=(4,), padding="VALID")
    v = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v["params"]["bias"] = rs.randn(3).astype(np.float32)
    ref = np.asarray(_apply(jm, v, jnp.asarray(x)))

    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.deconvs = torch.nn.ModuleList([t_wn.ConvTranspose1d(4, 3, 4)])

    tm = Holder()
    tm.load_state_dict(convert_flax_params({"params": {"ConvTranspose_0": v["params"]}}, tm))
    with torch.no_grad():
        got = t_wn.channels_first(tm.deconvs[0](t_wn.channels_first(_t(x)))).numpy()
    assert got.shape == ref.shape == (2, 20, 3)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    unflipped = np.asarray(v["params"]["kernel"]).transpose(1, 2, 0)
    with torch.no_grad():
        tm.deconvs[0].weight.copy_(torch.from_numpy(unflipped.copy()))
        wrong = t_wn.channels_first(tm.deconvs[0](t_wn.channels_first(_t(x)))).numpy()
    assert np.abs(wrong - ref).max() > 0.1


# ---------------------------------------------------------------- a2m models


def _a2m_batch(audio_in_dim, in_out_dim, T=24, seed=0):
    rs = np.random.RandomState(seed)
    return {
        "audio": rs.randn(1, 2 * T, audio_in_dim).astype(np.float32),
        "f0": (np.abs(rs.randn(1, 2 * T)) * 100 + 80).astype(np.float32),
        "y_mask": np.ones((1, T), np.float32),
        "y": rs.randn(1, T, in_out_dim).astype(np.float32),
        "mouth_amp": np.full((1, 1), 0.3, np.float32),
        "blink": (rs.rand(1, 2 * T, 1) > 0.7).astype(np.int32),
    }


def _a2m_pair(pitch: bool, in_out_dim: int):
    kw = dict(SMALL, in_out_dim=in_out_dim, audio_in_dim=64)
    batch = _a2m_batch(64, in_out_dim)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = j_vae.PitchContourVAEModel(**kw) if pitch else j_vae.VAEModel(**kw)
    tm = t_vae.PitchContourVAEModel(**kw) if pitch else t_vae.VAEModel(**kw)
    v, tm = _pair(jm, tm, jbatch, train=True, rng=jax.random.PRNGKey(1))
    tbatch = {k: torch.from_numpy(v_) for k, v_ in batch.items()}
    return jm, tm, v, jbatch, tbatch


@pytest.mark.parametrize("pitch, in_out_dim", [(True, 64), (True, 204), (False, 64)],
                         ids=["pitch-exp", "pitch-idexp_lm3d", "hubert_only-exp"])
def test_a2m_inference_matches_jax(pitch, in_out_dim):
    jm, tm, v, jbatch, tbatch = _a2m_pair(pitch, in_out_dim)
    rng = jax.random.PRNGKey(42)
    noise = np.asarray(jax.random.normal(rng, (1, tm.vae.latent_length(24), 16)))
    run = jax.jit(lambda v_, temp: jm.apply(v_, jbatch, train=False, temperature=temp, rng=rng))
    for temp in (0.2, 0.0):
        ref, aux = run(v, temp)
        with torch.no_grad():
            got, taux = tm(tbatch, train=False, temperature=temp, noise=None if temp == 0.0 else noise)
        assert got.shape == (1, 24, in_out_dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
        np.testing.assert_allclose(taux["z_p"].numpy(), np.asarray(aux["z_p"]), atol=ATOL)


@pytest.mark.parametrize("pitch", [True, False], ids=["pitch", "hubert_only"])
def test_a2m_train_forward_matches_jax(pitch):
    """Train mode: BatchNorm on the batch's statistics, the encoder's eps
    injected from JAX's draw."""
    jm, tm, v, jbatch, tbatch = _a2m_pair(pitch, 64)
    rng = jax.random.PRNGKey(8)
    (ref, aux), _ = _apply(jm, v, jbatch, train=True, rng=rng, mutable=["batch_stats"])
    eps = np.asarray(jax.random.normal(rng, (1, tm.vae.latent_length(24), 16)))
    with torch.no_grad():
        got, taux = tm(tbatch, train=True, noise=eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    for k in ("loss_kl", "z_p", "m_q", "logs_q"):
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(aux[k]), atol=ATOL, err_msg=k)


def test_full_width_a2m_converts_every_leaf():
    """The May audio2motion model at full width (what GeneFaceInfer builds
    from egs/datasets/May/audio2motion_vae.yaml): 11,840,768 variables with
    batch_stats, every flax leaf placed on the port's model."""
    hp = {"use_pitch": True, "audio_in_dim": 1024, "motion_type": "exp"}
    tm = t_vae.a2m_model_from_hparams(hp, generator=torch.Generator().manual_seed(0))
    assert isinstance(tm, t_vae.PitchContourVAEModel)
    jm = j_vae.PitchContourVAEModel(in_out_dim=64, audio_in_dim=1024, use_mouth_amp_embed=True)
    batch = {"audio": jnp.zeros((1, 16, 1024)), "f0": jnp.zeros((1, 16)), "y_mask": jnp.ones((1, 8)),
             "y": jnp.zeros((1, 8, 64))}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), batch, train=True, rng=jax.random.PRNGKey(1)))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert n_jax == 11_840_768
    sd = convert_flax_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes), tm)
    assert sum(t.numel() for k, t in sd.items() if not k.endswith("num_batches_tracked")) == n_jax
    assert set(sd) == set(tm.state_dict())


def test_bridge_refuses_an_incomplete_a2m_tree():
    jm, tm, v, _, _ = _a2m_pair(True, 64)
    del v["batch_stats"]
    with pytest.raises(KeyError, match="running_mean"):
        convert_flax_params(v, tm)
