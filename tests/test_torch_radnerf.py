"""Port RADNeRF and condition encoders vs the JAX modules, with the same
weights (converted flax params) and the same numpy inputs, on the CPU.

Tolerance: atol 1e-4 in float32 (ROADMAP's cross-backend precedent).
bf16 activations: the bf16 bounds stated in `test_bf16_field_matches_jax`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genefaceplusplus_tpu.models import cond_encoder as j_ce
from genefaceplusplus_tpu.models.radnerf import RADNeRF as JRADNeRF
from genefaceplusplus_tpu.models.radnerf import RADNeRFConfig as JConfig
from genefaceplusplus_tpu_torch.models import cond_encoder as t_ce
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF as TRADNeRF
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRFConfig as TConfig
from genefaceplusplus_tpu_torch.utils.convert_jax import convert_flax_params

ATOL = 1e-4
SMALL = dict(smo_win_size=5, individual_embedding_num=8, fourier_pos_features=16,
             fourier_amb_features=8, hidden_dim_ambient=32, hidden_dim_sigma=32,
             hidden_dim_color=32, geo_feat_dim=16)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(a_jax, a_torch, atol=ATOL):
    a_torch = a_torch.detach().numpy() if isinstance(a_torch, torch.Tensor) else a_torch
    np.testing.assert_allclose(a_torch, np.asarray(a_jax), atol=atol, rtol=0)


def _pair(**kw):
    jm = JRADNeRF(JConfig(**kw))
    c = jm.cfg
    cond = jnp.zeros((c.smo_win_size, c.cond_win_size, c.cond_in_dim))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((8, 3)), jnp.ones((8, 3)), cond)
    tm = TRADNeRF(TConfig(**kw))
    tm.load_state_dict(convert_flax_params(_np(params), tm))
    return jm, params, tm


def _inputs(c, n=256, seed=0):
    rs = np.random.RandomState(seed)
    cond = rs.randn(c.smo_win_size, c.cond_win_size, c.cond_in_dim).astype(np.float32)
    eye = np.asarray([[0.37]], np.float32)
    xyz = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return cond, eye, xyz, d


@pytest.mark.parametrize("win", [1, 5, 16])
def test_audio_net_matches_jax(win):
    jn = j_ce.AudioNet(204, 64, win_size=win)
    x = np.random.RandomState(win).randn(3, win, 204).astype(np.float32)
    params = jn.init(jax.random.PRNGKey(1), jnp.asarray(x))
    tn = t_ce.AudioNet(204, 64, win_size=win)
    tn.load_state_dict(convert_flax_params(_np(params), tn))
    _close(jn.apply(params, jnp.asarray(x)), tn(torch.from_numpy(x)))


def test_audio_att_net_and_mlp_match_jax():
    ja = j_ce.AudioAttNet(64, seq_len=5)
    x = np.random.RandomState(7).randn(5, 64).astype(np.float32)
    pa = ja.init(jax.random.PRNGKey(2), jnp.asarray(x))
    ta = t_ce.AudioAttNet(64, seq_len=5)
    ta.load_state_dict(convert_flax_params(_np(pa), ta))
    _close(ja.apply(pa, jnp.asarray(x)), ta(torch.from_numpy(x)))

    jm = j_ce.MLP(7, 32, 3)
    h = np.random.RandomState(8).randn(50, 40).astype(np.float32)
    pm = jm.init(jax.random.PRNGKey(3), jnp.asarray(h))
    tmlp = t_ce.MLP(40, 7, 32, 3)
    tmlp.load_state_dict(convert_flax_params(_np(pm), tmlp))
    _close(jm.apply(pm, jnp.asarray(h)), tmlp(torch.from_numpy(h)))


def test_radnerf_cond_field_density_match_jax():
    jm, params, tm = _pair(**SMALL)
    cond, eye, xyz, d = _inputs(jm.cfg)
    cf_j = jm.apply(params, jnp.asarray(cond), jnp.asarray(eye), method=JRADNeRF.cal_cond_feat)
    with torch.no_grad():
        cf_t = tm.cal_cond_feat(torch.from_numpy(cond), torch.from_numpy(eye))
        _close(cf_j, cf_t)
        # without an eye area the blink branch sees zeros
        _close(jm.apply(params, jnp.asarray(cond), method=JRADNeRF.cal_cond_feat),
               tm.cal_cond_feat(torch.from_numpy(cond)))
        ind_j = jm.apply(params, 3, method=JRADNeRF.get_individual_code)
        ind_t = tm.get_individual_code(3)
        _close(ind_j, ind_t, atol=0)
        cf = np.asarray(cf_j)
        out_j = jm.apply(params, jnp.asarray(xyz), jnp.asarray(d), jnp.asarray(cf), ind_j,
                         method=JRADNeRF.field)
        out_t = tm.field(torch.from_numpy(xyz), torch.from_numpy(d), torch.from_numpy(cf), ind_t)
        for a, b in zip(out_j, out_t):
            _close(a, b)
        _close(jm.apply(params, jnp.asarray(xyz), jnp.asarray(cf), method=JRADNeRF.density),
               tm.density(torch.from_numpy(xyz), torch.from_numpy(cf)))


@pytest.mark.parametrize("index", [8, 100, -1, -8, -20])
@pytest.mark.parametrize("as_array", [False, True])
def test_individual_code_out_of_range_matches_jax(index, as_array):
    """Past the table (8 codes) or negative: JAX's gather wraps a negative
    index once and clamps; the port gives the same code, exactly."""
    jm, params, tm = _pair(**SMALL)
    j_idx, t_idx = (jnp.int32(index), torch.tensor(index)) if as_array else (index, index)
    ind_j = jm.apply(params, j_idx, method=JRADNeRF.get_individual_code)
    with torch.no_grad():
        _close(ind_j, tm.get_individual_code(t_idx), atol=0)


def test_radnerf_without_blink_or_attention_matches_jax():
    jm, params, tm = _pair(**{**SMALL, "add_eye_blink_cond": False, "with_att": False, "smo_win_size": 1})
    cond, _, _, _ = _inputs(jm.cfg, seed=1)
    with torch.no_grad():
        _close(jm.apply(params, jnp.asarray(cond), method=JRADNeRF.cal_cond_feat),
               tm.cal_cond_feat(torch.from_numpy(cond)))


def test_bf16_field_matches_jax():
    """field_act_dtype='bfloat16': both frameworks round each MLP layer's
    inputs, weights and outputs to bf16, but sum in different orders, so a
    rounding can flip. Bounds: log-sigma 0.05, rgb 0.01, amb 0.01 (a few bf16
    steps), and the mean rgb error below 1e-3."""
    jm, params, tm = _pair(**SMALL, field_act_dtype="bfloat16")
    cond, eye, xyz, d = _inputs(jm.cfg, seed=2)
    cf = np.asarray(jm.apply(params, jnp.asarray(cond), jnp.asarray(eye), method=JRADNeRF.cal_cond_feat))
    ind = jm.apply(params, 0, method=JRADNeRF.get_individual_code)
    s_j, rgb_j, amb_j = jm.apply(params, jnp.asarray(xyz), jnp.asarray(d), jnp.asarray(cf), ind,
                                 method=JRADNeRF.field)
    with torch.no_grad():
        s_t, rgb_t, amb_t = tm.field(torch.from_numpy(xyz), torch.from_numpy(d),
                                     torch.from_numpy(cf), torch.from_numpy(np.asarray(ind)))
    assert s_t.dtype == rgb_t.dtype == amb_t.dtype == torch.float32
    _close(np.log(np.asarray(s_j)), np.log(s_t.numpy()), atol=0.05)
    _close(rgb_j, rgb_t, atol=0.01)
    _close(amb_j, amb_t, atol=0.01)
    assert np.abs(rgb_t.numpy() - np.asarray(rgb_j)).mean() < 1e-3


def test_converter_places_every_leaf_and_fails_loudly():
    jm, params, tm = _pair(**SMALL)
    tree = _np(params)
    sd = convert_flax_params(tree, tm)
    n_leaves = len(jax.tree.leaves(params))
    assert len(sd) == n_leaves == len(tm.state_dict())
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy())

    extra = {"params": dict(tree["params"], stray={"kernel": np.zeros((2, 2), np.float32)})}
    with pytest.raises(KeyError, match="stray"):
        convert_flax_params(extra, tm)
    missing = {"params": {k: v for k, v in tree["params"].items() if k != "ambient_embedder"}}
    with pytest.raises(KeyError, match="ambient_embedder"):
        convert_flax_params(missing, tm)
    bad = {"params": dict(tree["params"], individual_embeddings=np.zeros((3, 4), np.float32))}
    with pytest.raises(ValueError, match="individual_embeddings"):
        convert_flax_params(bad, tm)


def test_grid_encoders_raise_with_roadmap_pointer():
    """A grid head builds (served, tests/test_torch_grid_field.py; trained,
    tests/test_torch_grid_train.py). Training it with the fused field
    raises, naming the Fourier-only kernel; the training of grid heads that
    this test once found refused (its ROADMAP item, queue A item 3) is
    done."""
    from genefaceplusplus_tpu_torch.training.tasks.head_task import HeadNeRFTask, HeadTaskConfig

    cfg = TConfig(grid_type="tiledgrid", desired_resolution=64, log2_hashmap_size=10)
    assert TRADNeRF(cfg).position_embedder.output_dim == 32
    with pytest.raises(ValueError, match="Fourier-only kernel"):
        HeadNeRFTask(None, cfg, HeadTaskConfig(use_fused_field=True), device="cpu")
