"""The torso stage of the port vs the JAX package: freq_encode,
sample_occupancy_2d, TorsoField (head-aware on and off, cond_mode lm68 and
pose), composite_head_torso, auto_torso_crop, TorsoConfig.from_hparams and
the weight bridge on the TorsoField tree, on the same numpy-seeded inputs
and weights, on the CPU. Float32 throughout: atol 1e-4."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genefaceplusplus_tpu.config import set_hparams
from genefaceplusplus_tpu.models import full_renderer as j_fr
from genefaceplusplus_tpu.models import radnerf_torso as j_torso
from genefaceplusplus_tpu.ops.freq_encoder import freq_encode as j_freq_encode
from genefaceplusplus_tpu_torch.models import full_renderer as t_fr
from genefaceplusplus_tpu_torch.models import radnerf_torso as t_torso
from genefaceplusplus_tpu_torch.models.radnerf import MAY_LM3D_RADNERF_TORSO_SR
from genefaceplusplus_tpu_torch.ops.freq_encoder import freq_encode, freq_output_dim
from genefaceplusplus_tpu_torch.utils.convert_jax import convert_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
N = 300  # pixels


@pytest.mark.parametrize("degree", [4, 10])
def test_freq_encode_matches_jax(degree):
    x = np.random.RandomState(degree).uniform(-1, 1, (50, 3)).astype(np.float32)
    ref = np.asarray(j_freq_encode(jnp.asarray(x), degree=degree))
    got = freq_encode(torch.from_numpy(x), degree=degree).numpy()
    assert got.shape == ref.shape == (50, freq_output_dim(3, degree))
    np.testing.assert_array_equal(got[:, :3], x)  # layout [x, sin 2^0 x, cos 2^0 x, ...]
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_sample_occupancy_2d_matches_jax():
    """Corners (coord0 indexes rows of the grid) and random coordinates,
    some outside [-1, 1]."""
    G = 8
    grid = np.zeros((G, G), np.float32)
    grid[0, 0], grid[G - 1, G - 1], grid[0, G - 1] = 1.0, 2.0, 3.0
    corners = np.asarray([[-1, -1], [1, 1], [-1, 1], [1, -1], [0, 0]], np.float32)
    got = t_torso.sample_occupancy_2d(torch.from_numpy(grid), torch.from_numpy(corners)).numpy()
    np.testing.assert_allclose(got, [1.0, 2.0, 3.0, 0.0, 0.0], atol=1e-6)
    rs = np.random.RandomState(1)
    grid = rs.rand(16, 16).astype(np.float32)
    coords = rs.uniform(-1.1, 1.1, (400, 2)).astype(np.float32)
    ref = np.asarray(j_torso.sample_occupancy_2d(jnp.asarray(grid), jnp.asarray(coords)))
    got = t_torso.sample_occupancy_2d(torch.from_numpy(grid), torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def _torso_pair(cfg_kw, seed=0):
    jc = j_torso.TorsoConfig(**cfg_kw)
    tc = t_torso.TorsoConfig(**cfg_kw)
    jm, tm = j_torso.TorsoField(jc), t_torso.TorsoField(tc)
    cond = jnp.zeros((1, 68, 2)) if jc.cond_mode == "lm68" else jnp.zeros((1, 6))
    v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((8, 2)), cond, jnp.zeros(jc.torso_individual_embedding_dim),
                jnp.zeros((8, 3)), jnp.zeros((8, 1)))
    tm.load_state_dict(convert_flax_params(jax.tree.map(np.asarray, v), tm))
    return jm, v, tm


@pytest.mark.parametrize("head_aware", [True, False])
@pytest.mark.parametrize("cond_mode", ["lm68", "pose"])
def test_torso_field_matches_jax(head_aware, cond_mode):
    kw = dict(torso_individual_embedding_num=16, torso_head_aware=head_aware, cond_mode=cond_mode)
    jm, v, tm = _torso_pair(kw)
    rs = np.random.RandomState(2)
    x = rs.uniform(-1, 1, (N, 2)).astype(np.float32)
    cond = (rs.rand(1, 68, 2) if cond_mode == "lm68" else rs.randn(1, 6) * 0.3).astype(np.float32)
    head_rgb, head_ws = rs.rand(N, 3).astype(np.float32), rs.rand(N, 1).astype(np.float32)
    for index in (3, 40):  # 40 clamps to the last code, as JAX's gather does
        ind_j = jm.apply(v, index, method=j_torso.TorsoField.get_individual_code)
        ind_t = tm.get_individual_code(index)
        np.testing.assert_array_equal(ind_t.detach().numpy(), np.asarray(ind_j))
    ref = jm.apply(v, jnp.asarray(x), jnp.asarray(cond), ind_j, jnp.asarray(head_rgb), jnp.asarray(head_ws))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(cond), ind_t, torch.from_numpy(head_rgb),
                 torch.from_numpy(head_ws))
    for name in ("alpha", "color", "deform"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=ATOL, err_msg=name)
    assert got.alpha.shape == (N, 1) and got.color.shape == (N, 3)
    if head_aware:  # without the head's inputs the head-aware branch sees zeros
        ref0 = jm.apply(v, jnp.asarray(x), jnp.asarray(cond), ind_j)
        with torch.no_grad():
            got0 = tm(torch.from_numpy(x), torch.from_numpy(cond), ind_t)
        np.testing.assert_allclose(got0.alpha.numpy(), np.asarray(ref0.alpha), atol=ATOL)
        assert not np.allclose(got0.alpha.numpy(), got.alpha.numpy())


def test_composite_head_torso_matches_jax():
    rs = np.random.RandomState(3)
    head, ws = rs.rand(N, 3).astype(np.float32) * 0.5, rs.rand(N).astype(np.float32)
    ta, tc, bg = rs.rand(N, 1).astype(np.float32), rs.rand(N, 3).astype(np.float32), rs.rand(N, 3).astype(np.float32)
    ref = j_torso.composite_head_torso(*(jnp.asarray(a) for a in (head, ws, ta, tc, bg)))
    got = t_torso.composite_head_torso(*(torch.from_numpy(a) for a in (head, ws, ta, tc, bg)))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("H,W,rect", [(64, 64, (11, 15, 6, 10)), (48, 80, (0, 4, 0, 16)),
                                      (64, 64, (0, 16, 0, 16)), (32, 32, None)])
def test_auto_torso_crop_matches_jax(H, W, rect):
    """Rects inside, at the edge and over all of the grid; an empty grid."""
    occ2d = np.zeros((16, 16), np.float32)
    if rect is not None:
        r0, r1, c0, c1 = rect
        occ2d[r0:r1, c0:c1] = 0.5
    for kw in ({}, {"pad_px": 2, "multiple": 4}, {"thr": 0.6}):
        ref = j_fr.auto_torso_crop(jnp.asarray(occ2d), H, W, **kw)
        assert t_fr.auto_torso_crop(torch.from_numpy(occ2d), H, W, **kw) == ref


def test_torso_config_matches_the_torso_sr_yaml():
    hp = set_hparams(config=os.path.join(REPO, "egs/datasets/May/lm3d_radnerf_torso_sr.yaml"))
    for k, v in MAY_LM3D_RADNERF_TORSO_SR.items():
        assert hp[k] == v, k
    ref = j_torso.TorsoConfig.from_hparams(hp)
    got = t_torso.TorsoConfig.from_hparams(MAY_LM3D_RADNERF_TORSO_SR)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.cond_mode == "lm68" and got.torso_head_aware and got.torso_individual_embedding_dim == 8
    assert dataclasses.asdict(t_torso.TorsoConfig.from_hparams({"with_sr": False})) == \
        dataclasses.asdict(j_torso.TorsoConfig.from_hparams({"with_sr": False}))


def test_torso_bridge_places_every_leaf_and_fails_loudly():
    jm, v, tm = _torso_pair(dict(torso_individual_embedding_num=16))
    vn = jax.tree.map(np.asarray, v)
    sd = convert_flax_params(vn, tm)
    assert len(sd) == len(jax.tree.leaves(vn)) == len(tm.state_dict())
    p = vn["params"]
    np.testing.assert_array_equal(sd["torso_canonicial_net.dense.0.weight"].numpy(),
                                  p["torso_canonicial_net"]["Dense_0"]["kernel"].T)
    np.testing.assert_array_equal(sd["head_aware_l2.bias"].numpy(), p["head_aware_l2"]["bias"])
    np.testing.assert_array_equal(sd["torso_embedder.B"].numpy(), p["torso_embedder"]["B"])
    missing = {"params": {k: w for k, w in p.items() if k != "head_aware_l3"}}
    with pytest.raises(KeyError, match="head_aware_l3"):
        convert_flax_params(missing, tm)
    bad = {"params": dict(p, torso_individual_codes=np.zeros((3, 8), np.float32))}
    with pytest.raises(ValueError, match="torso_individual_codes"):
        convert_flax_params(bad, tm)


def test_tiledgrid_raises_with_roadmap_pointer():
    """A tiledgrid torso builds (served, tests/test_torch_grid_field.py),
    and the torso task, which once raised for it naming its ROADMAP item
    (queue A item 3, done), builds it for training: its table trains in
    the grid group at 10x the learning rate (tests/test_torch_grid_train.py
    holds the step to JAX's)."""
    from genefaceplusplus_tpu_torch.models.radnerf import RADNeRFConfig
    from genefaceplusplus_tpu_torch.training.tasks.torso_task import TorsoNeRFTask

    assert t_torso.TorsoField(t_torso.TorsoConfig(grid_type="tiledgrid")).torso_embedder.output_dim == 32
    state = TorsoNeRFTask(None, RADNeRFConfig(grid_size=16), {"grid_type": "tiledgrid"}, device="cpu").create_state()
    grid = [g for g in state.opt.opt.param_groups if g["label"] == "grid"]
    assert len(grid) == 1 and grid[0]["mult"] == 10.0
    assert len(grid[0]["params"]) == 1 and grid[0]["params"][0] is state.model.torso_embedder.embeddings
