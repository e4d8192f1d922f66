"""Grid fields of the port (`RADNeRF` with `grid_type` 'tiledgrid' and
'hashgrid', the 'tiledgrid' `TorsoField`) against the JAX package's flax
modules, with the same weights and numpy-seeded inputs, on the CPU; and
each training task building a grid field and taking a step. The weights are a seeded port
model's, exported to JAX's tree (`export_flax_params`; the tables scaled
to +-0.2 so they move the field) and carried back into the port by
`convert_flax_params`; flax's init is skipped (it runs the 16-level grids
eagerly, ~20 s).

Small heads (desired resolution 64, tables of 2^10 rows a level, so the
hash grid hashes; narrow MLPs); the torso at the reference's spec.
Tolerances: float32 atol 1e-4 (the port's precedent); the export round
trip exact."""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genefaceplusplus_tpu.models import radnerf_torso as j_torso
from genefaceplusplus_tpu.models.radnerf import RADNeRF as JRADNeRF
from genefaceplusplus_tpu.models.radnerf import RADNeRFConfig as JConfig
from genefaceplusplus_tpu_torch.models import radnerf_torso as t_torso
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF as TRADNeRF
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRFConfig as TConfig
from genefaceplusplus_tpu_torch.data import dataset as t_data
from genefaceplusplus_tpu_torch.data.dataset import synthetic
from genefaceplusplus_tpu_torch.training import run
from genefaceplusplus_tpu_torch.training.schedulers import _radnerf_group
from genefaceplusplus_tpu_torch.training.tasks.head_task import HeadNeRFTask, HeadTaskConfig
from genefaceplusplus_tpu_torch.training.tasks.sr_task import SRHeadNeRFTask, SRTaskConfig
from genefaceplusplus_tpu_torch.training.tasks.torso_task import TorsoNeRFTask
from genefaceplusplus_tpu_torch.utils.convert_jax import convert_flax_params, export_flax_params

ATOL = 1e-4
SMALL = dict(smo_win_size=3, individual_embedding_num=8, desired_resolution=64, log2_hashmap_size=10,
             hidden_dim_ambient=32, hidden_dim_sigma=32, hidden_dim_color=32, geo_feat_dim=16)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _leaves(sub, prefix + (key,)).items()}
    return {prefix: np.asarray(tree)}


def _scaled(tree):
    """The tree with each grid table ([n_rows, 2] 'embeddings') x 2000."""
    if isinstance(tree, dict):
        return {k: v * 2000.0 if k == "embeddings" else _scaled(v) for k, v in tree.items()}
    return tree


def _close(ref, got):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("grid_type,interpolation", [("tiledgrid", "linear"), ("hashgrid", "smoothstep")])
def test_grid_head_matches_jax(grid_type, interpolation):
    kw = dict(SMALL, grid_type=grid_type, grid_interpolation_type=interpolation)
    jm, tm = JRADNeRF(JConfig(**kw)), TRADNeRF(TConfig(**kw))
    c = jm.cfg
    rs = np.random.RandomState(len(grid_type))
    cond = rs.randn(c.smo_win_size, c.cond_win_size, c.cond_in_dim).astype(np.float32)
    params = _scaled(export_flax_params(TRADNeRF(TConfig(**kw), generator=torch.Generator().manual_seed(3))))
    assert "embeddings" in params["params"]["position_embedder"]
    tm.load_state_dict(convert_flax_params(params, tm))

    xyz = rs.uniform(-1, 1, (256, 3)).astype(np.float32)
    dirs = rs.randn(256, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    eye = np.asarray([[0.3]], np.float32)
    j_feat = jm.apply(params, jnp.asarray(cond), jnp.asarray(eye), method=JRADNeRF.cal_cond_feat)
    j_out = jm.apply(params, jnp.asarray(xyz), jnp.asarray(dirs), j_feat, params["params"]["individual_embeddings"][2],
                     method=JRADNeRF.field)
    with torch.no_grad():
        t_feat = tm.cal_cond_feat(torch.from_numpy(cond), torch.from_numpy(eye))
        t_out = tm.field(torch.from_numpy(xyz), torch.from_numpy(dirs), torch.from_numpy(np.asarray(j_feat)),
                         tm.get_individual_code(2))
        t_density = tm.density(torch.from_numpy(xyz), torch.from_numpy(np.asarray(j_feat)))
    _close(j_feat, t_feat)
    for ref, got in zip(j_out, t_out):
        _close(ref, got)
    _close(j_out[0], t_density)
    assert float(np.asarray(j_out[0]).std()) > 1e-2  # the tables move sigma

    # the export round trip: the port's tensors back to JAX's tree, exactly
    back = _leaves(export_flax_params(tm))
    ref = _leaves(params)
    assert set(back) == set(ref)
    for k, a in ref.items():
        assert back[k].dtype == np.float32 and np.array_equal(back[k], a), k


def test_tiledgrid_torso_matches_jax():
    kw = dict(grid_type="tiledgrid", torso_individual_embedding_num=8)
    jm, tm = j_torso.TorsoField(j_torso.TorsoConfig(**kw)), t_torso.TorsoField(t_torso.TorsoConfig(**kw))
    rs = np.random.RandomState(5)
    n = 200
    x = rs.uniform(-1, 1, (n, 2)).astype(np.float32)
    lm = rs.uniform(-1, 1, (1, 68, 2)).astype(np.float32)
    rgb, ws = rs.rand(n, 3).astype(np.float32), rs.rand(n, 1).astype(np.float32)
    params = _scaled(export_flax_params(t_torso.TorsoField(t_torso.TorsoConfig(**kw),
                                                           generator=torch.Generator().manual_seed(4))))
    tm.load_state_dict(convert_flax_params(params, tm))
    code = params["params"]["torso_individual_codes"][3]
    ref = jm.apply(params, jnp.asarray(x), jnp.asarray(lm), jnp.asarray(code), jnp.asarray(rgb), jnp.asarray(ws))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(lm), tm.get_individual_code(3), torch.from_numpy(rgb),
                 torch.from_numpy(ws))
    for a, b in zip(ref, got):
        _close(a, b)
    back = _leaves(export_flax_params(tm))
    assert all(np.array_equal(back[k], a) for k, a in _leaves(params).items())


GRID = {"grid_type": "tiledgrid"}
TINY = dict(SMALL, grid_size=16)  # the small head at a 16^3 density grid
CLI = dict(TINY, binary_data_dir="", video_id="syn", n_rays=64, num_samples=4, lambda_torso_deform=0.01)


@pytest.fixture(scope="module")
def grid_binary(tmp_path_factory):
    """A 32^2 synthetic identity with torso images, as the binarizer writes it."""
    root = tmp_path_factory.mktemp("grid_binary")
    d = synthetic(num_frames=8, H=32, W=32, seed=2)
    rs = np.random.RandomState(3)
    for smp in d["train_samples"] + d["val_samples"]:
        torso = rs.rand(32, 32, 4).astype(np.float32)
        torso[..., 3] = torso[..., 3] > 0.5
        smp["torso_img"] = torso
    os.makedirs(root / "syn")
    np.save(root / "syn" / "trainval_dataset.npy", d, allow_pickle=True)
    return str(root)


@pytest.mark.parametrize("build", [
    lambda ds, b: HeadNeRFTask(ds, TConfig(**TINY, grid_type="tiledgrid"), HeadTaskConfig(n_rays=64, num_samples=4),
                               device="cpu"),
    lambda ds, b: SRHeadNeRFTask(ds, TConfig(**TINY, grid_type="hashgrid"),
                                 SRTaskConfig(num_samples=4, sr_dtype="float32"), device="cpu"),
    lambda ds, b: TorsoNeRFTask(ds, TConfig(**TINY, grid_type="tiledgrid"), {"grid_size": 16}, device="cpu"),
    lambda ds, b: TorsoNeRFTask(ds, TConfig(**TINY), dict(GRID, grid_size=16), device="cpu"),
    lambda ds, b: run.build_task(dict(CLI, **GRID, binary_data_dir=b), device="cpu"),
    lambda ds, b: run.build_task(dict(CLI, **GRID, task_cls="torso", binary_data_dir=b), device="cpu"),
], ids=["head", "sr", "torso-head", "torso", "cli-head", "cli-torso"])
def test_training_builds_grid_fields(build, grid_binary):
    """Each task that refused a grid field before this port trained them
    (the head, head + SR, the torso over a grid head, the tiledgrid torso,
    and the CLI's head and torso stages) builds it and takes a step on the
    CPU: the losses are finite; every grid table the step trains (the
    head's two, or the torso's) is in the grid group and moves; a frozen
    grid head stays as it was."""
    ds = t_data.RADNeRFDataset(os.path.join(grid_binary, "syn", "trainval_dataset.npy"), with_sr=True)
    task = build(ds, grid_binary)
    state = task.create_state()
    frozen = getattr(task, "head_model", None)
    frozen = {} if frozen is None else {n: p.clone() for n, p in frozen.state_dict().items()}
    tables = {n: p.detach().clone() for n, p in state.model.named_parameters() if n.endswith("embedder.embeddings")}
    assert all(_radnerf_group(n) == "grid" for n in tables)
    assert tables or any(n.endswith("embedder.embeddings") for n in frozen)  # a grid somewhere
    state, metrics = task.train_step(state, task.sample_train_batch(global_step=0))
    assert math.isfinite(float(metrics["total_loss"]))
    moved = dict(state.model.named_parameters())
    assert all(not torch.equal(moved[n].detach(), t) for n, t in tables.items())
    assert all(torch.equal(task.head_model.state_dict()[n], t) for n, t in frozen.items())
