"""The port's audio-to-motion training task (`training/tasks/a2m_task.py`)
and its plain Adam (`OptaxAdam`) against the JAX package's, on the CPU.

At a small width (hidden 32, 2 + 2 WaveNet layers, one flow block, 16-frame
windows): the window draws bit for bit; one train step from the same
weights, windows, posterior noise (JAX's own draw) and seeded Adam state
(Adam's first step from zero moments is lr x sign(g)), losses rtol 1e-5 and
the updated params and BatchNorm statistics (flax's biased update) within
1e-5; `validate`'s prior sample within 1e-4; the optimizer's optax layout.
Through the training CLI at the config's full width (tiny batches, a
dataset that names its frames as files): JAX's `Trainer` and
`GeneFaceInfer._load_params` restore every leaf of the port's work dir,
the port restores every leaf of a dir JAX's `Trainer.save` wrote, and a
resume equals the uninterrupted run bit for bit."""

import json
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from genefaceplusplus_tpu.data.dataset import RADNeRFDataset as JDataset
from genefaceplusplus_tpu.inference.pipeline import GeneFaceInfer as JInfer
from genefaceplusplus_tpu.training import run as j_run
from genefaceplusplus_tpu.training import trainer as j_trainer
from genefaceplusplus_tpu.training.tasks import a2m_task as j_a2m
from genefaceplusplus_tpu_torch.config import set_hparams
from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset as TDataset
from genefaceplusplus_tpu_torch.data.dataset import synthetic
from genefaceplusplus_tpu_torch.training import run
from genefaceplusplus_tpu_torch.training.schedulers import OptaxAdam
from genefaceplusplus_tpu_torch.training.tasks import a2m_task as t_a2m
from genefaceplusplus_tpu_torch.training.trainer import state_to_flax
from genefaceplusplus_tpu_torch.utils.ckpt import get_last_checkpoint
from genefaceplusplus_tpu_torch.utils.convert_jax import flax_tree_leaves, load_flax_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "egs/datasets/May/audio2motion_vae.yaml")
SMALL = dict(hidden_channels=32, enc_n_layers=2, dec_n_layers=2, flow_hidden=16, flow_n_blocks=1, seq_len=16,
             batch_size=3, kl_anneal_steps=4, audio_in_dim=32)
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def ds_dict():
    """A 120-frame synthetic identity with 32-d features (held-out split:
    the last 16 frames)."""
    d = synthetic(num_frames=120, H=16, W=16, seed=2)
    d["hubert"] = np.ascontiguousarray(d["hubert"][:, :32])
    return d


def _tasks(ds_dict, **kw):
    cfg = dict(SMALL, **kw)
    jt = j_a2m.A2MTask(JDataset(ds_dict), j_a2m.A2MTaskConfig(**cfg), seed=3)
    tt = t_a2m.A2MTask(TDataset(ds_dict), t_a2m.A2MTaskConfig(**cfg), seed=3, device="cpu")
    return jt, tt


def _seeded_moments(tree, rs, count):
    """optax's adam state dict with seeded moments (mu ~ N(0, 1e-3), nu ~
    U(1e-4, 1e-3)) and the count."""
    def fill(path, x):
        if path[-1].key == "count":
            return np.asarray(count, np.int32)
        if any(getattr(p, "key", None) == "mu" for p in path):
            return np.asarray(rs.randn(*x.shape) * 1e-3, np.float32)
        return np.asarray(rs.uniform(1e-4, 1e-3, x.shape), np.float32)

    return jax.tree_util.tree_map_with_path(fill, _np(tree))


def _synced(jt, tt, step=2):
    """JAX's state (jitted init, seeded Adam state, `step`) and the port's
    state loaded from it."""
    sj = jax.jit(jt.create_state)()
    opt = _seeded_moments(flax.serialization.to_state_dict(sj.opt_state), np.random.RandomState(0), 10)
    sj = sj.replace(opt_state=flax.serialization.from_state_dict(sj.opt_state, opt),
                    global_step=jnp.asarray(step, jnp.int32))
    st = tt.create_state()
    load_flax_tree(st.model, _np(sj.variables))
    st.opt.load_optax(opt)
    st.global_step = step
    return sj, st


def test_sample_train_batch_matches_jax(ds_dict):
    """The held-out split and three batches of window starts equal JAX's bit
    for bit; the gathered windows are the tracks' slices."""
    jt, tt = _tasks(ds_dict)
    assert (tt.T, tt.T_val, tt.T_train) == (jt.T, jt.T_val, jt.T_train) == (120, 16, 104)
    for _ in range(3):
        ref = np.asarray(jt.sample_train_batch()["starts"])
        got = tt.sample_train_batch()["starts"]
        np.testing.assert_array_equal(got.numpy(), ref)
    b = tt.gather(got)
    for i, s in enumerate(ref):
        np.testing.assert_array_equal(b["audio"][i].numpy(), ds_dict["hubert"][2 * s:2 * s + 32])
        np.testing.assert_array_equal(b["f0"][i].numpy(), ds_dict["f0"][2 * s:2 * s + 32])
        np.testing.assert_array_equal(b["y"][i].numpy(), ds_dict["exp"][s:s + 16])


@pytest.mark.parametrize("use_pitch, target", [(True, "exp"), (False, "idexp_lm3d")],
                         ids=["pitch-exp", "hubert_only-idexp_lm3d"])
def test_train_step_matches_jax(ds_dict, use_pitch, target):
    """One step from the same weights, windows, posterior noise (JAX's draw
    from split(state.rng)[1]) and seeded Adam state at step 2 (KL weight
    half annealed): the losses, the updated params and the BatchNorm
    statistics (flax's biased running variance) agree."""
    jt, tt = _tasks(ds_dict, use_pitch=use_pitch, target=target,
                    in_out_dim=204 if target == "idexp_lm3d" else 64)
    sj, st = _synced(jt, tt)
    batch = jt.sample_train_batch()
    _, sub = jax.random.split(sj.rng)
    noise = np.array(jax.random.normal(sub, (3, st.model.vae.latent_length(16), 16)))
    sj, mj = jt.train_step(sj, batch)
    st, mt = tt.train_step(st, {"starts": torch.from_numpy(np.asarray(batch["starts"]).astype(np.int64))},
                           noise=torch.from_numpy(noise))
    assert st.global_step == int(sj.global_step) == 3
    for k in ("mse_loss", "kl_loss", "total_loss"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5, err_msg=k)
    ref = flax_tree_leaves(_np(sj.variables), st.model)
    got = {k: v.detach().numpy() for k, v in st.model.state_dict().items() if not k.endswith("tracked")}
    assert set(got) == set(ref)
    worst = max((float(np.abs(got[k] - ref[k]).max()), k) for k in ref)
    assert worst[0] <= ATOL, worst
    stats = st.model.mel_encoder.norms[0].running_var.numpy()
    assert not np.allclose(stats, 1.0)  # the statistics moved, by flax's rule (the parity above)
    ref_opt = _np(flax.serialization.to_state_dict(sj.opt_state))
    got_opt = st.opt.export_optax()
    assert jax.tree_util.tree_structure(got_opt) == jax.tree_util.tree_structure(ref_opt)
    for a, b in zip(jax.tree.leaves(got_opt), jax.tree.leaves(ref_opt)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_validate_matches_jax(ds_dict):
    """The held-out metrics' keys, the temperature-0 prior sample's L1 and
    LMD (idexp_lm3d target) within 1e-4; the reconstruction's BatchNorm
    updates are thrown away, as in JAX. (The reconstruction's noise is a
    torch draw, seed 0, where JAX draws from PRNGKey(0): those metrics
    differ by the draw.)"""
    jt, tt = _tasks(ds_dict, target="idexp_lm3d", in_out_dim=204)
    sj, st = _synced(jt, tt)
    before = {k: v.clone() for k, v in st.model.state_dict().items()}
    ref, got = jt.validate(sj), tt.validate(st)
    assert set(got) == set(ref) == {"val_recon_mse", "val_gen_l1", "val_kl", "val_lmd"}
    for k in ("val_gen_l1", "val_lmd"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-4, err_msg=k)
    assert all(torch.equal(v, before[k]) for k, v in st.model.state_dict().items())


def test_optax_adam_layout_matches_optax():
    """Three steps of `OptaxAdam` against `optax.adam` on the same
    gradients, for both trees JAX's tasks optimise: the bare params (a2m:
    `variables['params']`, the BatchNorm statistics not stepped) and the
    whole `{'params': ...}` dict (postnet). Exports equal optax's state dict
    (moments <= 1e-6, counts exact); a fresh optimizer imports and exports
    it again bit for bit; a missing moment raises."""
    rs = np.random.RandomState(4)

    class Toy(torch.nn.Module):
        def __init__(self, norm):
            super().__init__()
            self.dense = torch.nn.ModuleList([torch.nn.Linear(3, 2)])
            if norm:  # statistics outside the optimised tree
                self.norms = torch.nn.ModuleList([torch.nn.BatchNorm1d(2)])

    for collection in ("params", None):
        toy = Toy(norm=collection == "params")
        with torch.no_grad():
            for p in toy.parameters():
                p.copy_(torch.from_numpy(rs.randn(*p.shape).astype(np.float32)))
        opt = OptaxAdam(toy, 1e-2, b1=0.9, b2=0.98, collection=collection)
        tx = optax.adam(1e-2, b1=0.9, b2=0.98)
        tree = opt._tree(None)
        params = jax.tree.map(jnp.asarray, tree)
        state = tx.init(params)
        for _ in range(3):
            grads = {k: rs.randn(*p.shape).astype(np.float32) for k, p in toy.named_parameters()}
            opt.zero_grad()
            for k, p in toy.named_parameters():
                p.grad = torch.from_numpy(grads[k])
            opt.step()
            updates, state = tx.update(jax.tree.map(jnp.asarray, opt._tree(
                {k: torch.from_numpy(g) for k, g in grads.items()})), state, params)
            params = optax.apply_updates(params, updates)
        ref = _np(flax.serialization.to_state_dict(state))
        got = opt.export_optax()
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(ref)
        assert set(ref) == {"0", "1"} and ref["1"] == {} and set(ref["0"]) == {"count", "mu", "nu"}
        assert ("params" in ref["0"]["mu"]) == (collection is None)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        for k, p in toy.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), flax_tree_leaves(_np(params), toy)[k], atol=1e-6)
        fresh = OptaxAdam(Toy(norm=collection == "params"), 1e-2, collection=collection)
        fresh.load_optax(ref)
        assert fresh.count == 3
        for a, b in zip(jax.tree.leaves(fresh.export_optax()), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(a, b)
        broken = jax.tree.map(lambda x: x, ref)
        (broken["0"]["mu"]["params"] if collection is None else broken["0"]["mu"])["Dense_0"]["bias"] = {}
        with pytest.raises(KeyError, match="moments"):
            fresh.load_optax(broken)


# ---------------------------------------------------------------- the CLI


@pytest.fixture(scope="module")
def binary(tmp_path_factory):
    """A 200-frame identity whose frames are named as image files (no
    in-record images): the a2m and postnet tasks read only its arrays."""
    root = tmp_path_factory.mktemp("binary")
    d = synthetic(num_frames=200, H=16, W=16, seed=5)
    os.makedirs(root / "syn")
    for s in d["train_samples"] + d["val_samples"]:
        del s["gt_img"]
        s["gt_img_fname"] = str(root / "syn" / f"{s['idx']}.jpg")
        with open(s["gt_img_fname"], "wb") as f:
            f.write(b"\xff\xd8\xff")  # a JPEG header: no decoder reads it here
    np.save(root / "syn" / "trainval_dataset.npy", d, allow_pickle=True)
    return str(root)


def _hparams(binary, steps, **extra):
    hp = dict(binary_data_dir=binary, video_id="syn", max_updates=steps, val_check_interval=2, tb_log_interval=1,
              batch_size=2, seq_len=16, **extra)
    return ",".join(f"{k}={v}" for k, v in hp.items())


def _argv(binary, work_dir, steps, **extra):
    return ["--config", CONFIG, "--work_dir", work_dir, "--device", "cpu", "--hparams", _hparams(binary, steps,
                                                                                                  **extra)]


def _leaves_equal(a, b, path=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), (path, sorted(a) if isinstance(a, dict) else a)
        for k in b:
            _leaves_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), path


def _steps_logged(work_dir):
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        return [r["step"] for r in map(json.loads, f) if "total_loss" in r]


@pytest.fixture(scope="module")
def a2m_dir(binary, tmp_path_factory):
    """The port's CLI on egs/datasets/May/audio2motion_vae.yaml (its full
    width), 4 steps of 2 x 16 frames."""
    work = str(tmp_path_factory.mktemp("a2m") / "work")
    state = run.main(_argv(binary, work, 4))
    return work, state


@pytest.fixture(scope="module")
def jax_a2m(a2m_dir):
    """JAX's A2MTask for the work dir's config (as JAX's CLI builds it) and
    its initial state, the flax init compiled as one program."""
    cfg = set_hparams(work_dir=a2m_dir[0])
    jt = j_a2m.A2MTask(JDataset(os.path.join(cfg["binary_data_dir"], "syn", "trainval_dataset.npy")),
                       j_a2m.A2MTaskConfig(seq_len=cfg["seq_len"], batch_size=cfg["batch_size"]),
                       seed=cfg.get("seed", 9999))
    return jt, jax.jit(jt.create_state)()


def test_cli_trains_a2m_into_a_jax_work_dir(a2m_dir, jax_a2m, monkeypatch):
    """4 steps with finite losses, validation at 2 and 4, the checkpoint
    equal to the live state bit for bit and in JAX's A2MTrainState layout;
    JAX's Trainer (through JAX's CLI) resumes every leaf of it, optimizer
    state included, and JAX's GeneFaceInfer._load_params restores every
    variable."""
    work, state = a2m_dir
    assert _steps_logged(work) == [1, 2, 3, 4]
    with open(os.path.join(work, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert all(np.isfinite(r["total_loss"]) for r in recs if "total_loss" in r)
    assert [r["step"] for r in recs if "val_gen_l1" in r] == [2, 4]
    ckpt = get_last_checkpoint(work)[0]
    _leaves_equal(ckpt["state_dict"], state_to_flax(state))
    assert set(ckpt["state_dict"]) == {"variables", "opt_state", "global_step", "rng"}
    assert set(ckpt["state_dict"]["variables"]) == {"params", "batch_stats"}
    assert sum(np.asarray(x).size for x in jax.tree.leaves(ckpt["state_dict"]["variables"])) == 11_840_768

    jt, template = jax_a2m
    monkeypatch.setattr(j_a2m.A2MTask, "create_state", lambda self: template)
    restored = {}
    fit = j_trainer.Trainer.fit

    def capture(self, resume=True):
        restored["state"] = fit(self, resume)
        return restored["state"]

    monkeypatch.setattr(j_trainer.Trainer, "fit", capture)
    argv = _argv(set_hparams(work_dir=work)["binary_data_dir"], work, 4)
    j_run.main(argv[:4] + ["--hparams", argv[-1]])  # JAX's CLI has no --device; max_updates 4: restore only
    got = _np(flax.serialization.to_state_dict(restored["state"]))
    _leaves_equal(got, ckpt["state_dict"])

    loaded = JInfer._load_params(None, work, lambda: template.variables)
    _leaves_equal(_np(loaded), ckpt["state_dict"]["variables"])


def test_port_resumes_a_jax_a2m_dir(a2m_dir, jax_a2m, tmp_path):
    """A dir JAX's Trainer.save wrote (its initial state at step 3 with
    seeded Adam moments): the port's CLI restores every leaf exactly
    (max_updates 3: restore only), then takes a fourth step."""
    src, _ = a2m_dir
    jt, template = jax_a2m
    opt = _seeded_moments(flax.serialization.to_state_dict(template.opt_state), np.random.RandomState(1), 3)
    sj = template.replace(opt_state=flax.serialization.from_state_dict(template.opt_state, opt),
                          global_step=jnp.asarray(3, jnp.int32))
    work = str(tmp_path / "jax_a2m")
    cfg = set_hparams(work_dir=src)
    j_trainer.Trainer(jt, work, config=cfg).save(sj, 3)
    assert "port_state" not in get_last_checkpoint(work)[0]["extra_state"]
    binary = cfg["binary_data_dir"]
    state = run.main(_argv(binary, work, 3))
    _leaves_equal({k: v for k, v in state_to_flax(state).items() if k != "rng"},
                  {k: v for k, v in _np(flax.serialization.to_state_dict(sj)).items() if k != "rng"})
    state = run.main(_argv(binary, work, 4))
    assert state.global_step == 4 and state.opt.count == 4


def test_cli_resume_equals_the_uninterrupted_run(a2m_dir, tmp_path):
    """2 steps, then the CLI again to 4 (the checkpoint carries the window
    draws' numpy state and the noise generator): the final state equals the
    uninterrupted 4-step run's bit for bit, each step logged once."""
    src, state = a2m_dir
    binary = set_hparams(work_dir=src)["binary_data_dir"]
    work = str(tmp_path / "resumed")
    run.main(_argv(binary, work, 2))
    resumed = run.main(_argv(binary, work, 4))
    assert _steps_logged(work) == [1, 2, 3, 4]
    _leaves_equal(state_to_flax(resumed), state_to_flax(state))
