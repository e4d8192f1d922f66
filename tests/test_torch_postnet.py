"""The port's postnet refiner (`models/postnet/models.py`) and its training
task (`training/tasks/postnet_task.py`) against the JAX package's, on the
CPU, at a small width (hidden 32, 2 dilated layers, 16-frame windows).

- The forward with a non-zero last layer (flax initialises it to zero:
  a fresh postnet is the identity), with a full and a short pitch, atol
  1e-5; the weight bridge both ways, every leaf bit for bit.
- The batches (synthesised raw predictions, a raw bank, a predict_fn) equal
  JAX's bit for bit from the same seed; one train step from the same
  weights, batch and seeded Adam state (Adam's first step from zero moments
  is lr x sign(g)): losses rtol 1e-5, updated params atol 1e-5;
  `validate`'s three metrics atol 1e-4.
- The training CLI on egs/datasets/May/postnet.yaml (hidden 32, 2 layers):
  JAX's Trainer resumes every leaf of the port's work dir and takes a step,
  JAX's `GeneFaceInfer._load_params` restores every leaf, the port resumes
  a dir JAX's CLI wrote, and the port's resume equals the uninterrupted run.
- Serving through the refiner: `GeneFaceInfer.forward_audio2secc` against
  JAX's with the same postnet (the audio-drive tests' pair and bounds: cond
  1e-4, lm68 1e-3 of max(1, |v|)); `from_work_dirs(postnet_dir=)` and
  `--postnet_ckpt` load the trained dir; `stream_infer` refines each chunk
  on its own f0."""

import copy
import json
import os
import shutil

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_audio_drive import A2M, _close_rel, _features, pair  # noqa: F401  (pair: a fixture)

from genefaceplusplus_tpu.data.dataset import RADNeRFDataset as JDataset
from genefaceplusplus_tpu.inference.pipeline import GeneFaceInfer as JInfer
from genefaceplusplus_tpu.models.postnet.models import PitchContourCNNPostNet as JPostNet
from genefaceplusplus_tpu.training import run as j_run
from genefaceplusplus_tpu.training import trainer as j_trainer
from genefaceplusplus_tpu.training.tasks import postnet_task as j_pn
from genefaceplusplus_tpu_torch.config import save_config
from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset as TDataset
from genefaceplusplus_tpu_torch.data.dataset import synthetic
from genefaceplusplus_tpu_torch.inference import cli
from genefaceplusplus_tpu_torch.inference import serving
from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer as TInfer
from genefaceplusplus_tpu_torch.inference.pipeline import default_inp
from genefaceplusplus_tpu_torch.models.postnet.models import PitchContourCNNPostNet as TPostNet
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF, RADNeRFConfig
from genefaceplusplus_tpu_torch.training import run
from genefaceplusplus_tpu_torch.training.tasks import postnet_task as t_pn
from genefaceplusplus_tpu_torch.training.trainer import state_to_flax
from genefaceplusplus_tpu_torch.utils.ckpt import get_last_checkpoint, save_flax_checkpoint
from genefaceplusplus_tpu_torch.utils.convert_jax import convert_flax_params, export_flax_params, load_flax_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "egs/datasets/May/postnet.yaml")
WIDTH = dict(hidden=32, n_layers=2)
TASK = dict(WIDTH, seq_len=16, batch_size=3)
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _seeded_last_layer(variables, n_layers, seed):
    """flax postnet variables with the (zero-initialised) last conv drawn
    non-zero."""
    v = _np(variables)
    last = v["params"][f"Conv_{2 * n_layers + 1}"]
    rs = np.random.RandomState(seed)
    last["kernel"] = (rs.randn(*last["kernel"].shape) * 0.05).astype(np.float32)
    last["bias"] = (rs.randn(*last["bias"].shape) * 0.05).astype(np.float32)
    return v


@pytest.fixture(scope="module")
def postnet_vars():
    jm = JPostNet(out_dim=204, **WIDTH)
    v = jax.jit(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 204)), jnp.zeros((1, 32, 1))))()
    return jm, _seeded_last_layer(v, 2, 1)


@pytest.mark.parametrize("pitch_frames", [40, 31], ids=["pitch_2T", "pitch_short"])
def test_postnet_forward_matches_jax(postnet_vars, pitch_frames):
    """[2, 20, 204] landmarks with a pitch of 2T frames, and one shorter
    than 2T (cut, then edge-padded to T)."""
    jm, v = postnet_vars
    rs = np.random.RandomState(pitch_frames)
    lm = rs.randn(2, 20, 204).astype(np.float32)
    pitch = (np.abs(rs.randn(2, pitch_frames, 1)) * 0.4).astype(np.float32)
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(lm), jnp.asarray(pitch)))
    tm = TPostNet(204, **WIDTH)
    tm.load_state_dict(convert_flax_params(v, tm))
    with torch.no_grad():
        got = tm(torch.from_numpy(lm), torch.from_numpy(pitch)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    assert np.abs(got - lm).max() > 1e-2  # the last layer is live


def test_postnet_bridge_both_ways(postnet_vars):
    """flax's Conv_0 .. Conv_5 land on convs.0 .. convs.5 and come back bit
    for bit; a fresh port postnet is the identity (zero last conv); an
    incomplete tree raises."""
    _, v = postnet_vars
    tm = TPostNet(204, **WIDTH, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        lm = torch.randn(1, 8, 204)
        assert torch.equal(tm(lm, torch.rand(1, 16, 1)), lm)
    sd = convert_flax_params(v, tm)
    assert set(sd) == set(tm.state_dict()) == {f"convs.{i}.{w}" for i in range(6) for w in ("weight", "bias")}
    tm.load_state_dict(sd)
    back = export_flax_params(tm)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(v)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back), jax.tree_util.tree_leaves_with_path(v)):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), jax.tree_util.keystr(path)
    broken = copy.deepcopy(v)
    del broken["params"]["Conv_3"]
    with pytest.raises(KeyError, match="convs.3"):
        convert_flax_params(broken, tm)


# ---------------------------------------------------------------- the task


@pytest.fixture(scope="module")
def ds_dict():
    """A 120-frame synthetic identity (held-out split: the last 16 frames)."""
    d = synthetic(num_frames=120, H=16, W=16, seed=3)
    d["hubert"] = np.ascontiguousarray(d["hubert"][:, :8])
    return d


def _predict(hubert, f0, seed):
    """A deterministic stand-in for an a2m's full-track prediction."""
    rs = np.random.RandomState(seed % (1 << 31))
    L = len(f0) // 2
    return (np.tanh(hubert[::2].sum(-1, keepdims=True)) * 0.1 + rs.randn(L, 204) * 0.05).astype(np.float32)


def _tasks(ds_dict, source="synth"):
    bank = None
    if source == "bank":
        bank = np.random.RandomState(7).randn(3, 120, 204).astype(np.float32)
    fn = _predict if source == "predict_fn" else None
    jt = j_pn.PostnetTask(JDataset(ds_dict), j_pn.PostnetTaskConfig(**TASK), predict_fn=fn, seed=4, raw_bank=bank)
    tt = t_pn.PostnetTask(TDataset(ds_dict), t_pn.PostnetTaskConfig(**TASK), predict_fn=fn, seed=4, raw_bank=bank,
                          device="cpu")
    return jt, tt


@pytest.mark.parametrize("source", ["synth", "bank", "predict_fn"])
def test_sample_train_batch_matches_jax(ds_dict, source):
    jt, tt = _tasks(ds_dict, source)
    assert (tt.T, tt.T_val, tt.T_train) == (jt.T, jt.T_val, jt.T_train) == (120, 16, 104)
    for _ in range(3):
        ref, got = jt.sample_train_batch(), tt.sample_train_batch()
        assert set(got) == set(ref) == {"gt", "raw", "pitch"}
        for k in ref:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


def _synced(jt, tt, postnet_vars):
    """JAX's state with the seeded postnet and a seeded Adam state (count
    10), and the port's state loaded from it."""
    sj = jax.jit(jt.create_state)()
    sj = sj.replace(params=jax.tree.map(jnp.asarray, postnet_vars[1]))
    rs = np.random.RandomState(0)
    opt = _np(flax.serialization.to_state_dict(jt.tx.init(sj.params)))
    opt = jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(10, np.int32) if p[-1].key == "count" else
        np.asarray(rs.randn(*x.shape) * 1e-3 if p[1].key == "mu" else rs.uniform(1e-4, 1e-3, x.shape), np.float32),
        opt)
    sj = sj.replace(opt_state=flax.serialization.from_state_dict(sj.opt_state, opt))
    st = tt.create_state()
    load_flax_tree(st.model, postnet_vars[1])
    st.opt.load_optax(opt)
    return sj, st


def test_train_step_matches_jax(ds_dict, postnet_vars):
    jt, tt = _tasks(ds_dict)
    sj, st = _synced(jt, tt, postnet_vars)
    batch = jt.sample_train_batch()
    sj, mj = jt.train_step(sj, batch)
    st, mt = tt.train_step(st, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    for k in ("l1_loss", "temporal_loss", "total_loss"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5, err_msg=k)
    ref = export_flax_params(st.model)
    worst = max((float(np.abs(a - b).max()), jax.tree_util.keystr(p)) for (p, a), b in zip(
        jax.tree_util.tree_leaves_with_path(ref), jax.tree.leaves(_np(sj.params))))
    assert worst[0] <= ATOL, worst
    got_opt, ref_opt = st.opt.export_optax(), _np(flax.serialization.to_state_dict(sj.opt_state))
    assert jax.tree_util.tree_structure(got_opt) == jax.tree_util.tree_structure(ref_opt)
    assert "params" in got_opt["0"]["mu"]  # the whole {'params': ...} dict, as JAX's tx.init saw it
    for a, b in zip(jax.tree.leaves(got_opt), jax.tree.leaves(ref_opt)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("source", ["synth", "predict_fn"])
def test_validate_matches_jax(ds_dict, postnet_vars, source):
    jt, tt = _tasks(ds_dict, source)
    sj, st = _synced(jt, tt, postnet_vars)
    ref, got = jt.validate(sj), tt.validate(st)
    assert set(got) == set(ref) == {"val_l1_refined", "val_l1_raw", "val_lmd"}
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-4, err_msg=k)
    assert tt.validate(st) == got  # deterministic


# ---------------------------------------------------------------- the CLI


@pytest.fixture(scope="module")
def binary(tmp_path_factory):
    root = tmp_path_factory.mktemp("binary")
    os.makedirs(root / "syn")
    np.save(root / "syn" / "trainval_dataset.npy", synthetic(num_frames=120, H=16, W=16, seed=6),
            allow_pickle=True)
    return str(root)


def _argv(binary, work_dir, steps, device=True):
    hp = (f"binary_data_dir={binary},video_id=syn,max_updates={steps},val_check_interval=2,tb_log_interval=1,"
          f"postnet_hidden=32,postnet_layers=2,seq_len=16,batch_size=3")
    return ["--config", CONFIG, "--work_dir", work_dir] + (["--device", "cpu"] if device else []) + ["--hparams", hp]


def _leaves_equal(a, b, path=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), (path, sorted(a) if isinstance(a, dict) else a)
        for k in b:
            _leaves_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), path


def _records(work_dir):
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def pn_dir(binary, tmp_path_factory):
    work = str(tmp_path_factory.mktemp("postnet") / "work")
    return work, run.main(_argv(binary, work, 4))


def test_cli_trains_postnet_and_jax_resumes_it(pn_dir, binary, tmp_path, monkeypatch):
    """4 steps, validation at 2 and 4, the checkpoint equal to the live
    state in JAX's PostnetTrainState layout; JAX's CLI resumes every leaf of
    a copy and takes a fifth step; JAX's GeneFaceInfer._load_params
    restores every leaf."""
    work, state = pn_dir
    recs = _records(work)
    assert [r["step"] for r in recs if "total_loss" in r] == [1, 2, 3, 4]
    assert all(np.isfinite(r["total_loss"]) for r in recs if "total_loss" in r)
    assert [r["step"] for r in recs if "val_l1_refined" in r] == [2, 4]
    ckpt = get_last_checkpoint(work)[0]
    _leaves_equal(ckpt["state_dict"], state_to_flax(state))
    assert set(ckpt["state_dict"]) == {"params", "opt_state", "global_step", "rng"}
    assert set(ckpt["state_dict"]["params"]) == {"params"}

    copy_dir = str(tmp_path / "copy")
    shutil.copytree(work, copy_dir)
    restored = {}
    fit = j_trainer.Trainer.fit

    def capture(self, resume=True):
        restored["state"] = fit(self, resume)
        return restored["state"]

    monkeypatch.setattr(j_trainer.Trainer, "fit", capture)
    j_run.main(_argv(binary, copy_dir, 4, device=False))
    _leaves_equal(_np(flax.serialization.to_state_dict(restored["state"])), ckpt["state_dict"])
    j_run.main(_argv(binary, copy_dir, 5, device=False))
    assert int(restored["state"].global_step) == 5
    assert [r["step"] for r in _records(copy_dir) if "total_loss" in r][-1] == 5

    jm = JPostNet(out_dim=204, **WIDTH)
    template = jax.jit(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 204)), jnp.zeros((1, 16, 1))))()
    _leaves_equal(_np(JInfer._load_params(None, work, lambda: template)), ckpt["state_dict"]["params"])


def test_port_resumes_jax_postnet_dir_and_itself(pn_dir, binary, tmp_path):
    """JAX's CLI trains 2 steps; the port restores every leaf (params, Adam
    moments and count, step) and continues; and the port's own resume, 2
    steps then to 4, equals the uninterrupted run bit for bit."""
    work = str(tmp_path / "jax")
    j_run.main(_argv(binary, work, 2, device=False))
    jax_ckpt = get_last_checkpoint(work)[0]
    state = run.main(_argv(binary, work, 2))
    _leaves_equal({k: v for k, v in state_to_flax(state).items() if k != "rng"},
                  {k: v for k, v in jax_ckpt["state_dict"].items() if k != "rng"})
    assert run.main(_argv(binary, work, 3)).global_step == 3

    resumed = str(tmp_path / "resumed")
    run.main(_argv(binary, resumed, 2))
    again = run.main(_argv(binary, resumed, 4))
    assert [r["step"] for r in _records(resumed) if "total_loss" in r] == [1, 2, 3, 4]
    _leaves_equal(state_to_flax(again), state_to_flax(pn_dir[1]))


# ---------------------------------------------------------------- serving


def test_forward_audio2secc_with_postnet_matches_jax(pair, postnet_vars, tmp_path):  # noqa: F811
    """The refinement branch: both infers with the same seeded postnet,
    JAX's draw replayed into the port: cond within 1e-4, lm68 within 1e-3
    of max(1, |v|); the refiner moved the condition."""
    j_inf, t_inf = copy.copy(pair[0]), copy.copy(pair[1])
    jm, v = postnet_vars
    j_inf.postnet_model, j_inf.postnet_params, j_inf._fn_cache = jm, jax.tree.map(jnp.asarray, v), {}
    t_inf.postnet_model = TPostNet(204, **WIDTH)
    t_inf.postnet_model.load_state_dict(convert_flax_params(v, t_inf.postnet_model))
    inp = default_inp(drv_aud_features=_features(tmp_path, seed=4))
    jb, tb = j_inf.prepare_batch_from_inp(inp), t_inf.prepare_batch_from_inp(inp)
    _, sub = jax.random.split(j_inf.rng)
    noise = np.array(jax.random.normal(sub, (1, t_inf.a2m_model.vae.latent_length(tb["T"]), 16)))
    jb, tb = j_inf.forward_audio2secc(jb, inp), t_inf.forward_audio2secc(tb, inp, noise=noise)
    np.testing.assert_allclose(tb["cond"], np.asarray(jb["cond"]), atol=1e-4)
    _close_rel(tb["lm68"], jb["lm68"])
    plain = pair[1].forward_audio2secc(pair[1].prepare_batch_from_inp(inp), inp, noise=noise)
    assert np.abs(plain["cond"] - tb["cond"]).max() > 1e-3


def _head_dir(root, binary):
    """A head-only identity's work dir at 16^2 over the CLI's dataset."""
    hp = {"grid_size": 16, "smo_win_size": 3, "individual_embedding_num": 16, "with_sr": False,
          "binary_data_dir": binary, "video_id": "syn"}
    d = os.path.join(root, "head")
    save_flax_checkpoint(d, 1, {"state_dict": {"params": export_flax_params(RADNeRF(
        RADNeRFConfig.from_hparams(hp), generator=torch.Generator().manual_seed(2))), "opt_state": {}},
        "extra_state": {"occupancy": np.ones((16,) * 3, bool)}}, config=hp)
    return d


def test_work_dirs_and_cli_load_the_trained_postnet(pn_dir, binary, tmp_path, monkeypatch):
    """from_work_dirs(postnet_dir=) builds the refiner at the dir's widths
    with its trained tensors; the CLI's --postnet_ckpt passes the dir on;
    stream_infer runs the refiner once a chunk, on the chunk's own f0."""
    work, state = pn_dir
    a2m_dir = str(tmp_path / "a2m")  # config only: the port's seeded a2m at the audio-drive tests' widths
    save_config(A2M, a2m_dir)
    infer = TInfer.from_work_dirs(audio2secc_dir=a2m_dir, head_model_dir=_head_dir(str(tmp_path), binary),
                                  postnet_dir=work, device="cpu")
    got = infer.postnet_model.state_dict()
    assert len(infer.postnet_model.convs) == 6 and infer.postnet_model.convs[0].out_channels == 32
    assert all(torch.equal(got[k], v) for k, v in state.model.state_dict().items())

    seen = {}

    def fake(cls, **kw):
        seen.update(kw)
        raise RuntimeError("stop")

    with monkeypatch.context() as m:
        m.setattr(TInfer, "from_work_dirs", classmethod(fake))
        with pytest.raises(RuntimeError, match="stop"):
            cli.main(["--device", "cpu", "--head_ckpt", "h", "--postnet_ckpt", work, "--drv_aud_features", "f.npy"])
    assert seen["postnet_dir"] == work and seen["head_model_dir"] == "h"

    pitches, f0s = [], []
    infer.postnet_model.register_forward_hook(lambda mod, args, out: pitches.append(args[1][0, :, 0].numpy()))
    forward = TInfer.forward_audio2secc

    def spy(self, batch, inp, noise=None):
        f0s.append(np.asarray(batch["f0"], np.float32))
        return forward(self, batch, inp, noise)

    monkeypatch.setattr(TInfer, "forward_audio2secc", spy)
    monkeypatch.setattr(TInfer, "launch_secc2video", lambda self, b, i: (None, None, b["T"]))
    monkeypatch.setattr(TInfer, "drain_frames", lambda self, launched: iter([launched[2]]))
    wav = (np.random.RandomState(0).randn(16000 * 3) * 0.1).astype(np.float32)
    feats = np.random.RandomState(1).randn(150, 64).astype(np.float32)
    counts = list(serving.stream_infer(infer, wav, {"hubert_full": feats, "temperature": 0.0}, chunk_seconds=1.0))
    assert len(counts) == len(pitches) == len(f0s) >= 3
    for n, p, f0 in zip(counts, pitches, f0s):
        assert p.shape == f0.shape == (2 * n,)
        np.testing.assert_array_equal(p, f0 / 400.0)
