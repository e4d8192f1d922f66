"""The port's training CLI (`python -m genefaceplusplus_tpu_torch.training.run`)
against the JAX package's work dirs, on the CPU: the three stages of one
identity (the head with lip steps, the head + SR with the perceptual
terms, the torso from the SR stage's dir) from the egs/ configs at small
sizes (grid 16, a 32^2 identity with torso images rendered at 16^2, 2
steps each); JAX's `Trainer` resumes the head and SR dirs the port wrote,
the port resumes a dir JAX's CLI wrote, and JAX's `GeneFaceInfer` serves
the port's torso + head dirs; resume and SIGTERM in the port.

Tolerances: restores are exact (every leaf of the state, the optimizer's
moments and counts); frames against JAX's >= 42 dB and mean |d| <= 1.5
levels (tests/test_torch_workdir.py's bar: the port serves through the
fused field's bf16, JAX through the float32 field)."""

import json
import math
import os
import shutil
import signal
import subprocess
import sys
import time

import flax
import jax
import numpy as np
import pytest
import torch

from genefaceplusplus_tpu.inference import serving as j_serving
from genefaceplusplus_tpu.inference.pipeline import GeneFaceInfer as JInfer
from genefaceplusplus_tpu.training import run as j_run
from genefaceplusplus_tpu.training import trainer as j_trainer
from genefaceplusplus_tpu_torch.config import set_hparams
from genefaceplusplus_tpu_torch.data.dataset import synthetic
from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer as TInfer
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRFConfig
from genefaceplusplus_tpu_torch.training import run
from genefaceplusplus_tpu_torch.training.tasks.torso_task import load_head
from genefaceplusplus_tpu_torch.training.trainer import state_to_flax
from genefaceplusplus_tpu_torch.utils.ckpt import get_all_ckpts, get_last_checkpoint
from genefaceplusplus_tpu_torch.utils.convert_jax import convert_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = 32
CONFIGS = {"head": "egs/datasets/May/lm3d_radnerf.yaml", "sr": "egs/datasets/May/lm3d_radnerf_sr.yaml",
           "torso": "egs/datasets/May/lm3d_radnerf_torso_sr.yaml"}
STAGE = {"head": "n_rays=64,num_samples=4,finetune_lips_start_iter=0,lip_window=8",
         "sr": "num_samples=4,lpips_start_iters=1,lip_window=8",
         "torso": "lambda_torso_deform=0.01"}
MIN_PSNR, MAX_MEAN_ABS = 42.0, 1.5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def binary(tmp_path_factory):
    """A 32^2 synthetic identity with torso images, as the binarizer writes it."""
    root = tmp_path_factory.mktemp("binary")
    d = synthetic(num_frames=12, H=HW, W=HW, seed=0)
    rs = np.random.RandomState(1)
    for s in d["train_samples"] + d["val_samples"]:
        t = rs.rand(HW, HW, 4).astype(np.float32)
        t[..., 3] = t[..., 3] > 0.5
        s["torso_img"] = t
    os.makedirs(root / "syn")
    np.save(root / "syn" / "trainval_dataset.npy", d, allow_pickle=True)
    return str(root)


def _hparams(binary, stage, steps=2, **extra):
    common = (f"binary_data_dir={binary},video_id=syn,grid_size=16,individual_embedding_num=16,"
              f"max_updates={steps},val_check_interval=2,update_extra_interval=1,tb_log_interval=1")
    more = "".join(f",{k}={v}" for k, v in extra.items())
    return f"{common},{STAGE[stage]}{more}"


def _argv(binary, stage, work_dir, steps=2, **extra):
    return ["--config", os.path.join(REPO, CONFIGS[stage]), "--work_dir", work_dir, "--device", "cpu",
            "--hparams", _hparams(binary, stage, steps, **extra)]


@pytest.fixture(scope="module")
def dirs(binary, tmp_path_factory):
    """The three stages through the CLI, 2 steps each: {stage: (dir, state)}."""
    tmp = tmp_path_factory.mktemp("work")
    out = {}
    for stage in ("head", "sr", "torso"):
        d = str(tmp / stage)
        extra = {"head_model_dir": out["sr"][0]} if stage == "torso" else {}
        out[stage] = (d, run.main(_argv(binary, stage, d, **extra)))
    return out


def _metrics(work_dir):
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _leaves_equal(a, b, path=""):
    """Two checkpoint trees hold the same keys and bit-equal leaves."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), (path, sorted(a) if isinstance(a, dict) else a)
        for k in b:
            _leaves_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), path


def test_cli_trains_each_stage_into_a_jax_work_dir(dirs, binary):
    """Each stage: 2 steps with finite losses, its stage's metrics (the lip
    step, the SR and perceptual terms, the torso terms), flax msgpack
    checkpoints equal to the live state bit for bit, validation renders as
    PNG, and config.yaml with the resolved data location."""
    want = {"head": {"lpips_loss", "weights_entropy_loss"},
            "sr": {"sr_mse_loss", "sr_lpips_loss", "sr_lip_lpips_loss", "lpips_loss"},
            "torso": {"torso_entropy", "deform_reg"}}
    for stage, (d, state) in dirs.items():
        recs = _metrics(d)
        steps = [r for r in recs if "total_loss" in r]
        assert [r["step"] for r in steps] == [1, 2], stage
        assert all(math.isfinite(r["total_loss"]) for r in steps)
        assert want[stage] <= set().union(*steps), (stage, sorted(set().union(*steps)))
        assert any("val_psnr" in r for r in recs)
        ckpts = get_all_ckpts(d)
        assert [os.path.basename(p) for p in ckpts] == ["model_ckpt_steps_2.ckpt"]
        with open(ckpts[0], "rb") as f:
            first = f.read(1)[0]
        assert first in (0xde, 0xdf) or 0x80 <= first < 0x90, hex(first)
        ckpt, _ = get_last_checkpoint(d)
        _leaves_equal(ckpt["state_dict"], state_to_flax(state))
        assert int(ckpt["global_step"]) == 2 and "port_state" in ckpt["extra_state"]
        cfg = open(os.path.join(d, "config.yaml")).read()
        assert f"binary_data_dir: {binary}" in cfg and "video_id: syn" in cfg
    assert os.path.exists(os.path.join(dirs["head"][0], "validation_results", "val_2_0.png"))
    assert os.path.exists(os.path.join(dirs["sr"][0], "validation_results", "val_sr_2_0.png"))
    assert set(get_last_checkpoint(dirs["torso"][0])[0]["state_dict"]) == {
        "torso_params", "opt_state", "global_step", "rng"}


@pytest.mark.parametrize("stage", ["head", "sr"])
def test_jax_trainer_resumes_port_dirs(dirs, binary, tmp_path, monkeypatch, stage):
    """JAX's CLI on a copy of the port's dir: its Trainer restores every
    leaf of its TrainState from the port's checkpoint exactly (the same
    fields, no other), then takes a third step with a finite loss."""
    work = str(tmp_path / stage)
    shutil.copytree(dirs[stage][0], work)
    port_state = get_last_checkpoint(work)[0]["state_dict"]
    restored = {}
    fit = j_trainer.Trainer.fit

    def capture(self, resume=True):
        restored["state"] = fit(self, resume)
        return restored["state"]

    monkeypatch.setattr(j_trainer.Trainer, "fit", capture)
    argv = _argv(binary, stage, work)
    j_run.main(argv[:4] + ["--hparams", argv[-1]])  # JAX's CLI has no --device
    got = _np(flax.serialization.to_state_dict(restored["state"]))
    assert set(got) == set(port_state)
    _leaves_equal(got, port_state)
    j_run.main(argv[:4] + ["--hparams", _hparams(binary, stage, steps=3)])
    assert int(restored["state"].global_step) == 3
    last = [r for r in _metrics(work) if "total_loss" in r][-1]
    assert last["step"] == 3 and math.isfinite(last["total_loss"])


def test_port_resumes_a_jax_work_dir(binary, tmp_path):
    """JAX's CLI trains a head + SR dir 2 steps; the port's torso stage
    takes its head (the 'head' subtree, exactly, and its occupancy) and
    trains; the port's CLI restores the dir's params, Adam moments and
    counts, step and lambda_ambient exactly, then continues (its
    generators start from the seed: JAX's dir has no port_state)."""
    work = str(tmp_path / "jax_sr")
    argv = _argv(binary, "sr", work)
    j_run.main(argv[:4] + ["--hparams", argv[-1]])
    jax_ckpt = get_last_checkpoint(work)[0]
    assert "port_state" not in jax_ckpt["extra_state"]
    head, occ, _ = load_head(RADNeRFConfig.from_hparams(set_hparams(work_dir=work)), work, "cpu")
    ref = convert_flax_params(jax_ckpt["state_dict"]["params"]["head"], head)
    assert all(torch.equal(v, ref[k]) for k, v in head.state_dict().items())
    np.testing.assert_array_equal(occ.numpy(), jax_ckpt["extra_state"]["occupancy"])
    torso = run.main(_argv(binary, "torso", str(tmp_path / "torso"), head_model_dir=work))
    assert torso.global_step == 2
    state = run.main(argv)  # max_updates 2: restore only
    _leaves_equal({k: v for k, v in state_to_flax(state).items() if k != "rng"},
                  {k: v for k, v in jax_ckpt["state_dict"].items() if k != "rng"})
    state = run.main(_argv(binary, "sr", work, steps=3))
    assert state.global_step == 3
    assert math.isfinite([r for r in _metrics(work) if "total_loss" in r][-1]["total_loss"])


class _JInfer(JInfer):
    """JAX's GeneFaceInfer with each flax init compiled as one program."""

    def _init_head(self):
        return jax.jit(super()._init_head)()

    def _init_torso(self):
        return jax.jit(super()._init_torso)()

    def _init_sr(self):
        return jax.jit(super()._init_sr)()


def test_jax_serves_the_port_torso_and_head_dirs(dirs):
    """JAX's GeneFaceInfer loads the port's torso dir (and, through its
    config, the head + SR dir) as the port's own loader does, and renders
    GT-driven frames >= 42 dB against the port's."""
    torso_dir = dirs["torso"][0]
    j_inf = _JInfer(torso_model_dir=torso_dir)
    t_inf = TInfer.from_work_dirs(torso_model_dir=torso_dir, device="cpu")
    np.testing.assert_array_equal(t_inf.occupancy.numpy(), np.asarray(j_inf.occupancy))
    np.testing.assert_array_equal(t_inf.torso_occupancy_2d.numpy(), np.asarray(j_inf.torso_occupancy_2d))
    batch = t_inf.prepare_gt_batch([0, 3, 5])
    inp = {"frames_per_dispatch": 3}
    ref = list(j_serving._render_frames(j_inf, batch, inp))
    got = list(t_inf.forward_secc2video(batch, inp))
    assert len(got) == len(ref) == 3 and got[0].shape == (HW, HW, 3)
    for a, b in zip(got, ref):
        d = a.astype(np.float64) - b.astype(np.float64)
        mse = float(np.mean(d ** 2))
        assert (math.inf if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)) >= MIN_PSNR
        assert np.abs(d).mean() <= MAX_MEAN_ABS


def test_a_port_resume_equals_the_uninterrupted_run(binary, tmp_path):
    """4 head steps (lip steps from step 1, grid refreshes, a validation at
    step 2) in one run, and as 2 + a resume of 2: the final checkpoints
    are equal leaf for leaf and the step metrics equal."""
    whole, split = str(tmp_path / "whole"), str(tmp_path / "split")
    run.main(_argv(binary, "head", whole, steps=4))
    run.main(_argv(binary, "head", split, steps=2))
    run.main(_argv(binary, "head", split, steps=4))
    a, b = get_last_checkpoint(whole)[0], get_last_checkpoint(split)[0]
    _leaves_equal(a, b)
    steps = [[{k: v for k, v in r.items() if k != "steps_per_sec"} for r in _metrics(d) if "total_loss" in r]
             for d in (whole, split)]
    assert steps[0] == steps[1] and [r["step"] for r in steps[0]] == [1, 2, 3, 4]
    assert any("lpips_loss" in r for r in steps[0])


def test_resume_reads_the_ports_earlier_torch_checkpoints(dirs, binary, tmp_path):
    """A dir holding a checkpoint of the port's earlier `torch.save` format
    (module, optimizer, step, lambda_ambient and generator state dicts)
    resumes: the restored state equals the one it was written from."""
    _, state = dirs["head"]
    work = tmp_path / "old"
    work.mkdir()
    torch.save({"state_dict": {"model": state.model.state_dict(), "opt": state.opt.state_dict(),
                               "global_step": 2, "lambda_ambient": state.lambda_ambient,
                               "rng": state.generator.get_state()},
                "extra_state": {"density_grid": torch.zeros(16, 16, 16), "occupancy": torch.ones(16, 16, 16).bool()},
                "global_step": 2}, str(work / "model_ckpt_steps_2.ckpt"))
    restored = run.main(_argv(binary, "head", str(work)))  # max_updates 2: restore only
    _leaves_equal(state_to_flax(restored), state_to_flax(state))
    assert torch.equal(restored.generator.get_state(), state.generator.get_state())


def test_sigterm_checkpoints_and_the_rerun_continues(binary, tmp_path):
    """The CLI in a subprocess gets SIGTERM after its second step: it
    finishes the step, writes a checkpoint, exits 0; the rerun resumes from
    it to the end, every step logged once."""
    work = str(tmp_path / "term")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    cmd = [sys.executable, "-m", "genefaceplusplus_tpu_torch.training.run",
           *_argv(binary, "head", work, steps=10_000, val_check_interval=10_000)]
    log = tmp_path / "term.log"  # a file: nothing reads a pipe while the child runs
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=f, stderr=subprocess.STDOUT)
    try:
        metrics = os.path.join(work, "metrics.jsonl")
        deadline = time.time() + 240
        while time.time() < deadline and proc.poll() is None:
            if os.path.exists(metrics) and len(_metrics(work)) >= 2:
                break
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = log.read_text()
    assert proc.returncode == 0, out[-2000:]
    assert "checkpoint saved" in out
    ckpts = get_all_ckpts(work)
    assert len(ckpts) == 1
    saved = int(get_last_checkpoint(work)[0]["global_step"])
    logged = [r["step"] for r in _metrics(work) if "total_loss" in r]
    assert saved >= 2 and logged == list(range(1, saved + 1))
    run.main(_argv(binary, "head", work, steps=saved + 2, val_check_interval=10_000))
    assert [r["step"] for r in _metrics(work) if "total_loss" in r] == list(range(1, saved + 3))


def test_unported_tasks_and_no_card_raise(binary, tmp_path, monkeypatch):
    """What the tasks do not port raises (train-side compaction, the SR's
    dual discriminator); without a card the CLI raises unless --device
    names one."""
    for stage, extra in (("head", {"train_compact_start": 5}), ("sr", {"lambda_dual_fm": 0.1})):
        with pytest.raises(NotImplementedError, match="not ported"):
            run.main(_argv(binary, stage, str(tmp_path / stage), **extra))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _argv(binary, "head", str(tmp_path / "card"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run.main(argv[:4] + argv[6:])
