"""The port's identity training launcher (`genefaceplusplus_tpu_torch/training/fleet.py`)
against JAX's `genefaceplusplus_tpu/training/fleet.py`.

- JAX's `tests/test_fleet.py` case through the port on the CPU: the head
  (+ SR) stage, then the torso stage with the head's dir in its config,
  each to step 2; a second run skips both.
- Both packages' `train_identity` and `main`, with the data-preparation and
  training entry points replaced by recorders: the argument lists they are
  called with are equal (`--device` added to each where the port's is
  given one).
"""

import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = 32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fleet_trains_head_then_torso_and_skips_done(tmp_path, capsys):
    """JAX's test_fleet case on the May head + SR and torso configs (the ones
    an identity trains with; JAX's case uses non-SR tiny configs, whose torso
    stage the port does not train: ROADMAP.md queue C), narrowed by hparams,
    on a 32^2 synthetic identity with torso images."""
    from genefaceplusplus_tpu_torch.config import set_hparams
    from genefaceplusplus_tpu_torch.data.dataset import synthetic
    from genefaceplusplus_tpu_torch.training.fleet import train_identity
    from genefaceplusplus_tpu_torch.utils.ckpt import get_last_checkpoint

    vid = "TestId"
    bin_dir = tmp_path / "data" / "binary" / "videos" / vid
    os.makedirs(bin_dir)
    d = synthetic(num_frames=12, H=HW, W=HW, seed=0)
    rs = np.random.RandomState(1)
    for smp in d["train_samples"] + d["val_samples"]:
        t = rs.rand(HW, HW, 4).astype(np.float32)
        t[..., 3] = t[..., 3] > 0.5
        smp["torso_img"] = t
    np.save(str(bin_dir / "trainval_dataset.npy"), d, allow_pickle=True)
    hp = (f"binary_data_dir={tmp_path}/data/binary/videos,grid_size=16,individual_embedding_num=16,"
          "val_check_interval=2,update_extra_interval=1,tb_log_interval=1,num_samples=4")
    kw = dict(data_dir=str(tmp_path / "data"), ckpt_root=str(tmp_path / "ckpts"), steps=["head", "torso"],
              max_updates={"head": 2, "torso": 2}, extra_hparams=hp, device="cpu")
    configs = [os.path.join(REPO, "egs/datasets/May", c) for c in ("lm3d_radnerf_sr.yaml", "lm3d_radnerf_torso_sr.yaml")]
    out = train_identity(vid, *configs, **kw)
    for stage in ("head", "torso"):
        ckpt, path = get_last_checkpoint(out[stage])
        assert ckpt is not None, stage
        assert int(ckpt["global_step"]) == 2
    assert set_hparams(work_dir=out["torso"]).get("head_model_dir") == out["head"]

    capsys.readouterr()
    assert train_identity(vid, *configs, **kw) == out
    text = capsys.readouterr().out
    assert "head: checkpoint exists, skipping" in text
    assert "torso: checkpoint exists, skipping" in text


def _recorders(monkeypatch, run_mod, process_mod):
    calls = []
    monkeypatch.setattr(run_mod, "main", lambda argv: calls.append(("run", list(argv))))
    monkeypatch.setattr(process_mod, "main", lambda argv: calls.append(("process", list(argv))))
    return calls


@pytest.mark.parametrize("device", [None, "cpu"])
def test_train_identity_calls_match_jax(tmp_path, monkeypatch, device):
    from genefaceplusplus_tpu.data import process as j_process
    from genefaceplusplus_tpu.training import fleet as j_fleet
    from genefaceplusplus_tpu.training import run as j_run
    from genefaceplusplus_tpu_torch.data import process as t_process
    from genefaceplusplus_tpu_torch.training import fleet as t_fleet
    from genefaceplusplus_tpu_torch.training import run as t_run

    j_calls = _recorders(monkeypatch, j_run, j_process)
    t_calls = _recorders(monkeypatch, t_run, t_process)
    kw = dict(data_dir=str(tmp_path / "data"), ckpt_root=str(tmp_path / "ckpts"), extra_hparams="lr=0.001",
              max_updates={"head": 7})
    extra = ["--device", device] if device is not None else []  # passed on to every stage

    def expected():
        return [(k, a + extra) for k, a in j_calls]

    j_out = j_fleet.train_identity("May", "h.yaml", "t.yaml", **kw)
    t_out = t_fleet.train_identity("May", "h.yaml", "t.yaml", device=device, **kw)
    assert t_out == j_out
    assert t_calls == expected()
    assert [k for k, _ in t_calls] == ["process", "run", "run"]

    j_calls.clear()
    t_calls.clear()
    argv = ["--video_ids", "A, B", "--head_config", "h.yaml", "--torso_config", "t.yaml", "--data_dir",
            str(tmp_path / "d"), "--ckpt_root", str(tmp_path / "c"), "--steps", "head,torso",
            "--max_updates_torso", "3", "--hparams", "x=1"]
    assert t_fleet.main(argv + extra) == j_fleet.main(argv)
    assert t_calls == expected() and len(t_calls) == 4
