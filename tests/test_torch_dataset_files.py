"""The port's dataset on a binarized identity whose images are files (gt
frames as `com_imgs/%08d.jpg`, head and inpainted-torso frames as RGBA
`head_imgs/` and `inpaint_torso_imgs/%08d.png`, written by cv2.imwrite as
the JAX data tools write them), against JAX's `RADNeRFDataset` on the same
files: `load_image` exact at the stored size and within 1 level where it
resizes (cv2.resize against the port's bilinear), the file winning over an
in-record array, the `max <= 1.5` quirk, the LRU cache's order and byte
count, the frame store, and one head-stage step of the training CLI from
the files equal to the same step from the decoded images in the record."""

import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from genefaceplusplus_tpu.data import dataset as j_data  # noqa: E402
from genefaceplusplus_tpu.training import frame_store as j_store  # noqa: E402
from genefaceplusplus_tpu_torch.data import dataset as t_data  # noqa: E402
from genefaceplusplus_tpu_torch.data.image_io import read_image  # noqa: E402
from genefaceplusplus_tpu_torch.training import frame_store as t_store  # noqa: E402
from genefaceplusplus_tpu_torch.training import run  # noqa: E402
from genefaceplusplus_tpu_torch.training.trainer import state_to_flax  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, FRAMES = 32, 12
KINDS = {"gt": ("com_imgs", "jpg"), "head": ("head_imgs", "png"), "torso": ("inpaint_torso_imgs", "png")}


def _rgba(rs) -> np.ndarray:
    img = (rs.rand(HW, HW, 4) * 255).astype(np.uint8)
    img[..., 3] = (rs.rand(HW, HW) > 0.5) * 255
    return img


def write_identity(root, seed: int = 0) -> dict:
    """A synthetic identity in the binarizer's layout under root/syn: the
    record names the files and holds no image arrays."""
    d = t_data.synthetic(num_frames=FRAMES, H=HW, W=HW, seed=seed)
    proc = os.path.join(root, "syn")
    for sub, _ in KINDS.values():
        os.makedirs(os.path.join(proc, sub), exist_ok=True)
    rs = np.random.RandomState(seed + 1)
    for s in d["train_samples"] + d["val_samples"]:
        gt = s.pop("gt_img")
        for kind, (sub, ext) in KINDS.items():
            path = os.path.join(proc, sub, f"{s['idx']:08d}.{ext}")
            if kind == "gt":
                cv2.imwrite(path, (gt * 255).astype(np.uint8)[..., ::-1].copy())
            else:
                img = _rgba(rs)
                cv2.imwrite(path, np.concatenate([img[..., 2::-1], img[..., 3:]], -1).copy())
            s[f"{kind}_img_fname"] = path
    np.save(os.path.join(proc, "trainval_dataset.npy"), d, allow_pickle=True)
    return d


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("binary")
    return str(root), write_identity(str(root))


@pytest.mark.parametrize("with_sr", [False, True])
def test_load_image_from_files_matches_jax(files, with_sr):
    _, d = files
    ds_j = j_data.RADNeRFDataset(d, with_sr=with_sr)
    ds_t = t_data.RADNeRFDataset(d, with_sr=with_sr)
    for i in (0, 5, len(ds_t) - 1):
        for kind in KINDS:
            for with_alpha in (False, True):
                for full_res in (False, True):
                    a = ds_t.load_image(i, kind, with_alpha=with_alpha, full_res=full_res)
                    b = ds_j.load_image(i, kind, with_alpha=with_alpha, full_res=full_res)
                    size = HW if full_res or not with_sr else HW // 2
                    ch = 4 if with_alpha and kind != "gt" else 3
                    assert a.shape == b.shape == (size, size, ch) and a.dtype == np.float32
                    if size == HW:  # the stored size: no resize, exact
                        np.testing.assert_array_equal(a, b)
                    else:  # cv2.resize against the port's bilinear
                        assert np.abs(a - b).max() <= 1 / 255 + 1e-6
    raw = read_image(d["train_samples"][2]["torso_img_fname"])
    assert raw.shape == (HW, HW, 4)
    np.testing.assert_array_equal(ds_t.load_image(2, "torso", with_alpha=True, full_res=True),
                                  raw.astype(np.float32) / 255.0)
    # the torso over the background: exact at the stored size; resized, the
    # torso's colour and alpha may each differ by a level
    bg_t, bg_j = ds_t.frame_bg_torso(2), ds_j.frame_bg_torso(2)
    assert np.abs(bg_t - bg_j).max() <= (2 / 255 + 1e-6 if with_sr else 0.0)


def test_file_wins_over_the_record_array(files):
    """A file that exists wins over `{kind}_img`; a named file that does not
    exist falls back to it."""
    root, d = files
    d = dict(d, train_samples=[dict(s) for s in d["train_samples"]])
    rs = np.random.RandomState(7)
    d["train_samples"][0]["gt_img"] = rs.rand(HW, HW, 3).astype(np.float32)
    d["train_samples"][1]["gt_img"] = rs.rand(HW, HW, 3).astype(np.float32)
    d["train_samples"][1]["gt_img_fname"] = os.path.join(root, "missing.jpg")
    ds_t, ds_j = t_data.RADNeRFDataset(d, with_sr=False), j_data.RADNeRFDataset(d, with_sr=False)
    from_file = read_image(d["train_samples"][0]["gt_img_fname"]).astype(np.float32) / 255.0
    np.testing.assert_array_equal(ds_t.load_image(0, "gt"), from_file)
    np.testing.assert_array_equal(ds_t.load_image(0, "gt"), ds_j.load_image(0, "gt"))
    arr = np.round(d["train_samples"][1]["gt_img"] * 255) / 255
    np.testing.assert_allclose(ds_t.load_image(1, "gt"), arr, atol=1e-6)
    np.testing.assert_array_equal(ds_t.load_image(1, "gt"), ds_j.load_image(1, "gt"))


@pytest.mark.parametrize("levels", [(0, 1), (0, 0), (0, 2)])
def test_dark_frame_quirk(tmp_path, files, levels):
    """A file whose max is <= 1.5 is not divided by 255 (JAX's quirk, kept):
    levels 0/1 load as 0.0/1.0, and a max of 2 divides as usual."""
    _, d = files
    rs = np.random.RandomState(3)
    dark = rs.choice(levels, size=(HW, HW, 3)).astype(np.uint8)
    path = str(tmp_path / "dark.png")
    cv2.imwrite(path, dark)
    d = dict(d, train_samples=[dict(s) for s in d["train_samples"]])
    d["train_samples"][0]["gt_img_fname"] = path
    for with_sr in (False, True):
        a = t_data.RADNeRFDataset(d, with_sr=with_sr).load_image(0, "gt")
        b = j_data.RADNeRFDataset(d, with_sr=with_sr).load_image(0, "gt")
        assert np.abs(a - b).max() <= (0 if not with_sr else 1 / 255 + 1e-6)
    a = t_data.RADNeRFDataset(d, with_sr=False).load_image(0, "gt")
    rgb = dark[..., ::-1]  # cv2 wrote the array as BGR
    np.testing.assert_array_equal(a, rgb if max(levels) <= 1 else rgb / np.float32(255.0))


def test_cache_lru_matches_jax(files):
    """One scripted access sequence under a cap of ~3.5 full-size frames:
    the cache's keys in order and its byte count equal JAX's after every
    access."""
    _, d = files
    ds_t, ds_j = t_data.RADNeRFDataset(d, with_sr=True), j_data.RADNeRFDataset(d, with_sr=True)
    cap_mb = 3.5 * HW * HW * 4 / 2 ** 20
    ds_t.img_cache_mb = ds_j.img_cache_mb = cap_mb
    seq = [(0, "gt", False), (1, "torso", True), (0, "gt", False), (2, "gt", True), (3, "head", False),
           (1, "torso", True), (4, "torso", False), (5, "gt", True), (0, "gt", False), (6, "head", True),
           (2, "gt", True), (7, "gt", False), (8, "torso", True), (3, "head", False)]
    seen = set()
    for i, kind, full_res in seq:
        seen.add((i, kind, full_res))
        a = ds_t.load_image(i, kind, with_alpha=True, full_res=full_res)
        b = ds_j.load_image(i, kind, with_alpha=True, full_res=full_res)
        assert np.abs(a - b).max() <= (0.0 if full_res else 1 / 255 + 1e-6)  # resized: 1 level
        assert list(ds_t._img_cache) == list(ds_j._img_cache)
        assert ds_t._img_cache_bytes == ds_j._img_cache_bytes <= cap_mb * 2 ** 20
    assert len(ds_t._img_cache) < len(seen)  # the cap evicted
    assert ds_t._img_cache_bytes == sum(v.nbytes for v in ds_t._img_cache.values())


def test_default_cache_cap_is_one_gib(files):
    _, d = files
    ds = t_data.RADNeRFDataset(d, with_sr=True)
    assert ds.img_cache_mb == j_data.RADNeRFDataset(d, with_sr=True).img_cache_mb == 1024
    ds.load_image(0, "gt")
    assert ds._img_cache_bytes == (HW // 2) ** 2 * 3


def test_base_device_frames_from_files_match_jax(files):
    _, d = files
    for with_sr in (False, True):
        ft = t_store.base_device_frames(t_data.RADNeRFDataset(d, with_sr=with_sr), device="cpu")
        fj = j_store.base_device_frames(j_data.RADNeRFDataset(d, with_sr=with_sr))
        for k in ("poses", "conds_all", "frame_ids", "eye"):
            np.testing.assert_array_equal(ft[k].numpy(), np.asarray(fj[k]))
        gt_t, gt_j = ft["gt"].numpy().astype(int), np.asarray(fj["gt"]).astype(int)
        assert gt_t.shape == gt_j.shape == (len(d["train_samples"]), HW // (1 + with_sr), HW // (1 + with_sr), 3)
        assert np.abs(gt_t - gt_j).max() <= (0 if not with_sr else 1)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree)]


STAGES = {"head": ("lm3d_radnerf.yaml", "n_rays=64,num_samples=4,finetune_lips_start_iter=0,lip_window=8"),
          "sr": ("lm3d_radnerf_sr.yaml", "num_samples=4,lpips_start_iters=1,lip_window=8"),
          "torso": ("lm3d_radnerf_torso_sr.yaml", "lambda_torso_deform=0.01")}


@pytest.fixture(scope="module")
def cli_states(files, tmp_path_factory):
    """The training CLI's head, SR and torso stages, one step each on the
    CPU: from the files, and from a record that holds the decoded images as
    arrays. {(source, stage): final state}."""
    root, d = files
    tmp = tmp_path_factory.mktemp("cli")
    inline = {k: v for k, v in d.items() if not k.endswith("_samples")}
    for split in ("train_samples", "val_samples"):
        inline[split] = []
        for named in d[split]:
            s = {k: v for k, v in named.items() if not k.endswith("_fname")}
            s["gt_img"] = read_image(named["gt_img_fname"])
            s["torso_img"] = read_image(named["torso_img_fname"])
            inline[split].append(s)
    os.makedirs(tmp / "inline" / "syn")
    np.save(tmp / "inline" / "syn" / "trainval_dataset.npy", inline, allow_pickle=True)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    states = {}
    try:
        for source, binary in (("files", root), ("inline", str(tmp / "inline"))):
            for stage, (cfg, extra) in STAGES.items():
                hp = (f"binary_data_dir={binary},video_id=syn,grid_size=16,individual_embedding_num=16,"
                      f"max_updates=1,val_check_interval=100,update_extra_interval=1,tb_log_interval=1,{extra}")
                if stage == "torso":
                    hp += f",head_model_dir={tmp / f'{source}_sr'}"
                states[source, stage] = run.main(["--config", os.path.join(REPO, "egs/datasets/May", cfg),
                                                  "--work_dir", str(tmp / f"{source}_{stage}"), "--device", "cpu",
                                                  "--hparams", hp])
    finally:
        torch.set_num_threads(n)
    return states


@pytest.mark.parametrize("stage", list(STAGES))
def test_cli_step_from_files_equals_in_record(cli_states, stage):
    """The stage's final state from the files equals the one from the
    decoded images in the record, leaf for leaf (the frame store, the
    per-step torso background, the SR task's full-size targets and the
    torso task's gt all read through `load_image`)."""
    a, b = cli_states["files", stage], cli_states["inline", stage]
    assert int(a.global_step) == int(b.global_step) == 1
    la, lb = _leaves(state_to_flax(a)), _leaves(state_to_flax(b))
    assert len(la) == len(lb) and all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(la, lb))
