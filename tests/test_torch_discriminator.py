"""The port's discriminators (`models/eg3d_discriminator.py`,
`models/dual_discriminator.py`), the EG3D camera label
(`data/eg3d_convention.py`) and the discriminator's converter
(`convert_eg3d_disc`) against the JAX package's, on the CPU.

The EG3D discriminator runs at 32^2 with channel_base 512, channel_max 64
and 2 mapping layers (tests/test_eg3d_discriminator.py's size); the same
seeded numpy inputs and the same weights (JAX's, through the weight
bridge) go through both. Tolerance: float32, 1e-4 of a tensor's largest
|value| (measured under 1e-6 of it on the logits and feature maps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genefaceplusplus_tpu.data.eg3d_convention import eg3d_camera_from_euler_trans as j_camera
from genefaceplusplus_tpu.models import dual_discriminator as j_dual
from genefaceplusplus_tpu.models import eg3d_discriminator as j_eg3d
from genefaceplusplus_tpu.utils import convert_torch_ckpt as j_cvt
from genefaceplusplus_tpu.utils.ckpt import restore_into
from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset, synthetic
from genefaceplusplus_tpu_torch.data.eg3d_convention import eg3d_camera_from_euler_trans as t_camera
from genefaceplusplus_tpu_torch.models import dual_discriminator as t_dual
from genefaceplusplus_tpu_torch.models import eg3d_discriminator as t_eg3d
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRFConfig
from genefaceplusplus_tpu_torch.testing import reference_disc_state
from genefaceplusplus_tpu_torch.training.tasks.sr_task import SRHeadNeRFTask, SRTaskConfig
from genefaceplusplus_tpu_torch.utils import convert_torch_ckpt as t_cvt
from genefaceplusplus_tpu_torch.utils.convert_jax import convert_flax_params, export_flax_params

RES = 32  # blocks at 32, 16, 8; the epilogue at 4
SMALL = dict(img_resolution=RES, channel_base=512, channel_max=64, mapping_layers=2)
REL = 1e-4


def _inputs(b=2, seed=0):
    rng = np.random.RandomState(seed)
    return ((rng.rand(b, RES, RES, 3) * 2 - 1).astype(np.float32),
            (rng.rand(b, RES // 2, RES // 2, 3) * 2 - 1).astype(np.float32),
            rng.randn(b, 25).astype(np.float32))


def _nchw(a):
    return torch.from_numpy(np.asarray(a)).permute(0, 3, 1, 2)


def _close(got: torch.Tensor, want, what: str, nhwc: bool = True):
    got = got.detach()
    got = (got.permute(0, 2, 3, 1) if nhwc and got.dim() == 4 else got).numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max(), (what, err, np.abs(want).max())


def _pair(seed=0):
    """JAX's discriminator with seeded params (init, then moved off it) and
    the port's holding the same params."""
    img, raw, cam = _inputs()
    disc = j_eg3d.EG3DDualDiscriminator(**SMALL)
    params = disc.init(jax.random.PRNGKey(seed), img, raw, cam)
    rs = np.random.RandomState(seed + 1)
    params = jax.tree.map(lambda x: np.asarray(x) + np.float32(0.1) * rs.randn(*np.shape(x)).astype(np.float32),
                          params)
    port = t_eg3d.EG3DDualDiscriminator(**SMALL)
    port.load_state_dict(convert_flax_params(params, port))
    return disc, params, port


def test_forward_matches_jax():
    """Logits and the three feature maps ([B, C, 16/8/4]) at N = 2; the
    camera label noise draws only with a generator and a batch above one."""
    disc, params, port = _pair()
    img, raw, cam = _inputs()
    lj, fj = disc.apply(params, img, raw, cam)
    lt, ft = port(_nchw(img), _nchw(raw), torch.from_numpy(cam))
    _close(lt, lj, "logits")
    assert [f.shape[-1] for f in ft] == [16, 8, 4] and len(ft) == len(fj)
    for i, (a, b) in enumerate(zip(ft, fj)):
        _close(a, b, f"feature map {i}")
    noisy, _ = port(_nchw(img), _nchw(raw), torch.from_numpy(cam), c_noise=1.0,
                    generator=torch.Generator().manual_seed(0))
    assert not torch.allclose(noisy, lt)
    one, _ = port(_nchw(img[:1]), _nchw(raw[:1]), torch.from_numpy(cam[:1]), c_noise=1.0,
                  generator=torch.Generator().manual_seed(0))
    plain, _ = port(_nchw(img[:1]), _nchw(raw[:1]), torch.from_numpy(cam[:1]))
    assert torch.equal(one, plain)
    fm = t_eg3d.feature_matching_loss(ft, [f + 1.0 for f in ft])
    np.testing.assert_allclose(float(fm.detach()), 1.0, atol=1e-5)


def test_feature_matching_input_gradient_matches_jax():
    """The feature-matching loss of (image, raw) against fixed real maps:
    its value (1e-5 relative) and its gradients with respect to both images
    (1e-4 of the largest entry), as the SR step takes them."""
    disc, params, port = _pair(seed=2)
    img, raw, cam = _inputs(seed=3)
    rimg, rraw, _ = _inputs(seed=4)
    _, real_j = disc.apply(params, rimg, rraw, cam)

    def loss_j(a, b):
        _, f = disc.apply(params, a, b, cam)
        return j_eg3d.feature_matching_loss(f, real_j)

    vj, (gi_j, gr_j) = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1)))(img, raw)
    ti, tr = _nchw(img).requires_grad_(True), _nchw(raw).requires_grad_(True)
    _, real_t = port(_nchw(rimg), _nchw(rraw), torch.from_numpy(cam))
    _, fake_t = port(ti, tr, torch.from_numpy(cam))
    vt = t_eg3d.feature_matching_loss(fake_t, real_t)
    vt.backward()
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-5)
    _close(ti.grad, gi_j, "image gradient")
    _close(tr.grad, gr_j, "raw gradient")


def test_equal_dense_matches_jax_and_formula():
    """y = x @ (w.T * lr / sqrt(in)) + b * lr at lr multiplier 0.01."""
    layer = j_eg3d.EqualDense(6, activation="linear", lr_multiplier=0.01)
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    p = layer.init(jax.random.PRNGKey(1), x)
    p = {"params": {"weight": np.asarray(p["params"]["weight"]), "bias": np.linspace(-1, 1, 6, dtype=np.float32)}}
    port = t_eg3d.EqualDense(4, 6, lr_multiplier=0.01)
    port.load_state_dict(convert_flax_params(p, port))
    w, b = p["params"]["weight"], p["params"]["bias"]
    want = x @ (w.T * (0.01 / np.sqrt(4))) + b * 0.01
    got = port(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(layer.apply(p, x)), atol=1e-6)


@pytest.mark.parametrize("n", [4, 1])
def test_minibatch_std_matches_jax(n):
    """The NCHW minibatch std equals JAX's NHWC one (G = min(2, N)), and at
    N = 4 the reference's formula: batch element b = g n + i carries slot
    i's statistic."""
    x = np.random.RandomState(3).randn(n, 4, 4, 8).astype(np.float32)
    got = t_eg3d.minibatch_std(_nchw(x), group_size=2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(j_eg3d.minibatch_std(jnp.asarray(x), group_size=2)), atol=1e-6)
    assert got.shape == (n, 4, 4, 9) and np.array_equal(got[..., :8], x)
    if n == 4:
        y = x.transpose(0, 3, 1, 2).reshape(2, 2, 1, 8, 4, 4)
        y = np.sqrt(((y - y.mean(0)) ** 2).mean(0) + 1e-8).mean(axis=(2, 3, 4))
        stat = np.tile(y.reshape(2), 2)
        for b in range(4):
            np.testing.assert_allclose(got[b, :, :, 8], stat[b], atol=1e-5)
    else:
        np.testing.assert_allclose(got[..., 8], 1e-4, rtol=1e-3)  # a group of one: sqrt(0 + 1e-8)


def test_conversion_strict_restore_matches_jax():
    """The reference's torch layout (testing.reference_disc_state, with the
    buffers the map ignores): the port's convert_eg3d_disc gives JAX's tree
    bit for bit; the port's discriminator takes every leaf (a missing or
    extra leaf raises), JAX's restores it strictly, and both forwards agree
    on it and differ from the init."""
    state = reference_disc_state(seed=7, **SMALL)
    t_out = t_cvt.convert_eg3d_disc(state, img_resolution=RES)
    j_out = j_cvt.convert_eg3d_disc(state, img_resolution=RES)
    assert t_out["n_mapping_layers"] == j_out["n_mapping_layers"] == 2
    t_leaves = dict(jax.tree_util.tree_leaves_with_path(t_out["params"]))
    j_leaves = dict(jax.tree_util.tree_leaves_with_path(j_out["params"]))
    assert set(t_leaves) == set(j_leaves)
    for k, a in j_leaves.items():
        assert np.asarray(a).tobytes() == np.asarray(t_leaves[k]).tobytes(), k

    img, raw, cam = _inputs()
    disc = j_eg3d.EG3DDualDiscriminator(**SMALL)
    template = disc.init(jax.random.PRNGKey(0), img, raw, cam)
    restored = restore_into(template, {"params": t_out["params"]}, strict=True)
    port = t_eg3d.EG3DDualDiscriminator(**SMALL, generator=torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in port.state_dict().items()}
    port.load_state_dict(convert_flax_params({"params": t_out["params"]}, port))
    assert all(not torch.equal(init[k], v) for k, v in port.state_dict().items())
    lj, _ = disc.apply(restored, img, raw, cam)
    lt, _ = port(_nchw(img), _nchw(raw), torch.from_numpy(cam))
    _close(lt, lj, "logits of the converted disc")
    assert not np.allclose(np.asarray(lj), np.asarray(disc.apply(template, img, raw, cam)[0]))
    exported = export_flax_params(port)["params"]
    assert set(dict(jax.tree_util.tree_leaves_with_path(exported))) == set(t_leaves)
    broken = jax.tree.map(lambda x: x, t_out["params"])
    del broken["mapping"]["fc1"]
    with pytest.raises(KeyError, match="without a flax leaf"):
        convert_flax_params({"params": broken}, port)


def test_compact_dual_discriminator_matches_jax():
    """The compact stack (base 8, three downsamples) on JAX's params: the
    logits (its NHWC flatten) and the three feature maps; the FM loss
    against zeros is positive."""
    rng = np.random.RandomState(5)
    img = rng.rand(2, RES, RES, 3).astype(np.float32)
    raw = rng.rand(2, RES // 2, RES // 2, 3).astype(np.float32)
    cam = rng.randn(2, 25).astype(np.float32)
    disc = j_dual.DualDiscriminator(base_channels=8, n_down=3)
    params = jax.tree.map(np.asarray, disc.init(jax.random.PRNGKey(3), img, raw, cam))
    lj, fj = disc.apply(params, img, raw, cam)
    port = t_dual.DualDiscriminator(RES, base_channels=8, n_down=3)
    port.load_state_dict(convert_flax_params(params, port))
    lt, ft = port(_nchw(img), _nchw(raw), torch.from_numpy(cam))
    _close(lt, lj, "logits")
    assert len(ft) == len(fj) == 3
    for i, (a, b) in enumerate(zip(ft, fj)):
        _close(a, b, f"feature map {i}")
    assert float(t_dual.feature_matching_loss(ft, [torch.zeros_like(f) for f in ft])) > 0


def test_eg3d_camera_convention_matches_jax():
    """Seeded euler / trans: JAX's labels to 1e-6 (float32 rotations); at
    zero pose the pose's last row is [0, 0, 0, 1], the intrinsics' centre
    0.5, and the camera sits in front of the face."""
    rng = np.random.RandomState(0)
    euler, trans = (rng.randn(5, 3) * 0.2).astype(np.float32), (rng.randn(5, 3) * 0.1).astype(np.float32)
    got = t_camera(euler, trans)
    assert got.dtype == np.float32 and got.shape == (5, 25)
    np.testing.assert_allclose(got, j_camera(euler, trans), atol=1e-6)
    cam = t_camera(np.zeros((2, 3), np.float32), np.zeros((2, 3), np.float32))
    pose, K = cam[0, :16].reshape(4, 4), cam[0, 16:].reshape(3, 3)
    np.testing.assert_allclose(pose[3], [0, 0, 0, 1], atol=1e-6)
    np.testing.assert_allclose(K[0, 2], 0.5)
    np.testing.assert_allclose(K[2, 2], 1.0)
    assert 0.5 < np.linalg.norm(pose[:3, 3]) < 5.0


def test_missing_disc_checkpoint_fails_loudly(tmp_path):
    """A named disc_model_dir without a checkpoint raises, as the
    reference's strict load does, for either architecture."""
    ds = RADNeRFDataset(synthetic(num_frames=6, H=32, W=32), smo_win_size=3, with_sr=True)
    cfg = RADNeRFConfig(grid_size=16, smo_win_size=3, individual_embedding_num=6)
    for arch in ("eg3d", "compact"):
        tcfg = SRTaskConfig(n_rays=256, lambda_dual_fm=0.1, disc_arch=arch, disc_model_dir=str(tmp_path / "nope"))
        with pytest.raises(FileNotFoundError, match="nope"):
            SRHeadNeRFTask(ds, cfg, tcfg, seed=0, device="cpu")
