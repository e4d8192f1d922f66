"""The port's quality instruments (`metrics/lmd.py`, `metrics/sync_scorer.py`)
and the weight bridge's 2-D `ConvTranspose` rule against the JAX package's,
on the CPU.

The detectors run on JAX's params (seeded inits moved off their values)
through the bridge, on the same seeded frames; their msgpack files cross
packages. The sync scorer: one step on the same params and the same drawn
indices against JAX's InfoNCE and `optax.adam`; `sync_confidence` on the
same params; its msgpack read by JAX's `load_params` and the reverse; and
a port-trained scorer (500 steps of batch 48, the torch generator's draws,
not JAX's) held by JAX's three controls (tests/test_sync_scorer.py's clip).
Tolerances: float32, 1e-4 of a tensor's largest |value| (landmarks, peak
probabilities, embeddings), 1e-5 relative for the loss."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from genefaceplusplus_tpu.metrics import lmd as j_lmd
from genefaceplusplus_tpu.metrics import sync_scorer as j_sync
from genefaceplusplus_tpu_torch.metrics import lmd as t_lmd
from genefaceplusplus_tpu_torch.metrics import sync_scorer as t_sync
from genefaceplusplus_tpu_torch.testing import sync_clip
from genefaceplusplus_tpu_torch.training.schedulers import OptaxAdam
from genefaceplusplus_tpu_torch.utils.convert_jax import convert_flax_params, export_flax_params, flax_leaves


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(n=3, size=512, seed=0):
    return np.random.RandomState(seed).randint(0, 255, (n, size, size, 3), dtype=np.uint8)


def _moved(params, seed, scale=0.05):
    """A params tree moved off its init (every leaf, scalars included)."""
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda x: np.asarray(x) + np.float32(scale) * np.asarray(rs.randn(*np.shape(x)), np.float32),
                        jax.tree.map(np.asarray, params))


def _close(got, want, rel, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err)


def _write_msgpack(path, params):
    with open(path, "wb") as f:
        f.write(serialization.msgpack_serialize(serialization.to_state_dict(params)))


# ---------------------------------------------------------------- the bridge


@pytest.mark.parametrize("size", [8, 7])
def test_conv_transpose_2d_crosses_the_bridge(size):
    """flax's stride-2 SAME `ConvTranspose` (3x3, unflipped kernel, output
    2n) equals the port's `ConvTranspose2d` cropped to 2n once the bridge
    flips both spatial axes into [in, out, kh, kw]; the export undoes it."""
    x = np.random.RandomState(size).randn(2, size, size, 5).astype(np.float32)

    class Up(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.ConvTranspose(4, (3, 3), strides=(2, 2))(x)

    params = _moved(Up().init(jax.random.PRNGKey(0), x), seed=1, scale=0.5)
    want = np.asarray(Up().apply(params, x))
    port = torch.nn.Module()
    port.deconvs = torch.nn.ModuleList([torch.nn.ConvTranspose2d(5, 4, 3, stride=2)])
    port.load_state_dict(convert_flax_params(params, port))
    got = t_lmd.LMDetectorV2._up(port.deconvs[0], torch.from_numpy(x).permute(0, 3, 1, 2))
    assert want.shape == (2, 2 * size, 2 * size, 4)
    _close(got.detach().permute(0, 2, 3, 1).numpy(), want, 1e-5, "ConvTranspose")
    back = export_flax_params(port)["params"]["ConvTranspose_0"]
    np.testing.assert_array_equal(back["kernel"], params["params"]["ConvTranspose_0"]["kernel"])


# ---------------------------------------------------------------- the LMD detectors


def test_to_detector_input_resizes_and_scales():
    """A 512^2 uint8 frame -> [128, 128, 3] float32 in [0, 1], within 1e-5 of
    JAX's (cv2's INTER_LINEAR); a 128^2 float frame passes unscaled."""
    frame = _frames(1)[0]
    x = t_lmd.to_detector_input(frame)
    assert x.shape == (128, 128, 3) and x.dtype == np.float32
    assert 0.0 <= x.min() and x.max() <= 1.0
    np.testing.assert_allclose(x, j_lmd.to_detector_input(frame), atol=1e-5)
    y = t_lmd.to_detector_input(np.full((128, 128, 3), 0.5, np.float32))
    assert np.allclose(y, 0.5)


@pytest.mark.parametrize("arch", ["v1", "v2"])
def test_detector_matches_jax(arch):
    """The detector on JAX's params: [2, 136] landmarks and, for v2, the [2,
    68] peak probabilities, each within 1e-4 of its largest |value|
    (measured 1.4e-5 on the probabilities: a peak near 1 magnifies the
    logits' float32 differences); for JAX's untrained init on a flat frame
    the probabilities sit at the 1/1024 floor."""
    x = np.random.RandomState(0).rand(2, 128, 128, 3).astype(np.float32)
    det = j_lmd.lm_detector(arch, return_conf=arch == "v2")
    init = det.init(jax.random.PRNGKey(0), np.zeros((1, 128, 128, 3), np.float32))
    params = _moved(init, seed=2)
    port = t_lmd.lm_detector(arch, return_conf=arch == "v2")
    port.load_state_dict(convert_flax_params(params, port))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    want = det.apply(params, x)
    if arch == "v1":
        _close(got, want, 1e-4, "v1 landmarks")
        return
    _close(got[0], want[0], 1e-4, "v2 landmarks")
    _close(got[1], want[1], 1e-4, "v2 peak probabilities")
    assert got[0].shape == (2, 136) and got[1].shape == (2, 68)
    port.load_state_dict(convert_flax_params(jax.tree.map(np.asarray, init), port))
    with torch.no_grad():
        _, conf = port(torch.zeros(2, 3, 128, 128))
    assert (conf > 0).all() and (conf <= 1).all() and conf.max() < 0.2


def test_unknown_arch_raises():
    with pytest.raises(ValueError):
        t_lmd.lm_detector("v3")


def test_detect_lmd_math_and_roundtrip(tmp_path):
    """JAX's detector file read by the port: its landmarks equal JAX's
    (1e-4); scored against its own prediction the distance is ~0, a 1/512
    shift of the gt reads 1 px, and the per-landmark matrix is [3, 68]."""
    det = j_lmd.lm_detector("v1")
    params = _moved(det.init(jax.random.PRNGKey(1), np.zeros((1, 128, 128, 3), np.float32)), seed=3)
    path = str(tmp_path / "det.msgpack")
    _write_msgpack(path, params)
    frames = _frames(3)
    pred = t_lmd.detect_lms(frames, path, arch="v1", device="cpu")
    _close(pred, j_lmd.detect_lms(frames, path, arch="v1"), 1e-4, "detect_lms")
    assert t_lmd.detect_lmd(frames, pred, path, arch="v1", device="cpu") < 1e-3
    gt = pred + np.array([1.0 / 512.0, 0.0])
    assert abs(t_lmd.detect_lmd(frames, gt, path, arch="v1", device="cpu") - 1.0) < 1e-3
    mat = t_lmd.detect_lmd(frames, gt, path, arch="v1", per_landmark=True, device="cpu")
    assert mat.shape == (3, 68) and np.allclose(mat, 1.0, atol=1e-3)


def test_detect_lmd_with_conf(tmp_path):
    """v2 from JAX's file with confidence: the [2, 68] distances and peak
    probabilities equal JAX's, each within 1e-4 of its largest |value|
    (measured 1.8e-5 on the probabilities)."""
    det = j_lmd.lm_detector("v2", return_conf=True)
    params = _moved(det.init(jax.random.PRNGKey(2), np.zeros((1, 128, 128, 3), np.float32)), seed=4)
    path = str(tmp_path / "det2.msgpack")
    _write_msgpack(path, params)
    frames, gt = _frames(2), np.zeros((2, 68, 2), np.float32)
    err, conf = t_lmd.detect_lmd(frames, gt, path, arch="v2", per_landmark=True, with_conf=True, device="cpu")
    err_j, conf_j = j_lmd.detect_lmd(frames, gt, path, arch="v2", per_landmark=True, with_conf=True)
    assert err.shape == conf.shape == (2, 68) and np.isfinite(err).all()
    _close(err, err_j, 1e-4, "distances")
    _close(conf, conf_j, 1e-4, "peak probabilities")


# ---------------------------------------------------------------- the sync scorer


@pytest.fixture(scope="module")
def clip():
    return sync_clip()


@pytest.fixture(scope="module")
def trained(clip):
    hubert, lms = clip
    return t_sync.train_sync_scorer(hubert, lms, steps=500, batch=48, seed=0, device="cpu")


def test_normalize_removes_pose(clip):
    _, lms = clip
    np.testing.assert_array_equal(t_sync.normalize_mouth_lms(lms), j_sync.normalize_mouth_lms(lms))
    shifted = lms + np.asarray([0.3, -0.2], np.float32)
    np.testing.assert_allclose(t_sync.normalize_mouth_lms(lms), t_sync.normalize_mouth_lms(shifted), atol=1e-5)
    np.testing.assert_allclose(t_sync.normalize_mouth_lms(lms), t_sync.normalize_mouth_lms(lms * 1.7), atol=1e-4)


def test_one_step_matches_jax(clip):
    """One InfoNCE step on the same params and the same drawn indices
    (anchors and shifted negatives) from the same seeded Adam moments (a
    first step from zero moments is lr x sign(g), which turns float noise
    in a near-zero gradient into a full lr): the loss (1e-5 relative), the
    updated params and first moments after one `optax.adam` step (atol
    1e-6)."""
    hubert, lms = clip
    aw, vw, _ = t_sync._windows(hubert, t_sync.normalize_mouth_lms(lms))
    rs = np.random.RandomState(0)
    idx = rs.randint(0, len(aw), 16)
    nidx = np.clip(idx + rs.choice([-1, 1], 16) * rs.randint(5, 16, 16), 0, len(aw) - 1)
    model = j_sync.SyncScorer()
    params = _moved(model.init(jax.random.PRNGKey(0), aw[:1], vw[:1]), seed=5, scale=0.01)

    def loss_fn(p):
        a, v = model.apply(p, aw[idx], vw[idx])
        _, v_neg = model.apply(p, aw[idx], vw[nidx])
        logits = jnp.concatenate([a @ v.T / 0.07, jnp.sum(a * v_neg, -1, keepdims=True) / 0.07], axis=1)
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.arange(16)).mean()

    loss_j, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tx = optax.adam(3e-4)
    rs = np.random.RandomState(7)
    mu = jax.tree.map(lambda x: np.asarray(rs.randn(*x.shape) * 1e-3, np.float32), params)
    nu = jax.tree.map(lambda x: np.asarray(rs.uniform(1e-4, 1e-3, x.shape), np.float32), params)
    state = (optax.ScaleByAdamState(count=jnp.asarray(10, jnp.int32), mu=mu, nu=nu), optax.EmptyState())
    upd, opt_j = tx.update(grads, state, params)
    new_j = optax.apply_updates(params, upd)

    port = t_sync.SyncScorer(hubert.shape[-1])
    port.load_state_dict(convert_flax_params(params, port))
    opt = OptaxAdam(port, 3e-4, collection=None)
    opt.load_optax({"0": {"count": np.asarray(10, np.int32), "mu": mu, "nu": nu}, "1": {}})
    opt.zero_grad()
    loss_t = t_sync.info_nce_loss(port, *(torch.from_numpy(a) for a in (aw[idx], vw[idx], vw[nidx])))
    loss_t.backward()
    opt.step()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    want = flax_leaves(jax.tree.map(np.asarray, new_j))
    for k, t in port.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[k][1], atol=1e-6, err_msg=k)
    mu = flax_leaves(jax.tree.map(np.asarray, opt_j[0].mu))
    got_mu = flax_leaves(opt.export_optax()["0"]["mu"])
    assert set(got_mu) == set(mu)
    for k in mu:
        np.testing.assert_allclose(got_mu[k][1], mu[k][1], atol=1e-6, err_msg=k)


def test_sync_confidence_and_msgpack_match_jax(clip, tmp_path):
    """sync_confidence on JAX's params: the curve within 2e-4 (both round
    to 4 decimals), the offset equal; the port's msgpack is JAX's bytes and
    JAX's `load_params` restores it; the port's `load_params` reads JAX's."""
    hubert, lms = clip
    params = _moved(j_sync.SyncScorer().init(jax.random.PRNGKey(1), hubert[None, :20], np.zeros((1, 5, 40))),
                    seed=6, scale=0.02)
    got = t_sync.sync_confidence(params, hubert, lms, device="cpu")
    want = j_sync.sync_confidence(params, hubert, lms)
    assert got["offset"] == want["offset"]
    np.testing.assert_allclose(got["curve"], want["curve"], atol=2e-4)
    port_path, jax_path = str(tmp_path / "port.msgpack"), str(tmp_path / "jax.msgpack")
    t_sync.save_params(params, port_path)
    j_sync.save_params(params, jax_path)
    assert open(port_path, "rb").read() == open(jax_path, "rb").read()
    back = j_sync.load_params(port_path, audio_dim=hubert.shape[-1])
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back), jax.tree_util.tree_leaves_with_path(params)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=jax.tree_util.keystr(path))
    mine = t_sync.load_params(jax_path, audio_dim=hubert.shape[-1])
    assert set(flax_leaves(mine)) == set(flax_leaves(params))
    with pytest.raises(ValueError):
        t_sync.load_params(jax_path, audio_dim=hubert.shape[-1] + 1)


def test_aligned_scores_high_at_zero_offset(trained, clip):
    hubert, lms = clip
    res = t_sync.sync_confidence(trained, hubert, lms, device="cpu")
    assert abs(res["offset"]) <= 1, res
    assert res["confidence"] > 0.15, res


def test_shuffled_audio_collapses(trained, clip):
    hubert, lms = clip
    rng = np.random.RandomState(3)
    blocks = hubert.reshape(-1, 2, hubert.shape[-1])  # 2-frame blocks keep the 50 Hz pairs
    hub_shuf = blocks[rng.permutation(len(blocks))].reshape(hubert.shape)
    aligned = t_sync.sync_confidence(trained, hubert, lms, device="cpu")["confidence"]
    shuffled = t_sync.sync_confidence(trained, hub_shuf, lms, device="cpu")["confidence"]
    assert shuffled < 0.5 * aligned, (aligned, shuffled)


def test_frozen_mouth_carries_no_signal(trained, clip):
    hubert, lms = clip
    frozen = np.repeat(lms[:1], len(lms), 0)
    res = t_sync.sync_confidence(trained, hubert, frozen, device="cpu")
    aligned = t_sync.sync_confidence(trained, hubert, lms, device="cpu")["confidence"]
    assert res["confidence"] < 0.5 * aligned, (aligned, res["confidence"])
