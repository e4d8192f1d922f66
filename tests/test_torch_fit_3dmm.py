"""The port's 3DMM fit (`genefaceplusplus_tpu_torch/data/fit_3dmm.py`) against
JAX's `genefaceplusplus_tpu/data/fit_3dmm.py` on the same seeded landmark
tracks, on the stand-in basis (lm68 and mediapipe K = 468).

- `landmark_weights` and `laplacian_loss`: exact (float32 rounding).
- The loss's gradients at a seeded point: within 1e-5 of each tensor's
  largest entry (measured 1.5e-6).
- After 3 + 3 iterations: each coefficient tensor within 1e-3 of its largest
  entry of JAX's (measured 7e-4: exp, K = 468), and the port within 1e-4 of
  a float64 run of itself (measured 5.2e-5). Adam divides each gradient
  entry by its own magnitude: entries near its eps turn float32 rounding
  into visible steps, and JAX's float32 run lies as far from float64 as
  from the port.
- At the defaults (200 + 200): both losses within 1e-5 relative (measured
  2.5e-6) and the reprojected landmarks within 5e-5 of the [0, 1] frame
  (measured 1.6e-5, 0.008 px at 512^2).
- JAX's `test_fit_3dmm_recovers_pose` case, through the port.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genefaceplusplus_tpu.data import fit_3dmm as J
from genefaceplusplus_tpu.data.face3d import Face3DHelper as JHelper
from genefaceplusplus_tpu_torch.data import fit_3dmm as P
from genefaceplusplus_tpu_torch.data.face3d import Face3DHelper as PHelper

KEYS = ("id", "exp", "euler", "trans")


def _track(mode: str, T: int = 7, seed: int = 0) -> np.ndarray:
    """Landmarks of seeded coefficients through JAX's stand-in basis, with noise."""
    h = JHelper.synthetic(mode)
    rng = np.random.RandomState(seed)
    lm = np.asarray(h.reconstruct_lm2d(
        jnp.zeros((T, 80)), jnp.asarray(rng.randn(T, 64) * 0.3, jnp.float32),
        jnp.asarray(rng.randn(T, 3) * 0.05, jnp.float32), jnp.asarray(rng.randn(T, 3) * 0.05, jnp.float32)))
    return (lm + rng.randn(*lm.shape).astype(np.float32) * 0.002).astype(np.float32)


def _helper64(mode: str) -> PHelper:
    h = PHelper.synthetic(mode)
    for name in ("key_mean_shape", "key_id_base", "key_exp_base", "persc_proj"):
        setattr(h, name, getattr(h, name).double())
    return h


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max())


@pytest.mark.parametrize("K", [68, 131, 468])
def test_landmark_weights_equal_jax(K):
    np.testing.assert_array_equal(P.landmark_weights(K), J.landmark_weights(K))


@pytest.mark.parametrize("T", [1, 2, 3, 9])
def test_laplacian_loss_equals_jax(T):
    x = np.random.RandomState(T).randn(T, 5).astype(np.float32)
    np.testing.assert_allclose(float(P.laplacian_loss(torch.as_tensor(x))), float(J.laplacian_loss(jnp.asarray(x))),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("mode", ["lm68", "mediapipe"])
def test_loss_gradients_match_jax(mode):
    import jax

    jh, ph = JHelper.synthetic(mode), PHelper.synthetic(mode)
    rng = np.random.RandomState(1)
    T, K = 6, jh.n_keypoints
    lm = (rng.rand(T, K, 2) * 0.1 + 0.45).astype(np.float32)
    p = {"id": rng.randn(1, 80), "exp": rng.randn(T, 64), "euler": rng.randn(T, 3) * 0.5, "trans": rng.randn(T, 3) * 0.5}
    p = {k: (v * 0.1).astype(np.float32) for k, v in p.items()}
    w = J.landmark_weights(K)[None, :, None]

    def jax_loss(q):
        pred = jh.reconstruct_lm2d(jnp.broadcast_to(q["id"], (T, 80)), q["exp"], q["euler"], q["trans"])
        return (w * (pred - lm) ** 2).mean() + 0.3 * J.laplacian_loss(q["exp"])

    jl, jg = jax.value_and_grad(jax_loss)({k: jnp.asarray(v) for k, v in p.items()})
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    pred = ph.reconstruct_lm2d(tp["id"].expand(T, 80), tp["exp"], tp["euler"], tp["trans"])
    tl = (torch.as_tensor(w) * (pred - torch.as_tensor(lm)) ** 2).mean() + 0.3 * P.laplacian_loss(tp["exp"])
    tl.backward()
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    for k in KEYS:
        assert _rel(tp[k].grad.numpy(), np.asarray(jg[k])) <= 1e-5, k


@pytest.mark.parametrize("mode", ["lm68", "mediapipe"])
def test_few_iterations_match_jax(mode):
    lm = _track(mode)
    cfg = dict(iters_pose=3, iters_joint=3)
    jax_fit = J.fit_3dmm_for_video(lm, JHelper.synthetic(mode), J.FitConfig(**cfg))
    port = P.fit_3dmm_for_video(lm, PHelper.synthetic(mode), P.FitConfig(**cfg))
    f64 = P.fit_3dmm_for_video(lm, _helper64(mode), P.FitConfig(**cfg))
    for k in KEYS:
        assert port[k].shape == jax_fit[k].shape and port[k].dtype == np.float32
        assert _rel(port[k], jax_fit[k]) <= 1e-3, k
        assert _rel(port[k], f64[k]) <= 1e-4, k
    np.testing.assert_array_equal(port["id"], np.tile(port["id"][:1], (len(lm), 1)))
    for k in ("final_loss", "pose_loss"):
        assert abs(port[k] - jax_fit[k]) <= 1e-4 * jax_fit[k], k


@pytest.mark.parametrize("mode", ["lm68", "mediapipe"])
def test_defaults_match_jax(mode):
    lm = _track(mode)
    jh = JHelper.synthetic(mode)
    jax_fit = J.fit_3dmm_for_video(lm, jh)
    port = P.fit_3dmm_for_video(lm, PHelper.synthetic(mode))
    for k in ("final_loss", "pose_loss"):
        assert abs(port[k] - jax_fit[k]) <= 1e-5 * jax_fit[k], k
    assert port["final_loss"] < port["pose_loss"]

    def reproj(c):
        return np.asarray(jh.reconstruct_lm2d(*(jnp.asarray(c[k]) for k in KEYS)))

    assert np.abs(reproj(port) - reproj(jax_fit)).max() <= 5e-5


def test_fit_recovers_pose():
    """JAX's tests/test_data_pipeline.py::test_fit_3dmm_recovers_pose, through the port."""
    h = PHelper.synthetic("lm68")
    T = 5
    rng = np.random.RandomState(0)
    true = {
        "id": torch.as_tensor(rng.randn(1, 80).astype(np.float32) * 0.3),
        "exp": torch.as_tensor(rng.randn(T, 64).astype(np.float32) * 0.2),
        "euler": torch.as_tensor(rng.randn(T, 3).astype(np.float32) * 0.1),
        "trans": torch.as_tensor(rng.randn(T, 3).astype(np.float32) * 0.05),
    }
    target = h.reconstruct_lm2d(true["id"].expand(T, 80), true["exp"], true["euler"], true["trans"]).numpy()
    cfg = P.FitConfig(iters_pose=100, iters_joint=300, lambda_lap=0.0, lambda_reg_id=0.0, lambda_reg_exp=0.0)
    fit = P.fit_3dmm_for_video(target, h, cfg)
    assert fit["final_loss"] < fit["pose_loss"]
    assert fit["final_loss"] < 5e-4
    assert fit["exp"].shape == (T, 64)


def test_init_and_float64():
    """`init` seeds the coefficients as JAX's does; the fit runs in the
    basis's float type and returns float32 arrays."""
    lm = _track("lm68", T=4)
    init = {"euler": np.full((4, 3), 0.01, np.float32), "unused": np.zeros(3)}
    cfg = dict(iters_pose=2, iters_joint=0)
    port = P.fit_3dmm_for_video(lm, _helper64("lm68"), P.FitConfig(**cfg), init=init)
    jax_fit = J.fit_3dmm_for_video(lm, JHelper.synthetic("lm68"), J.FitConfig(**cfg), init=init)
    assert all(port[k].dtype == np.float32 for k in KEYS)
    for k in ("euler", "trans"):
        assert _rel(port[k], jax_fit[k]) <= 1e-4, k
    np.testing.assert_array_equal(port["exp"], 0.0)
    assert np.isnan(P.fit_3dmm_for_video(lm, PHelper.synthetic("lm68"), P.FitConfig(iters_pose=0, iters_joint=0))
                    ["final_loss"])


def test_exp_displacement_px():
    """chip_smoke.py's hold on exp: the landmark displacement that one
    fit's exp alone makes against another's, with the other's id and pose,
    in pixels at 512^2; equal to the same reprojection through JAX's helper,
    zero for equal exp, and shrinking with the change of exp (the
    landmarks are linear in exp before the projection)."""
    rng = np.random.RandomState(3)
    T = 5
    ref = {"id": rng.randn(T, 80).astype(np.float32) * 0.2, "exp": rng.randn(T, 64).astype(np.float32) * 0.3,
           "euler": rng.randn(T, 3).astype(np.float32) * 0.05, "trans": rng.randn(T, 3).astype(np.float32) * 0.05}
    fit = dict(ref, exp=ref["exp"] + rng.randn(T, 64).astype(np.float32) * 0.01,
               euler=ref["euler"] + 0.2, trans=ref["trans"] - 0.3)  # the fit's pose is not read
    h, jh = PHelper.synthetic("lm68"), JHelper.synthetic("lm68")
    got = P.exp_displacement_px(h, fit, ref, 512)

    def j_lm(exp):
        return np.asarray(jh.reconstruct_lm2d(*(jnp.asarray(v) for v in (ref["id"], exp, ref["euler"], ref["trans"]))))

    want = float(np.abs(j_lm(fit["exp"]).astype(np.float64) - j_lm(ref["exp"])).max() * 512)
    assert want > 0.05 and abs(got - want) <= 1e-3 * want + 1e-3
    assert P.exp_displacement_px(h, ref, ref, 512) == 0.0
    small = dict(ref, exp=ref["exp"] + (fit["exp"] - ref["exp"]) * 1e-3)
    assert 0 < P.exp_displacement_px(h, small, ref, 512) <= 2e-3 * got
