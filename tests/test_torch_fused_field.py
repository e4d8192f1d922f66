"""The port's fused field (plain version on the CPU) vs the JAX Pallas
kernel and the JAX model field, at the flagship width, N=300 (not a
tile multiple). The CUDA kernel itself is compared with the plain version
on the card by tests/test_torch_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genefaceplusplus_tpu.models.radnerf import RADNeRF as JRADNeRF
from genefaceplusplus_tpu.models.radnerf import RADNeRFConfig as JConfig
from genefaceplusplus_tpu.ops.pallas.fused_field import fused_field_eval, weights_from_params as j_weights
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF as TRADNeRF
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRFConfig as TConfig
from genefaceplusplus_tpu_torch.ops import fused_field as ff
from genefaceplusplus_tpu_torch.utils.convert_jax import convert_flax_params

N = 300
FLAGSHIP = dict(smo_win_size=3, individual_embedding_num=16)


@pytest.fixture(scope="module")
def setup():
    jm = JRADNeRF(JConfig(**FLAGSHIP))
    rs = np.random.RandomState(0)
    cond = rs.randn(3, 1, 204).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((8, 3)), jnp.ones((8, 3)), jnp.asarray(cond))
    tm = TRADNeRF(TConfig(**FLAGSHIP))
    tm.load_state_dict(convert_flax_params(jax.tree.map(np.asarray, params), tm))
    xyz = rs.uniform(-1, 1, (N, 3)).astype(np.float32)
    d = rs.randn(N, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cf = np.asarray(jm.apply(params, jnp.asarray(cond), method=JRADNeRF.cal_cond_feat))
    ind = np.asarray(jm.apply(params, 0, method=JRADNeRF.get_individual_code))
    w_t = ff.weights_from_params(tm, bound=1.0)
    with torch.no_grad():
        ab, cb = ff.bias_rows(torch.from_numpy(cf), torch.from_numpy(ind), w_t)
        plain = [x.numpy() for x in ff.fused_field_plain(
            torch.from_numpy(xyz), torch.from_numpy(d), ab, cb, w_t)]
    return dict(jm=jm, params=params, tm=tm, xyz=xyz, d=d, cf=cf, ind=ind, w_t=w_t,
                ab=ab, cb=cb, plain=plain)


def test_folded_weights_equal_jax(setup):
    w_j = j_weights(setup["params"], setup["jm"].cfg, bound=1.0)
    for name, a, b in zip(w_j._fields, w_j, setup["w_t"]):
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), name
        np.testing.assert_array_equal(b.float().numpy(), np.asarray(a.astype(jnp.float32)), err_msg=name)


def test_plain_matches_pallas_interpret(setup):
    """Both are bf16-in / f32-accumulate chains with the same rounding
    points; only float32 summation order differs, which can flip a bf16
    rounding of an activation. Bounds (a few bf16 steps at the output):
    log-sigma 0.05, rgb 0.02, amb 0.005, mean |d rgb| < 2e-4."""
    s = setup
    w_j = j_weights(s["params"], s["jm"].cfg, bound=1.0)
    out_j = fused_field_eval(jnp.asarray(s["xyz"]), jnp.asarray(s["d"]), jnp.asarray(s["cf"]),
                             jnp.asarray(s["ind"]), w_j, amb_dim=3, tile=256, interpret=True)
    sig_j, rgb_j, amb_j = (np.asarray(x) for x in out_j)
    sig_t, rgb_t, amb_t = s["plain"]
    np.testing.assert_allclose(np.log(sig_t), np.log(sig_j), atol=0.05, rtol=0)
    np.testing.assert_allclose(rgb_t, rgb_j, atol=0.02, rtol=0)
    np.testing.assert_allclose(amb_t, amb_j, atol=0.005, rtol=0)
    assert np.abs(rgb_t - rgb_j).mean() < 2e-4


def test_plain_matches_model_field(setup):
    """bf16 fused field vs the f32 model field: tests/test_fused_field.py's
    tolerances (log-sigma 0.3, rgb 0.08, amb 0.05, correlation > 0.98)."""
    s = setup
    out = s["jm"].apply(s["params"], jnp.asarray(s["xyz"]), jnp.asarray(s["d"]),
                        jnp.asarray(s["cf"]), jnp.asarray(s["ind"]), method=JRADNeRF.field)
    sig_r, rgb_r, amb_r = (np.asarray(x) for x in out)
    sig, rgb, amb = s["plain"]
    np.testing.assert_allclose(np.log(sig + 1e-6), np.log(sig_r + 1e-6), atol=0.3)
    np.testing.assert_allclose(rgb, rgb_r, atol=0.08)
    np.testing.assert_allclose(amb, amb_r, atol=0.05)
    for a, b in ((rgb, rgb_r), (amb, amb_r)):
        assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.98


def test_cpu_tensor_routes_to_plain(setup):
    s = setup
    before = ff.fused_field.launches
    with torch.no_grad():
        out = ff.fused_field(torch.from_numpy(s["xyz"]), torch.from_numpy(s["d"]), s["ab"], s["cb"], s["w_t"])
    for a, b in zip(out, s["plain"]):
        np.testing.assert_array_equal(a.numpy(), b)
    assert ff.fused_field.launches == before  # the plain path launches nothing


def test_other_devices_raise_instead_of_falling_back(setup):
    s = setup
    meta = torch.empty((N, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ff.fused_field(meta, meta, s["ab"], s["cb"], s["w_t"])


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(ff, "BUILD_DIR", tmp_path / "kernels")  # no cached library
    monkeypatch.setattr(ff, "NVCC_HOMES", ())
    monkeypatch.setenv("PATH", str(tmp_path))
    for var in ("CUDA_HOME", "CUDA_PATH"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ff.build_fused_field()
    assert not (tmp_path / "kernels").exists()


def test_flagship_width_is_enforced():
    with pytest.raises(ValueError, match="flagship"):
        ff.weights_from_params(TRADNeRF(TConfig(hidden_dim_sigma=64, individual_embedding_num=4)))


def _sentinel_weights():
    """Random FieldWeights whose entries the forward kernel does not read
    (cond / ind / padding rows, padded columns) hold 7.0, which no live
    entry (|x| < 1) does."""
    g = torch.Generator().manual_seed(11)
    w = {name: (torch.rand(shape, generator=g) * 2 - 1).to(dtype) for name, (shape, dtype) in ff.FIELD_SHAPES.items()}
    for name, sl in (("amb_w1", np.s_[256:]), ("amb_w3", np.s_[:, 3:]), ("sig_w3", np.s_[:, 129:]),
                     ("col_w1", np.s_[144:]), ("col_w2", np.s_[:, 3:])):
        w[name][sl] = 7.0
    return ff.FieldWeights(**w)


def _unpack(packed, n, k, off):
    """Operand [n, k] of one layer, read back from the flat stream by the
    layout's index formula (csrc/sm90.cuh), independently of pack_kmajor."""
    s, r, kk = np.meshgrid(np.arange(k // 16), np.arange(n), np.arange(16), indexing="ij")
    idx = off + s * n * 16 + ((r // 8) * 2 + kk // 8) * 64 + (r % 8) * 8 + kk % 8
    out = np.full((n, k), np.nan, np.float32)
    out[r, 16 * s + kk] = packed[idx]
    return out


@pytest.mark.parametrize("layer", [name for name, *_ in ff.FWD_LAYERS])
def test_packed_weights_hold_every_live_entry(layer):
    w = _sentinel_weights()
    packed = ff.pack_field_weights(w).float().numpy()
    assert packed.size == sum(n * k for _, n, k, _ in ff.FWD_LAYERS) == 152_576
    assert not (packed == 7.0).any()  # no padding, cond or ind row reaches the stream
    off = 0
    for name, n, k, _ in ff.FWD_LAYERS:
        if name == layer:
            break
        off += n * k
    _, n, k, _ = ff.FWD_LAYERS[[x[0] for x in ff.FWD_LAYERS].index(layer)]
    got = _unpack(packed, n, k, off)
    f = {name: getattr(w, name).float().numpy() for name in ff.FIELD_SHAPES}
    want = {
        "amb_w1": f["amb_w1"][:256].T, "amb_w2": f["amb_w2"].T, "sig_w1": f["sig_w1"].T,
        "sig_w2": f["sig_w2"].T, "col_w1": f["col_w1"][:144].T,
        "amb_w3": np.pad(f["amb_w3"][:, :3].T, ((0, 5), (0, 0))),
        "col_w2": np.pad(f["col_w2"][:, :3].T, ((0, 5), (0, 0))),
        "sig_w3": np.concatenate([f["sig_w3"][:, 1:129].T, f["sig_w3"][:, :1].T, np.zeros((7, 128), np.float32)]),
    }[layer]
    np.testing.assert_array_equal(got, want)  # bit for bit: bf16 values, exact in float32


def _chunks():
    """(byte offset, bytes) of each chunk of the stream, as the kernel walks
    FWD_LAYERS (its SPEC): whole k16 steps, layer after layer."""
    out, off = [], 0
    for _, n, k, chunk in ff.FWD_LAYERS:
        for _ in range(k // 16 // chunk):
            out.append((off, chunk * n * 32))
            off += chunk * n * 32
    return out


def test_weight_chunks_are_what_the_layout_says():
    chunks = _chunks()
    assert len(chunks) == sum(k // 16 // c for _, _, k, c in ff.FWD_LAYERS) == 21
    off, i = 0, 0
    for _, n, k, c in ff.FWD_LAYERS:
        layer_start = off
        for j in range(k // 16 // c):
            assert chunks[i] == (layer_start + j * c * n * 32, c * n * 32)  # whole k16 steps of one layer
            assert chunks[i][0] % 16 == 0 and chunks[i][1] % 16 == 0  # bulk-copy alignment
            off += chunks[i][1]
            i += 1
    assert off == ff.pack_field_weights(_sentinel_weights()).numel() * 2 == 305_152
    assert max(b for _, b in chunks) == 4 * 136 * 32  # the kernel's stage size (sig_w3's chunk)


def test_packed_weights_are_cached_per_field_weights():
    w = _sentinel_weights()
    first = ff.packed_weights(w)
    assert ff.packed_weights(w) is first
    assert ff.packed_weights(w._replace(sig_w2=w.sig_w2.clone())) is not first  # other tensors
    w.amb_w2.mul_(0.5)  # in place: a new version
    again = ff.packed_weights(w)
    assert again is not first
    torch.testing.assert_close(again, ff.pack_field_weights(w), rtol=0, atol=0)


def test_packed_weights_of_inference_tensors():
    """Weights made under inference_mode (a serving idiom) have no version
    counter: they pack, and the pack is cached by identity."""
    with torch.inference_mode():
        w = ff.FieldWeights(*(t.clone() for t in _sentinel_weights()))
    assert all(t.is_inference() for t in w)
    first = ff.packed_weights(w)
    assert ff.packed_weights(w) is first
    torch.testing.assert_close(first, ff.pack_field_weights(_sentinel_weights()), rtol=0, atol=0)
    assert ff.packed_weights(w._replace(sig_w2=w.sig_w2.clone())) is not first
