"""The port's converter of the reference's torch checkpoints
(`utils/convert_torch_ckpt.py`, `tools/convert_ckpt.py`,
`tools/convert_vgg.py`) against the JAX package's (`scripts/convert_ckpt.py`,
`scripts/convert_vgg.py`), on the CPU.

The a2m checkpoint is a fake in the reference's layout: torch's legacy
serialization of `{epoch, global_step, optimizer_states, state_dict:
{model: ...}}` with the reference's layers (weight-normed WN convs, the
prior flow, BatchNorm statistics), as `tests/test_convert_golden.py` builds
it, here from the port's `testing.reference_a2m_state` (which
`chip_smoke.py` converts at full width) with non-trivial weight-norm gains
and statistics and narrow widths (64 audio features, 32 hidden channels, a flow 16 wide; the layer
counts are the reference's, which the converter maps), so its files stay
near 3 MB. The VGG state dicts are narrow too (the map reads names only).

Tolerances: the converted work dirs are equal exactly (keys, dtypes, the
bytes of every array, `global_step`, `config.yaml`); the port's a2m loaded
from its dir against JAX's at temperature 0: atol 1e-4 (the port's float32
tolerance)."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from genefaceplusplus_tpu.models.audio2motion.vae_model import PitchContourVAEModel as JA2M
from genefaceplusplus_tpu_torch.config import set_hparams
from genefaceplusplus_tpu_torch.inference.pipeline import _restore
from genefaceplusplus_tpu_torch.models.audio2motion.vae_model import a2m_model_from_hparams
from genefaceplusplus_tpu_torch.testing import reference_a2m_state, save_reference_ckpt
from genefaceplusplus_tpu_torch.tools import convert_ckpt, convert_vgg
from genefaceplusplus_tpu_torch.utils.ckpt import get_last_checkpoint

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
ATOL = 1e-4
A2M = {"use_pitch": True, "audio_in_dim": 64, "motion_type": "exp", "a2m_hidden_channels": 32, "a2m_flow_hidden": 16}


def _script(name):
    """The JAX package's script `scripts/<name>.py` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def released(tmp_path_factory):
    """A fake released a2m checkpoint in the reference's legacy layout, its
    config.yaml beside it, and both packages' converted work dirs."""
    d = tmp_path_factory.mktemp("released")
    src = str(d / "model_ckpt_steps_400000.ckpt")
    save_reference_ckpt(src, reference_a2m_state(A2M, seed=0))
    with open(d / "config.yaml", "w") as f:
        f.write("".join(f"{k}: {str(v).lower() if v is True else v}\n" for k, v in A2M.items()))
    jax_dir, port_dir = str(d / "jax"), str(d / "port")
    _script("convert_ckpt").convert_file(src, "a2m", jax_dir)
    path = convert_ckpt.main(["--input", src, "--type", "a2m", "--out", port_dir])
    return src, jax_dir, port_dir, path


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, prefix + (key,)).items()}
    return {prefix: tree}


def _restore_file(path):
    with open(path, "rb") as f:
        return serialization.msgpack_restore(f.read())


def test_the_converted_work_dir_is_jaxs(released):
    """The same keys, dtypes and bytes for every array, the same
    global_step and config.yaml as JAX's convert_file writes."""
    _, jax_dir, port_dir, path = released
    assert os.path.basename(path) == "model_ckpt_steps_400000.ckpt"
    assert sorted(os.listdir(jax_dir)) == sorted(os.listdir(port_dir)) == ["config.yaml", os.path.basename(path)]
    j_tree, t_tree = (_flat(_restore_file(os.path.join(d, os.path.basename(path)))) for d in (jax_dir, port_dir))
    assert set(j_tree) == set(t_tree) and len(j_tree) > 100
    for k, a in j_tree.items():
        b = t_tree[k]
        assert type(a) is type(b) and np.asarray(a).dtype == np.asarray(b).dtype, k
        assert np.asarray(a).shape == np.asarray(b).shape and np.asarray(a).tobytes() == np.asarray(b).tobytes(), k
    assert int(t_tree[("global_step",)]) == 400_000
    cfgs = []
    for d in (jax_dir, port_dir):
        with open(os.path.join(d, "config.yaml")) as f:
            cfgs.append(yaml.safe_load(f))
    assert cfgs[0] == cfgs[1] == A2M


def test_config_flag_overrides_the_source_config(released, tmp_path):
    src = released[0]
    with open(tmp_path / "over.yaml", "w") as f:
        f.write("lambda_kl: 0.02\nuse_pitch: false\n")
    j_dir, t_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    _script("convert_ckpt").convert_file(src, "a2m", j_dir, config=yaml.safe_load(open(tmp_path / "over.yaml")))
    convert_ckpt.main(["--input", src, "--type", "a2m", "--out", t_dir, "--config", str(tmp_path / "over.yaml")])
    cfgs = [yaml.safe_load(open(os.path.join(d, "config.yaml"))) for d in (j_dir, t_dir)]
    assert cfgs[0] == cfgs[1] and cfgs[1]["use_pitch"] is False and cfgs[1]["lambda_kl"] == 0.02


def test_the_port_loads_the_a2m_as_jax_does(released, capsys):
    """The a2m loaded by the port from the port's dir, at temperature 0,
    against JAX's PitchContourVAEModel on JAX's dir (the deterministic
    prior path of tests/test_convert_golden.py)."""
    _, jax_dir, port_dir, _ = released
    T = 8
    rng = np.random.RandomState(7)
    audio = rng.randn(1, 2 * T, A2M["audio_in_dim"]).astype(np.float32) * 0.1
    f0 = np.abs(rng.randn(1, 2 * T)).astype(np.float32) * 100 + 100
    j_ckpt = _restore_file(os.path.join(jax_dir, "model_ckpt_steps_400000.ckpt"))
    assert int(j_ckpt["global_step"]) == 400_000
    j_batch = {"audio": jnp.asarray(audio), "f0": jnp.asarray(f0), "y_mask": jnp.ones((1, T)),
               "y": jnp.zeros((1, T, 64))}
    model = JA2M(in_out_dim=64, audio_in_dim=A2M["audio_in_dim"], hidden_channels=A2M["a2m_hidden_channels"],
                 flow_hidden=A2M["a2m_flow_hidden"])
    ref, _ = jax.jit(lambda v, b: model.apply(v, b, train=False, temperature=0.0, rng=jax.random.PRNGKey(2)))(
        j_ckpt["state_dict"], j_batch)

    hp = set_hparams(work_dir=port_dir).to_dict()
    assert hp["use_pitch"] is True
    a2m = a2m_model_from_hparams(hp)
    n = sum(not k.endswith("num_batches_tracked") for k in a2m.state_dict())
    state = _restore(a2m, get_last_checkpoint(port_dir), port_dir, None, "a2m")
    assert "kept at the port's init" not in capsys.readouterr().out  # every tensor restored
    a2m.load_state_dict(state)
    a2m.eval()
    with torch.no_grad():
        got, _ = a2m({"audio": torch.from_numpy(audio), "f0": torch.from_numpy(f0), "y_mask": torch.ones(1, T),
                      "y": torch.zeros(1, T, 64)}, train=False, temperature=0.0)
    assert n > 100 and got.shape == (1, T, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def _vgg_state(names, widths, seed):
    """A seeded VGG state dict: (name, in, out) per conv."""
    rng = np.random.RandomState(seed)
    state, c_in = {}, 3
    for name, c_out in zip(names, widths):
        state[f"{name}.weight"] = torch.from_numpy(rng.randn(c_out, c_in, 3, 3).astype(np.float32) * 0.1)
        state[f"{name}.bias"] = torch.from_numpy(rng.randn(c_out).astype(np.float32) * 0.1)
        c_in = c_out
    return state


VGG19 = ([f"features.{i}" for i in (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34)],
         (4, 4, 8, 8, 16, 16, 16, 16, 24, 24, 24, 24, 24, 24, 24, 24), False)
VGG_FACE = ([f"conv{b}_{i}" for b, n in ((1, 2), (2, 2), (3, 3), (4, 3), (5, 3)) for i in range(1, n + 1)],
            (4, 4, 8, 8, 16, 16, 16, 24, 24, 24, 24, 24, 24), True)


@pytest.mark.parametrize("names,widths,face", [VGG19, VGG_FACE], ids=["vgg19", "vgg_face_dag"])
def test_convert_vgg_writes_jaxs_tree(tmp_path, monkeypatch, names, widths, face):
    """Seeded fake torchvision vgg19 and vgg_face_dag state dicts (the
    latter with a classifier tensor the map ignores): the port's msgpack
    decodes to JAX's tree, and its bytes are JAX's."""
    state = _vgg_state(names, widths, seed=len(names))
    state["fc8.weight"] = torch.zeros(2, 4)
    src = str(tmp_path / "vgg.pth")
    torch.save(state, src)
    flag = ["--face"] if face else []
    monkeypatch.setattr("sys.argv", ["convert_vgg.py", src, str(tmp_path / "jax.msgpack")] + flag)
    _script("convert_vgg").main()
    convert_vgg.main([src, str(tmp_path / "port.msgpack")] + flag)
    j_tree, t_tree = (_flat(_restore_file(str(tmp_path / f))) for f in ("jax.msgpack", "port.msgpack"))
    assert set(j_tree) == set(t_tree) and len(t_tree) == 2 * len(names)
    for k, a in j_tree.items():
        assert a.dtype == t_tree[k].dtype and a.shape == t_tree[k].shape and a.tobytes() == t_tree[k].tobytes(), k
    assert open(tmp_path / "jax.msgpack", "rb").read() == open(tmp_path / "port.msgpack", "rb").read()


@pytest.mark.parametrize("kind,waits_for", [("head", "grid encoders"), ("disc", "discriminators")])
def test_head_and_disc_raise(released, tmp_path, kind, waits_for):
    with pytest.raises(NotImplementedError, match=waits_for):
        convert_ckpt.main(["--input", released[0], "--type", kind, "--out", str(tmp_path / kind)])
    assert not os.path.exists(tmp_path / kind)
