"""The port's checkpoint and config formats against the JAX package's, on
the CPU: the flax msgpack codec (`utils/msgpack.py`) against
`flax.serialization`, the YAML reader and writer (`config/yaml_io.py`)
against PyYAML, the config layer (`config/config.py`) against JAX's, the
checkpoint store (`utils/ckpt.py`) against JAX's `save_checkpoint` and
`load_ckpt_file`, and the weight bridge's inverse (`export_flax_params`)
against the flax init trees of the head, torso, SR and a2m.

Tolerances: none. Trees, bytes, configs and arrays are equal exactly."""

import copy
import glob
import math
import os

import flax
import flax.serialization as fs
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from genefaceplusplus_tpu.config import config as j_config
from genefaceplusplus_tpu.models.audio2motion.vae_model import PitchContourVAEModel as JA2M
from genefaceplusplus_tpu.models.radnerf import RADNeRF as JRADNeRF
from genefaceplusplus_tpu.models.radnerf import RADNeRFConfig as JConfig
from genefaceplusplus_tpu.models.radnerf_torso import TorsoConfig as JTorsoConfig
from genefaceplusplus_tpu.models.radnerf_torso import TorsoField as JTorso
from genefaceplusplus_tpu.models.superresolution import Superresolution as JSR
from genefaceplusplus_tpu.utils import ckpt as j_ckpt
from genefaceplusplus_tpu_torch.config import config as t_config
from genefaceplusplus_tpu_torch.config import yaml_io
from genefaceplusplus_tpu_torch.models.audio2motion.vae_model import a2m_model_from_hparams
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF as TRADNeRF
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRFConfig as TConfig
from genefaceplusplus_tpu_torch.models.radnerf_torso import TorsoConfig as TTorsoConfig
from genefaceplusplus_tpu_torch.models.radnerf_torso import TorsoField as TTorso
from genefaceplusplus_tpu_torch.models.superresolution import Superresolution as TSR
from genefaceplusplus_tpu_torch.utils import ckpt as t_ckpt
from genefaceplusplus_tpu_torch.utils import msgpack as t_msgpack
from genefaceplusplus_tpu_torch.utils.convert_jax import (convert_flax_params, export_flax_params,
                                                          unwrap_train_state)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EGS = sorted(os.path.relpath(p, REPO) for p in glob.glob(os.path.join(REPO, "egs", "**", "*.yaml"), recursive=True))


def assert_tree_equal(got, ref, path=""):
    """Equal structure, key order, types, dtypes, shapes and values (NaN
    equals NaN); a bfloat16 leaf is a torch tensor in the port."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref), (path, got, ref)
        for k in ref:
            assert_tree_equal(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            assert_tree_equal(a, b, f"{path}/{i}")
    elif isinstance(got, torch.Tensor):
        assert got.dtype == torch.bfloat16 and np.asarray(ref).dtype == jnp.bfloat16, path
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), np.asarray(ref).view(np.int16), err_msg=path)
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert type(got) is type(ref) and got.dtype == ref.dtype and np.shape(got) == np.shape(ref), path
        np.testing.assert_array_equal(got, ref, err_msg=path)
    else:
        assert type(got) is type(ref), (path, type(got), type(ref))
        assert got == ref or (isinstance(ref, float) and math.isnan(ref) and math.isnan(got)), (path, got, ref)


# ---------------------------------------------------------------- the msgpack codec


def _trees():
    rs = np.random.RandomState(0)
    return {
        "float32": {"w": rs.randn(3, 4).astype(np.float32), "z": np.zeros((0, 5), np.float32),
                    "d": rs.randn(7).astype(np.float64)},
        "bfloat16": {"w": jnp.asarray(rs.randn(5, 3), jnp.bfloat16), "s": jnp.asarray(1.5, jnp.bfloat16)},
        "bool": {"occupancy": rs.rand(4, 4, 4) > 0.5, "flag": np.bool_(True)},
        "int32": {"i": rs.randint(-1000, 1000, (6,)).astype(np.int32), "u8": np.arange(9, dtype=np.uint8),
                  "i64": np.int64(-(2 ** 40))},
        "scalars": {"step": np.int32(7), "lr": np.float32(1e-3), "global_step": 12, "f": 0.25,
                    "neg": -33, "big": 2 ** 33, "small": -129, "t": True, "n": None, "s": "é" * 40,
                    "nan": float("nan"), "c": 1.5 - 2j, "b": b"\x00\x01"},
        "chunked": {"big": rs.randn(40).astype(np.float32), "nested": {"b16": jnp.asarray(rs.randn(33), jnp.bfloat16)},
                    "small": np.ones(2, np.float32)},
        "nested_lists": {"l": [1, [2.0, "x", None], {"a": np.arange(3)}, [np.ones((2, 2), np.float32)]],
                         "opt": {"0": {"count": np.int32(0)}, "1": {}}, "empty": []},
        "large_containers": {str(i): [np.float32(i)] * (i % 20) for i in range(70)},
    }


def _host(tree):
    """jax arrays as numpy arrays, dict order kept (jax.tree.map sorts it)."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_host(v) for v in tree]
    return np.asarray(tree) if isinstance(tree, jax.Array) else tree


@pytest.mark.parametrize("case", list(_trees()))
def test_msgpack_matches_flax(monkeypatch, case):
    tree = _trees()[case]
    if case == "chunked":  # arrays above 64 bytes go in chunks of 16 floats
        monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
        monkeypatch.setattr(t_msgpack, "MAX_CHUNK_SIZE", 64)
    blob = fs.msgpack_serialize(tree)
    if case == "chunked":
        assert b"__msgpack_chunked_array__" in blob
    ref = fs.msgpack_restore(blob)
    got = t_msgpack.unpackb(blob)
    assert_tree_equal(got, ref)
    mine = t_msgpack.packb(_host(tree))
    assert mine == blob  # the same tree gives flax's bytes (its keys sorted as flax sorts them)
    assert t_msgpack.packb(got) == blob
    assert_tree_equal(t_msgpack.unpackb(mine), ref)
    assert_tree_equal(t_msgpack.unpackb(fs.msgpack_serialize(fs.msgpack_restore(mine))), ref)


def test_msgpack_reads_arrays_without_a_copy():
    arr = np.random.RandomState(1).randn(1000, 32).astype(np.float32)
    blob = fs.msgpack_serialize({"a": arr})
    got = t_msgpack.unpackb(blob)["a"]
    assert not got.flags.writeable and not got.flags.owndata
    assert np.shares_memory(got, np.frombuffer(blob, np.uint8))
    np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("blob,match", [
    (b"", "empty"), (b"\xc1", "starts no msgpack value"), (b"\x92\x01", "truncated"),
    (b"\x01\x02", "after the msgpack value"), (b"\xd4\x05\x00", "ext type 5"),
])
def test_msgpack_rejects_what_flax_does_not_write(blob, match):
    with pytest.raises(t_msgpack.MsgpackError, match=match):
        t_msgpack.unpackb(blob)


# ---------------------------------------------------------------- YAML


@pytest.mark.parametrize("path", EGS)
def test_yaml_reader_matches_pyyaml_on_egs(path):
    full = os.path.join(REPO, path)
    with open(full) as f:
        assert yaml_io.load(full) == yaml.safe_load(f)


SAVED = [
    {"a": 1, "b": [0, 0, 0], "c": {"d": 1.0e-8, "e": "", "f": None, "g": True}},
    {"video_id": "123", "s": "yes", "t": "1.5", "u": "null", "v": "a: b", "w": "it's", "x": "#x",
     "y": " pad", "z": "tab\there", "q": 'say "hi"', "nl": "a\nb", "uni": "é中", "ctrl": "\x07"},
    {"floats": [0.1, -2.5e-12, 1e20, float("inf"), -float("inf"), 3.0, 1e16],
     "ints": [0, -7, 2 ** 40], "empty_list": [], "empty_map": {}},
    {"nested": [{"a": 1, "b": [1, 2]}, [3, [4, 5]], [], {}], "deep": {"x": {"y": {"z": ["p", "q"]}}}},
    {"camera_offset": [0, 0, 0], "head_model_dir": "/tmp/some dir/with-dash_and.dot",
     "binary_data_dir": "data/binary/videos", "keys with space": 1, "1": "one", "-1": "minus"},
    {"long": "word " * 30 + "end", "longq": "it's " * 25, "dq": "\x07 word " * 15, "nl2": "a\n\nb\n",
     "sp": "  lead and trail  ", "l": ["x " * 50, {"k": "y " * 45}]},
]


@pytest.mark.parametrize("i", range(len(SAVED)))
def test_yaml_writer_and_reader_match_save_config(tmp_path, i):
    d = SAVED[i]
    j_config.save_config(d, str(tmp_path / "jax"))
    text = (tmp_path / "jax" / "config.yaml").read_text()
    assert yaml_io.loads(text) == yaml.safe_load(text) == d  # reads what JAX's save_config writes
    t_config.save_config(d, str(tmp_path / "port"))
    mine = (tmp_path / "port" / "config.yaml").read_text()
    assert yaml.safe_load(mine) == d and yaml_io.loads(mine) == d  # writes what both read back
    assert t_config.load_config(str(tmp_path / "port" / "config.yaml")) == \
        j_config.load_config(str(tmp_path / "jax" / "config.yaml"))


@pytest.mark.parametrize("path", EGS)
def test_yaml_writer_is_safe_dump_on_resolved_egs(path):
    d = j_config.load_config(os.path.join(REPO, path))
    assert yaml_io.dumps(d) == yaml.safe_dump(d, sort_keys=True)


EDGE_SCALARS = [
    "1.0e-8", "1e-8", "1.0e+8", "1.0e8", "6.", ".5", "-0.0", "+1.5", "1_000.5", "1:30.5", ".inf", "-.Inf",
    "+.INF", "yes", "no", "on", "off", "Yes", "NO", "On", "OFF", "True", "FALSE", "true", "y", "n",
    "~", "null", "Null", "NULL", "", "None", "0x1f", "-0x1F", "017", "08", "0b101", "1:30", "1_000", "-0",
    "+7", "0", "'x'", "''", "'it''s'", '"a\\tb\\u00e9\\x41"', '"\\"q\\""', "a b", "http://x:1/y", "a:b",
    "[1, 2.0, no, ~, 'x']", "[]", "{}", "{a: 1, b: [x, y], 'c d': null}", "[[1, 2], [3]]", "a: 1",
    "- x", "abc # comment", "v: 1 # c", "-5", "-x", "foo[1]", "a, b",
]


@pytest.mark.parametrize("text", EDGE_SCALARS)
def test_yaml_scalars_resolve_as_pyyaml(text):
    got, ref = yaml_io.loads(text), yaml.safe_load(text)
    assert type(got) is type(ref)
    assert got == ref or (isinstance(ref, float) and math.isnan(ref) and math.isnan(got))


@pytest.mark.parametrize("text,line", [
    ("a: &x 1\nb: *x\n", 1), ("a: !!int 3\n", 1), ("a: |\n  text\n", 1), ("a: >\n  text\n", 1),
    ("a: 1\nb: long # c\n  continued\n", 3), ("a:\n\t- 1\n", 2), ("a: 1\na: 2\n", 2), ("---\na: 1\n", 1),
    ("a: [1,\n  2]\n", 1), ("a: 1\nb: 'open\n", 2), ("when: 2001-12-14\n", 1), ("a: b: c\n", 1),
    ("? complex\n: key\n", 1),
])
def test_yaml_reader_raises_on_what_it_does_not_read(text, line):
    with pytest.raises(yaml_io.YAMLSyntaxError, match=f"cfg.yaml:{line}"):
        yaml_io.loads(text, "cfg.yaml")


# ---------------------------------------------------------------- the config layer


@pytest.mark.parametrize("path", EGS)
def test_load_config_matches_jax(monkeypatch, path):
    monkeypatch.chdir(REPO)
    assert t_config.load_config(path) == j_config.load_config(path)
    got = t_config.set_hparams(config=path, exp_name="e", hparams_str="lr=0.1,video_id=123")
    assert got.to_dict() == j_config.set_hparams(config=path, exp_name="e", hparams_str="lr=0.1,video_id=123").to_dict()


def test_base_config_resolution_and_cycles(tmp_path, monkeypatch):
    (tmp_path / "sub").mkdir()
    (tmp_path / "base.yaml").write_text("a: 1\nb: {c: 2, d: 3}\n")
    (tmp_path / "sub" / "mid.yaml").write_text("base_config: ../base.yaml\nb: {c: 20}\n")
    (tmp_path / "sub" / "top.yaml").write_text("base_config:\n- ./mid.yaml\n- sub/local.yaml\ne: 5\n")
    (tmp_path / "sub" / "local.yaml").write_text("a: 100\n")
    (tmp_path / "cyc1.yaml").write_text("base_config: ./cyc2.yaml\n")
    (tmp_path / "cyc2.yaml").write_text("base_config: ./cyc1.yaml\n")
    monkeypatch.chdir(tmp_path)
    got = t_config.load_config("sub/top.yaml")
    assert got == j_config.load_config("sub/top.yaml") == {"a": 100, "b": {"c": 20, "d": 3}, "e": 5}
    for mod in (t_config, j_config):
        with pytest.raises(ValueError, match="cycle"):
            mod.load_config("cyc1.yaml")


BASE = {"lr": 0.5, "steps": 10, "flag": False, "name": "x", "video_id": "May", "nested": {"k": 1},
        "lst": [1, 2], "none": None}
OVERRIDES = [
    "", "lr=0.1", "lr=1e-3", "steps=20", "flag=true", "flag=False", "name=y", "video_id=123",
    "nested.k=2", "nested.new=[1,2]", "new.deep.key=3", "lst=[3, 4, 5]", "none=5", "none=null",
    "name=a: b", "x=yes", "x=0x10", "x= spaced ", "lr=2,steps=3,name=z", "d={a: 1}", "t=(1,2)",
    # error cases
    "lr", "=3", "steps=1.5", "steps=abc", "flag=maybe", "lr=abc",
]


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the error is part of what is compared
        return type(e), str(e)


@pytest.mark.parametrize("overrides", OVERRIDES)
def test_apply_overrides_and_set_hparams_match_jax(tmp_path, overrides):
    assert _outcome(lambda: t_config.apply_overrides(copy.deepcopy(BASE), overrides)) == \
        _outcome(lambda: j_config.apply_overrides(copy.deepcopy(BASE), overrides))
    work = str(tmp_path / "work")
    j_config.save_config(BASE, work)
    for reset in (False, True):
        kw = dict(exp_name="e", hparams_str=overrides, work_dir=work, reset=reset)
        assert _outcome(lambda: t_config.set_hparams(**kw).to_dict()) == \
            _outcome(lambda: j_config.set_hparams(**kw).to_dict())


def test_config_is_an_immutable_mapping():
    c = t_config.Config({"a": 1})
    assert c.a == 1 and c["a"] == 1 and c.get("b", 2) == 2 and dict(c) == {"a": 1}
    assert c.replace(b=3).to_dict() == {"a": 1, "b": 3} and c.to_dict() == {"a": 1}
    with pytest.raises(AttributeError):
        c.b


# ---------------------------------------------------------------- the weight bridge's inverse


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flax_tree(which):
    if which == "head":
        m = JRADNeRF(JConfig(grid_size=16, individual_embedding_num=8, smo_win_size=3))
        v = jax.jit(lambda: m.init(jax.random.PRNGKey(0), jnp.zeros((8, 3)), jnp.ones((8, 3)),
                                   jnp.zeros((3, 1, 204))))()
        return _np(v), TRADNeRF(TConfig(grid_size=16, individual_embedding_num=8, smo_win_size=3))
    if which == "torso":
        tc = dict(torso_individual_embedding_num=4, grid_size=16)
        m = JTorso(JTorsoConfig(**tc))
        v = jax.jit(lambda: m.init(jax.random.PRNGKey(2), jnp.zeros((8, 2)), jnp.zeros((1, 68, 2)), jnp.zeros(8),
                                   jnp.zeros((8, 3)), jnp.zeros((8, 1))))()
        return _np(v), TTorso(TTorsoConfig(**tc))
    if which == "sr":
        m = JSR(channels=3, input_resolution=256)
        return _np(jax.jit(lambda: m.init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 3))))()), TSR(3, 256)
    hp = {"audio_in_dim": 32, "a2m_hidden_channels": 16, "a2m_enc_layers": 2, "a2m_dec_layers": 1,
          "a2m_flow_hidden": 8, "a2m_flow_blocks": 1}
    m = JA2M(in_out_dim=64, audio_in_dim=32, hidden_channels=16, enc_n_layers=2, dec_n_layers=1, flow_hidden=8,
             flow_n_blocks=1)
    batch = {"audio": jnp.zeros((1, 16, 32)), "f0": jnp.zeros((1, 16)), "y_mask": jnp.ones((1, 8)),
             "y": jnp.zeros((1, 8, 64))}
    v = jax.jit(lambda: m.init(jax.random.PRNGKey(0), batch, train=True, rng=jax.random.PRNGKey(1)))()
    return _np(v), a2m_model_from_hparams(hp)


def _sorted_tree(tree):
    return {k: _sorted_tree(tree[k]) for k in sorted(tree)} if isinstance(tree, dict) else tree


@pytest.mark.parametrize("which", ["head", "torso", "sr", "a2m"])
def test_export_flax_params_inverts_the_bridge(which):
    tree, model = _flax_tree(which)
    model.load_state_dict(convert_flax_params(tree, model))
    out = export_flax_params(model)
    assert_tree_equal(_sorted_tree(out), _sorted_tree(flax.core.unfreeze(tree)))


# ---------------------------------------------------------------- the checkpoint store


def _payload():
    rs = np.random.RandomState(3)
    params = {"params": {"Dense_0": {"kernel": rs.randn(4, 3).astype(np.float32), "bias": np.zeros(3, np.float32)}}}
    opt = flax.serialization.to_state_dict(optax.adam(1e-3).init(params))
    return {"state_dict": {"step": np.int32(5), "params": params, "opt_state": opt},
            "extra_state": {"occupancy": rs.rand(8, 8, 8) > 0.5, "density_grid": rs.rand(8, 8, 8).astype(np.float32),
                            "bf": jnp.asarray(rs.randn(4), jnp.bfloat16)}}


def test_port_reads_jax_checkpoints_and_jax_reads_the_ports(tmp_path):
    payload = _payload()
    cfg = {"lr": 1e-3, "video_id": "May", "camera_offset": [0, 0, 0]}
    for step in (10, 100_000, 100_010, 100_020):
        j_ckpt.save_checkpoint(str(tmp_path / "jax"), step, payload, config=cfg, num_ckpt_keep=1)
        t_ckpt.save_flax_checkpoint(str(tmp_path / "port"), step, jax.tree.map(np.asarray, payload), config=cfg,
                                    num_ckpt_keep=1)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))  # the same retention: the newest and milestones
    assert names == ["config.yaml", "model_ckpt_steps_100000.ckpt", "model_ckpt_steps_100020.ckpt"]
    assert (tmp_path / "jax" / "config.yaml").read_text() == (tmp_path / "port" / "config.yaml").read_text()
    jp, pp = (str(tmp_path / d / "model_ckpt_steps_100020.ckpt") for d in ("jax", "port"))
    assert open(jp, "rb").read() == open(pp, "rb").read()
    got, path = t_ckpt.get_last_checkpoint(str(tmp_path / "jax"))
    assert path.endswith("model_ckpt_steps_100020.ckpt")
    assert_tree_equal(got, j_ckpt.load_ckpt_file(path))
    assert_tree_equal(t_ckpt.load_ckpt_file(pp), j_ckpt.load_ckpt_file(jp))
    assert t_ckpt.get_last_checkpoint(str(tmp_path / "jax"), steps=100_000)[1].endswith("steps_100000.ckpt")
    assert t_ckpt.get_last_checkpoint(str(tmp_path / "none")) == (None, None)


def test_torch_checkpoints_still_load_and_other_files_raise(tmp_path):
    path = t_ckpt.checkpoint_path(str(tmp_path), 3)  # the port's trainer before it wrote JAX's layout
    torch.save({"state_dict": {"w": torch.ones(2)}, "global_step": 3}, path)
    got = t_ckpt.load_ckpt_file(path)
    assert got["global_step"] == 3 and torch.equal(got["state_dict"]["w"], torch.ones(2))
    bad = tmp_path / "model_ckpt_steps_9.ckpt"
    bad.write_bytes(b"\x00not a checkpoint")
    with pytest.raises(ValueError, match="neither a flax msgpack checkpoint"):
        t_ckpt.load_ckpt_file(str(bad))


def test_restore_into_matches_by_name_and_shape():
    template = {"a": torch.zeros(2, 3), "b": torch.zeros(4), "c": torch.zeros(1), "d": torch.zeros(2, dtype=torch.float64)}
    loaded = {"a": np.ones((2, 3), np.float32), "b": np.ones(5, np.float32), "x": np.ones(1), "d": np.ones(2, np.float32)}
    out, restored = t_ckpt.restore_into(template, loaded)
    assert restored == ["a", "d"]
    assert torch.equal(out["a"], torch.ones(2, 3)) and torch.equal(out["b"], torch.zeros(4))
    assert out["d"].dtype == torch.float64 and torch.equal(out["d"], torch.ones(2, dtype=torch.float64))
    assert torch.equal(out["c"], torch.zeros(1))


@pytest.mark.parametrize("sub,key", [(None, "params"), ("head", "params"), ("sr", "params"), ("torso", "torso_params"),
                                     (None, "variables"), (None, "model"), (None, "bare")])
def test_unwrap_train_state_finds_the_variables_as_jax_does(sub, key):
    v = {"params": {"w": np.ones(2)}}
    if key == "model":
        ckpt = {"state_dict": {"model": v}}
    elif key == "bare":
        ckpt = v
    elif sub in ("head", "sr"):
        ckpt = {"state_dict": {"step": 1, "params": {"head": v, "sr": {"params": {"s": np.zeros(1)}}}, "opt_state": {}}}
    else:
        ckpt = {"state_dict": {"step": 1, key: v, "opt_state": {}}}
    got = unwrap_train_state(ckpt, sub)
    if sub == "sr":
        assert list(got["params"]) == ["s"]
    else:
        assert got == v
