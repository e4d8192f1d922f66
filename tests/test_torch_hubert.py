"""The port's HuBERT (`models/hubert.py`, `utils/hf_snapshot.py`,
`data/audio.py:get_hubert_from_16k_speech`) against the JAX package's
`get_hubert_from_16k_speech` (transformers' `HubertModel`) on the same
weights, on the CPU at small widths: hidden 64, 2 layers, 4 heads,
conv_dim 16 x 7 with the real kernels and strides, a positional kernel of
16 in 4 groups.

Snapshots go into a temporary Hugging Face hub cache (`HF_HUB_CACHE`),
written by transformers' `save_pretrained` (model.safetensors or
pytorch_model.bin, the weight norm as transformers 4.57 writes it or
renamed to the released files' weight_g / weight_v) or by
`testing.write_hubert_snapshot` (the released checkpoint's layout:
`hubert.` keys, `lm_head`, weight_g / weight_v), which transformers then
loads for JAX's side. JAX's function gets the model through its
`_HUBERT_CACHE` and `hubert_available` is patched to true: nothing of the
JAX package changes.

Tolerances:
- features: within 1e-4 of the largest |feature| (abs), T exact;
- the entry points (`prepare_batch_from_inp`, `infer_once` as the CLI
  calls it, `stream_infer` at temperature 0, on
  tests/test_torch_audio_drive.py's pair of GeneFaceInfers; `step_audio`):
  the features as above, the condition within 1e-4, frames PSNR >= 42 dB
  and mean |d| <= 1.5 levels of 255 (that file's and
  tests/test_torch_streaming.py's bars).
"""

import copy
import math
import os

os.environ.setdefault("USE_TF", "0")  # transformers without TensorFlow: ~5 s less to import

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import safetensors.torch  # noqa: E402
import torch  # noqa: E402
import transformers  # noqa: E402
from scipy.io import wavfile  # noqa: E402

from genefaceplusplus_tpu.data import audio as j_audio  # noqa: E402
from genefaceplusplus_tpu.data import process as j_process  # noqa: E402
from genefaceplusplus_tpu.inference import serving as j_serving  # noqa: E402
from genefaceplusplus_tpu_torch import testing  # noqa: E402
from genefaceplusplus_tpu_torch.data import audio as t_audio  # noqa: E402
from genefaceplusplus_tpu_torch.data import process as t_process  # noqa: E402
from genefaceplusplus_tpu_torch.data.video import read_avi  # noqa: E402
from genefaceplusplus_tpu_torch.inference import serving as t_serving  # noqa: E402
from genefaceplusplus_tpu_torch.inference.pipeline import default_inp  # noqa: E402
from genefaceplusplus_tpu_torch.models.hubert import HUBERT_PREPROCESSOR, HubertConfig  # noqa: E402
from genefaceplusplus_tpu_torch.utils import hf_snapshot  # noqa: E402
from genefaceplusplus_tpu_torch.utils.convert_torch_ckpt import fold_weight_norm  # noqa: E402
from test_torch_audio_drive import _drive, _voiced_wav  # noqa: E402
from test_torch_audio_drive import pair  # noqa: E402,F401  (a fixture)

NAME = t_audio.HUBERT_MODEL
REL = 1e-4
ATOL = 1e-4
MIN_PSNR, MAX_MEAN_ABS = 42.0, 1.5
SMALL = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 128,
         "conv_dim": [16] * 7, "conv_kernel": [10, 3, 3, 3, 3, 2, 2], "conv_stride": [5, 2, 2, 2, 2, 2, 2],
         "num_conv_pos_embeddings": 16, "num_conv_pos_embedding_groups": 4}
LAYOUTS = {"stable": {"do_stable_layer_norm": True, "feat_extract_norm": "layer", "conv_bias": True},
           "post": {"do_stable_layer_norm": False, "feat_extract_norm": "group", "conv_bias": False}}
# 45 s: two whole windows (two seams) and a tail of 80,000 samples; two
# whole windows and a tail of 200 samples, which is skipped
WAV_SAMPLES = (45 * 16000, 2 * t_audio.HUBERT_CLIP + 200)
PARAM_KEYS = ("parametrizations.weight.original0", "parametrizations.weight.original1")
RELEASED_KEYS = ("weight_g", "weight_v")


def _speech(n: int, seed: int) -> np.ndarray:
    """A voiced glide with noise and silences, `n` samples at 16 kHz."""
    rs = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    wav = 0.3 * np.sin(2 * np.pi * np.cumsum(120.0 + 60.0 * np.sin(0.7 * t)) / 16000.0) * (np.sin(1.3 * t) > -0.3)
    return (wav + 0.01 * rs.randn(n)).astype(np.float32)


def _hf_model(layout: str, seed: int):
    """transformers' HubertModel at SMALL, its norms and biases drawn away
    from their initial 1 and 0."""
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        model = transformers.HubertModel(transformers.HubertConfig(**SMALL, **LAYOUTS[layout])).eval()
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("bias") or "norm" in name:
                    p.add_(0.1 * torch.randn(p.shape))
    return model


def _save(model, snap: str, fmt: str, keys, do_normalize: bool) -> None:
    """`model` into `snap` by save_pretrained, its weight-norm keys renamed to
    `keys`."""
    model.save_pretrained(snap, safe_serialization=fmt == "safetensors")
    transformers.Wav2Vec2FeatureExtractor(do_normalize=do_normalize, return_attention_mask=True).save_pretrained(snap)
    if keys == RELEASED_KEYS:
        path = os.path.join(snap, "model.safetensors" if fmt == "safetensors" else "pytorch_model.bin")
        state = (safetensors.torch.load_file(path) if fmt == "safetensors"
                 else torch.load(path, map_location="cpu", weights_only=True))
        for a, b in zip(PARAM_KEYS, RELEASED_KEYS):
            state = {k.replace(a, b): v for k, v in state.items()}
        assert any(k.endswith("weight_g") for k in state)
        if fmt == "safetensors":
            safetensors.torch.save_file(state, path, metadata={"format": "pt"})
        else:
            torch.save(state, path)


def _snapshot(cache, case: str):
    """(the JAX side's (processor, HubertModel), the snapshot) for `case`."""
    layout, fmt, keys, do_normalize = CASES[case]
    if fmt == "released":
        snap = testing.write_hubert_snapshot(str(cache), NAME, dict(SMALL, **LAYOUTS[layout]),
                                             dict(HUBERT_PREPROCESSOR, do_normalize=do_normalize), seed=5)
        model = transformers.HubertModel.from_pretrained(snap).eval()
    else:
        model = _hf_model(layout, seed=len(case))
        snap = testing.hub_snapshot(str(cache), NAME)
        _save(model, snap, fmt, keys, do_normalize)
    return (transformers.Wav2Vec2FeatureExtractor.from_pretrained(snap), model), snap


CASES = {  # layout, file format, weight-norm keys, do_normalize
    "stable-safetensors": ("stable", "safetensors", PARAM_KEYS, True),
    "stable-released-bin": ("stable", "released", RELEASED_KEYS, True),
    "post-safetensors-released-keys": ("post", "safetensors", RELEASED_KEYS, False),
    "post-bin": ("post", "bin", PARAM_KEYS, True),
}


def _features_close(got, ref):
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.abs(got - ref).max() <= REL * np.abs(ref).max(), (np.abs(got - ref).max(), np.abs(ref).max())


@pytest.fixture
def with_hubert(monkeypatch, tmp_path):
    """Install a case's snapshot for both packages; returns (JAX's model,
    the snapshot)."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    monkeypatch.setattr(j_audio, "hubert_available", lambda *a, **k: True)

    def install(case):
        j_pair, snap = _snapshot(tmp_path / "hub", case)
        monkeypatch.setitem(j_audio._HUBERT_CACHE, NAME, j_pair)
        return j_pair[1], snap
    return install


@pytest.mark.parametrize("case", list(CASES))
def test_features_match_jax_across_window_seams(with_hubert, case):
    model, snap = with_hubert(case)
    assert t_audio.hubert_available() and t_audio.hubert_available(snap)
    for n in WAV_SAMPLES:
        wav = _speech(n, seed=n % 7)
        ref = j_audio.get_hubert_from_16k_speech(wav)
        got = t_audio.get_hubert_from_16k_speech(wav, device="cpu")
        windows, expected_T = t_audio.hubert_windows(n)
        assert (got.shape[0], expected_T, len(windows)) == {WAV_SAMPLES[0]: (2249, 2249, 3),
                                                             WAV_SAMPLES[1]: (2000, 2000, 2)}[n]
        _features_close(got, ref)
    # the snapshot named as a directory, and the module cached per (snapshot, device)
    np.testing.assert_array_equal(t_audio.get_hubert_from_16k_speech(wav, snap, device="cpu"), got)
    assert t_audio.load_hubert(snap, "cpu")[0] is t_audio.load_hubert(NAME, "cpu")[0]
    with torch.no_grad():
        x = torch.from_numpy(_speech(8000, seed=1))[None]
        ref = model(x).last_hidden_state[0].numpy()
        port = t_audio.load_hubert(snap, "cpu")[0]
        _features_close(port(x)[0].numpy(), ref)
        _features_close(copy.deepcopy(port).double()(x.double())[0].float().numpy(), ref)  # a float64 reference


@pytest.mark.parametrize("dim", [0, 2])
def test_fold_weight_norm_matches_torch(dim):
    conv = torch.nn.utils.parametrizations.weight_norm(torch.nn.Conv1d(8, 6, 5), dim=dim)
    g = torch.Generator().manual_seed(dim)
    with torch.no_grad():
        conv.parametrizations.weight.original1.copy_(torch.randn(6, 8, 5, generator=g))
        conv.parametrizations.weight.original0.mul_(torch.rand(conv.parametrizations.weight.original0.shape,
                                                               generator=g) + 0.5)
        state = {"c.weight_g": conv.parametrizations.weight.original0.numpy(),
                 "c.weight_v": conv.parametrizations.weight.original1.numpy()}
        np.testing.assert_allclose(fold_weight_norm(state, "c", dim=dim), conv.weight.numpy(), rtol=1e-6, atol=1e-7)


def test_safetensors_reader_equals_the_library(tmp_path):
    g = torch.Generator().manual_seed(0)
    tensors = {"f32": torch.randn(3, 5, generator=g), "f16": torch.randn(7, generator=g).half(),
               "bf16": torch.randn(2, 3, generator=g).bfloat16(), "f64": torch.randn(4, generator=g).double(),
               "i64": torch.arange(-3, 6), "u8": torch.arange(9, dtype=torch.uint8).reshape(3, 3),
               "bool": torch.tensor([True, False, True]), "empty": torch.zeros(0, 4), "scalar": torch.tensor(2.5)}
    path = str(tmp_path / "t.safetensors")
    safetensors.torch.save_file(tensors, path, metadata={"format": "pt"})
    got = hf_snapshot.read_safetensors(path)
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    data = open(path, "rb").read()
    with open(path, "wb") as f:  # a header that claims more bytes than the file holds
        f.write((len(data) * 2).to_bytes(8, "little") + data[8:])
    with pytest.raises(ValueError, match="past the end"):
        hf_snapshot.read_safetensors(path)
    with open(path, "wb") as f:  # a tensor cut short
        f.write(data[:-4])
    with pytest.raises(ValueError, match="offsets"):
        hf_snapshot.read_safetensors(path)


def test_snapshot_lookup_and_refusals(monkeypatch, tmp_path):
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    assert not t_audio.hubert_available() and hf_snapshot.snapshot_dir(NAME) is None
    snap = testing.hub_snapshot(str(tmp_path / "hub"), NAME)
    with open(os.path.join(snap, "config.json"), "w") as f:
        f.write("{}")
    assert hf_snapshot.snapshot_dir(NAME) == snap and not t_audio.hubert_available()  # no weights
    with pytest.raises(FileNotFoundError, match="pytorch_model.bin"):
        hf_snapshot.read_weights(snap)
    monkeypatch.delenv("HF_HUB_CACHE")
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    assert hf_snapshot.hub_cache() == str(tmp_path / "hub") and hf_snapshot.snapshot_dir(NAME) == snap
    monkeypatch.delenv("HF_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert hf_snapshot.hub_cache() == str(tmp_path / "home" / ".cache" / "huggingface" / "hub")
    with pytest.raises(FileNotFoundError, match="no local snapshot"):
        t_audio.load_hubert(NAME, "cpu")
    for key, value in (("conv_pos_batch_norm", True), ("hidden_act", "relu"), ("feat_extract_activation", "gelu_new")):
        with pytest.raises(ValueError, match=key):
            HubertConfig.from_json({key: value})
    with pytest.raises(ValueError, match="feat_extract_norm"):
        HubertConfig.from_json({"feat_extract_norm": "batch"})
    with pytest.raises(ValueError, match="number of convolutions"):
        HubertConfig.from_json({"conv_dim": [512] * 6})
    assert HubertConfig.from_json(transformers.HubertConfig().to_dict()) == HubertConfig()


# ---------------------------------------------------------------- the entry points


def _wav_file(tmp_path, seconds: float, seed: int = 0) -> str:
    path = str(tmp_path / f"drv{seed}.wav")
    wavfile.write(path, 16000, (_voiced_wav(seconds, seed=seed) * 32767).astype(np.int16))
    return path


def _frames_close(got, ref):
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == np.uint8
        d = a.astype(np.float64) - b.astype(np.float64)
        mse = float(np.mean(d ** 2))
        assert (math.inf if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)) >= MIN_PSNR
        assert np.abs(d).mean() <= MAX_MEAN_ABS
    assert any(not np.array_equal(got[0], f) for f in got[1:])


def test_bare_wav_request_matches_jax(pair, with_hubert, tmp_path):
    """prepare_batch_from_inp on a bare wav (mel, F0, HuBERT on the padded
    wav), then the condition and the frames."""
    j_inf, t_inf = pair
    with_hubert("stable-safetensors")
    inp = default_inp(drv_aud=_wav_file(tmp_path, 0.5), frames_per_dispatch=4)
    jb, tb = j_inf.prepare_batch_from_inp(inp), t_inf.prepare_batch_from_inp(inp)
    assert tb["T"] == jb["T"] == 12 and set(tb) == set(jb)
    _features_close(tb["hubert"], np.asarray(jb["hubert"]))
    for k in set(jb) - {"hubert"}:
        np.testing.assert_array_equal(np.asarray(tb[k]), np.asarray(jb[k]), err_msg=k)
    jb, tb = _drive(j_inf, t_inf, inp)
    np.testing.assert_allclose(tb["cond"], np.asarray(jb["cond"]), atol=ATOL)
    _frames_close(list(t_inf.forward_secc2video(tb, inp)), list(j_serving._render_frames(j_inf, jb, inp)))


def test_cli_request_from_bare_wav_matches_jax(pair, with_hubert, tmp_path):
    """`infer_once`, the CLI's request, on a bare wav at temperature 0: its
    AVI's frames against JAX's frames of the same request, its audio the
    padded wav's PCM."""
    j_inf, t_inf = pair
    with_hubert("post-bin")
    inp = default_inp(drv_aud=_wav_file(tmp_path, 0.4, seed=1), temperature=0.0, out_name=str(tmp_path / "o.avi"))
    frames, pcm = read_avi(t_inf.infer_once(inp))
    jb = j_inf.forward_audio2secc(j_inf.prepare_batch_from_inp(inp), inp)
    assert len(frames) == jb["T"] == 8
    _frames_close(list(frames), list(j_serving._render_frames(j_inf, jb, inp)))
    np.testing.assert_array_equal(pcm, t_audio.pcm16(jb["wav16k"]))


def test_stream_from_bare_wav_matches_jax(pair, with_hubert, monkeypatch):
    """stream_infer without inp['hubert_full']: each chunk's HuBERT on its
    padded audio, then its condition and frames, at temperature 0."""
    j_inf, t_inf = pair
    with_hubert("stable-released-bin")
    wav = _speech(int(1.5 * 16000), seed=4)  # three chunks of 12 frames
    seen = {"jax": [], "port": []}
    for name, infer in (("jax", j_inf), ("port", t_inf)):
        forward = infer.forward_audio2secc

        def run(batch, inp, *a, _forward=forward, _into=seen[name], **kw):
            out = _forward(batch, inp, *a, **kw)
            _into.append((np.asarray(batch["hubert"]), np.asarray(out["cond"])))
            return out
        monkeypatch.setattr(infer, "forward_audio2secc", run)
    ref = list(j_serving.stream_infer(j_inf, wav, {"temperature": 0.0}, chunk_seconds=0.5))
    got = list(t_serving.stream_infer(t_inf, wav, {"temperature": 0.0}, chunk_seconds=0.5))
    assert len(seen["port"]) == len(seen["jax"]) == 3
    for (th, tc), (jh, jc) in zip(seen["port"], seen["jax"]):
        _features_close(th, jh)
        np.testing.assert_allclose(tc, jc, atol=ATOL)
    assert len(got) == 36
    _frames_close(got, ref)


def test_step_audio_writes_hubert_as_jax(with_hubert, monkeypatch, tmp_path, capsys):
    with_hubert("post-safetensors-released-keys")
    for d in ("jax", "port"):
        os.makedirs(tmp_path / d)
        t_audio.save_wav_16k(_speech(3 * 16000 + 123, seed=2), str(tmp_path / d / "aud.wav"))
    j_process.step_audio(str(tmp_path / "jax"))
    t_process.step_audio(str(tmp_path / "port"), device="cpu")
    ref = np.load(tmp_path / "jax" / "aud_hubert.npy")
    assert ref.shape == (150, 64)
    _features_close(np.load(tmp_path / "port" / "aud_hubert.npy"), ref)
    # without a snapshot both ask for the file and write none
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty"))
    monkeypatch.setattr(j_audio, "hubert_available", lambda *a, **k: False)
    for d, step in (("jax2", j_process.step_audio), ("port2", t_process.step_audio)):
        os.makedirs(tmp_path / d)
        t_audio.save_wav_16k(_speech(16000, seed=3), str(tmp_path / d / "aud.wav"))
        capsys.readouterr()
        step(str(tmp_path / d))
        assert "provide aud_hubert.npy separately" in capsys.readouterr().out
        assert not os.path.exists(tmp_path / d / "aud_hubert.npy")
