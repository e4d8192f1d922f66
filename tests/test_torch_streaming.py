"""Streaming of the port (`inference/serving.py`) against the JAX package's,
on the CPU: `stream_infer` on both, from the same work dirs (written by the
JAX package's `save_checkpoint`), at temperature 0 (no draw); the cursor
(no audio drift, an exact resume tail); the one-chunk pipeline's order;
`FramePusher`'s backpressure; the metrics registry.

Tolerances:
- the condition `cond` of each chunk: atol 1e-4 (the port's float32
  tolerance; tests/test_torch_audio_drive.py measured 8.5e-6);
- frames: PSNR >= 42 dB and mean |d| <= 1.5 levels of 255 per uint8 frame
  (tests/test_torch_pipeline.py's bar: bf16 fused field against the flax
  field's float32);
- a stream resumed at a chunk boundary against the uninterrupted stream's
  tail: exact."""

import math
import threading
import time

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from genefaceplusplus_tpu.data.dataset import synthetic as j_synthetic
from genefaceplusplus_tpu.inference import serving as j_serving
from genefaceplusplus_tpu.inference.pipeline import GeneFaceInfer as JInfer
from genefaceplusplus_tpu.models.audio2motion.vae_model import PitchContourVAEModel as JA2M
from genefaceplusplus_tpu.models.radnerf import RADNeRF as JRADNeRF
from genefaceplusplus_tpu.models.radnerf import RADNeRFConfig as JConfig
from genefaceplusplus_tpu.utils.ckpt import save_checkpoint
from genefaceplusplus_tpu_torch.inference import serving
from genefaceplusplus_tpu_torch.inference.metrics import LatencyHistogram, ServingMetrics, instrumented
from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer as TInfer

H = W = 24
A2M = {"use_pitch": True, "audio_in_dim": 64, "motion_type": "exp", "a2m_hidden_channels": 32,
       "a2m_enc_layers": 2, "a2m_dec_layers": 2, "a2m_flow_hidden": 16, "a2m_flow_blocks": 2}
HEAD = {"with_sr": False, "grid_size": 16, "smo_win_size": 3, "cond_win_size": 1,
        "individual_embedding_num": 16, "add_eye_blink_cond": True, "video_id": "id24"}
ATOL = 1e-4
MIN_PSNR, MAX_MEAN_ABS = 42.0, 1.5
HOP = 2 * 320  # 16 kHz samples a motion frame


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bench_occupancy(g):
    xx, yy, zz = np.meshgrid(*([np.linspace(-1, 1, g)] * 3), indexing="ij")
    return (xx ** 2 + (2.2 * yy) ** 2 + (1.4 * zz) ** 2) < 0.16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's CPU renders (many small ops), so
    the suite's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _JInfer(JInfer):
    def _init_a2m(self):
        return jax.jit(super()._init_a2m)()

    def _init_head(self):
        return jax.jit(super()._init_head)()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stream")
    binary = tmp / "binary"
    (binary / "id24").mkdir(parents=True)
    np.save(str(binary / "id24" / "trainval_dataset.npy"), j_synthetic(num_frames=12, H=H, W=W), allow_pickle=True)
    jm = JA2M(in_out_dim=64, audio_in_dim=64, hidden_channels=32, enc_n_layers=2, dec_n_layers=2,
              flow_hidden=16, flow_n_blocks=2)
    batch = {"audio": jnp.zeros((1, 16, 64)), "f0": jnp.zeros((1, 16)), "y_mask": jnp.ones((1, 8)),
             "y": jnp.zeros((1, 8, 64))}
    rs = np.random.RandomState(3)
    av = _np(jax.jit(lambda: jm.init(jax.random.PRNGKey(2), batch, train=True, rng=jax.random.PRNGKey(1)))())
    av["params"] = jax.tree_util.tree_map_with_path(  # non-identity flows
        lambda p, x: np.asarray(rs.randn(*x.shape) * 0.1, np.float32) if any(
            getattr(k, "key", None) == "post" for k in p) else x, av["params"])
    save_checkpoint(str(tmp / "a2m"), 3, {"state_dict": {"step": 3, "variables": av, "opt_state": {}},
                                          "extra_state": {}}, config=A2M)
    cfg = JConfig.from_hparams(HEAD)
    hv = _np(jax.jit(lambda: JRADNeRF(cfg).init(jax.random.PRNGKey(4), jnp.zeros((8, 3)), jnp.ones((8, 3)),
                                                  jnp.zeros((3, 1, 204))))())
    opt = flax.serialization.to_state_dict(optax.adam(1e-3).init(hv))
    save_checkpoint(str(tmp / "head"), 5, {"state_dict": {"step": 5, "params": hv, "opt_state": opt},
                                           "extra_state": {"occupancy": _bench_occupancy(16)}},
                    config=dict(HEAD, binary_data_dir=str(binary)))
    j_inf = _JInfer(audio2secc_dir=str(tmp / "a2m"), head_model_dir=str(tmp / "head"))
    t_inf = TInfer.from_work_dirs(audio2secc_dir=str(tmp / "a2m"), head_model_dir=str(tmp / "head"), device="cpu")
    return j_inf, t_inf


def _audio(seconds, seed=0):
    rs = np.random.RandomState(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    wav = (0.3 * np.sin(2 * np.pi * (120.0 + 40.0 * t) * t) + 0.003 * rs.randn(len(t))).astype(np.float32)
    return wav, rs.randn(int(seconds * 50) + 16, 64).astype(np.float32)


def _recording(infer, into):
    """`infer.forward_audio2secc`, keeping each chunk's condition."""
    forward = infer.forward_audio2secc

    def run(batch, inp, *a, **kw):
        out = forward(batch, inp, *a, **kw)
        into.append(np.asarray(out["cond"]))
        return out
    return run


def test_stream_matches_jax_at_temperature_0(pair, monkeypatch):
    j_inf, t_inf = pair
    wav, hubert = _audio(2.6)
    inp = {"hubert_full": hubert, "temperature": 0.0}
    j_conds, t_conds = [], []
    monkeypatch.setattr(j_inf, "forward_audio2secc", _recording(j_inf, j_conds))
    monkeypatch.setattr(t_inf, "forward_audio2secc", _recording(t_inf, t_conds))
    ref = list(j_serving.stream_infer(j_inf, wav, dict(inp), chunk_seconds=1.0))
    got = list(serving.stream_infer(t_inf, wav, dict(inp), chunk_seconds=1.0))
    assert len(got) == len(ref) > 50 and len(t_conds) == len(j_conds) == 3
    for a, b in zip(t_conds, j_conds):
        np.testing.assert_allclose(a, b, atol=ATOL)
    for a, b in zip(got, ref):
        assert a.shape == (H, W, 3) and a.dtype == np.uint8
        d = a.astype(np.float64) - b.astype(np.float64)
        mse = float(np.mean(d ** 2))
        assert (math.inf if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)) >= MIN_PSNR
        assert np.abs(d).mean() <= MAX_MEAN_ABS
    assert any(not np.array_equal(got[0], f) for f in got[1:])


def test_stream_has_no_audio_drift(pair):
    """The cursor moves by the samples a chunk consumed: the frames cover
    the audio up to a tail shorter than the 0.2 s that is dropped (a cursor
    moved by the nominal chunk drops ~4 frames a chunk)."""
    _, t_inf = pair
    wav, hubert = _audio(4.0, seed=1)
    n = sum(1 for _ in serving.stream_infer(t_inf, wav, {"hubert_full": hubert, "temperature": 0.0},
                                            chunk_seconds=1.0))
    assert 0 <= len(wav) - n * HOP < 16000 // 5, n
    assert 25 * 4 - 25 <= n <= 25 * 4


@pytest.mark.parametrize("temperature", [0.0, 0.2])
def test_a_resumed_stream_is_the_uninterrupted_tail(pair, temperature):
    """Reconnect after chunk 1 (24 frames): the resumed stream's frames are
    the uninterrupted stream's, bit for bit. With a draw, the generator is
    replayed to where the uninterrupted stream entered chunk 2."""
    _, t_inf = pair
    wav, hubert = _audio(2.6, seed=2)
    inp = {"hubert_full": hubert, "temperature": temperature}
    t_inf.generator.manual_seed(42)
    full = list(serving.stream_infer(t_inf, wav, dict(inp), chunk_seconds=1.0))
    k = 24
    t_inf.generator.manual_seed(42)
    if temperature:
        torch.randn((1, t_inf.a2m_model.vae.latent_length(k), 16), generator=t_inf.generator)
    resumed = list(serving.stream_infer(t_inf, wav, dict(inp, resume_from_frame=k), chunk_seconds=1.0))
    assert len(resumed) == len(full) - k > 0
    for a, b in zip(resumed, full[k:]):
        np.testing.assert_array_equal(a, b)


def test_chunk_k_is_drained_after_chunk_k_plus_1_is_launched(pair, monkeypatch):
    _, t_inf = pair
    events = []
    launch, drain = t_inf.launch_secc2video, t_inf.drain_frames

    def launched(batch, inp, *a, **kw):
        out = launch(batch, inp, *a, **kw)
        events.append(("launch", id(out)))
        return out

    def drained(chunks):
        events.append(("drain", id(chunks)))
        yield from drain(chunks)

    monkeypatch.setattr(t_inf, "launch_secc2video", launched)
    monkeypatch.setattr(t_inf, "drain_frames", drained)
    wav, hubert = _audio(3.2, seed=3)
    frames = list(serving.stream_infer(t_inf, wav, {"hubert_full": hubert, "temperature": 0.0}, chunk_seconds=1.0))
    kinds = [e[0] for e in events]
    assert kinds == ["launch", "launch", "drain", "launch", "drain", "launch", "drain", "drain"]
    order = [e[1] for e in events]
    assert order[2] == order[0] and order[4] == order[1] and order[6] == order[3] and order[7] == order[5]
    assert len(frames) == 24 * 3 + 4


def test_stream_needs_features(pair):
    _, t_inf = pair
    wav, _ = _audio(1.0)
    with pytest.raises(RuntimeError, match="hubert_full"):
        next(serving.stream_infer(t_inf, wav, {}))


# ---------------------------------------------------------------- FramePusher, metrics


def test_pusher_slow_client_drops_oldest_never_blocks():
    """The client holds its first frame until every push has returned, then
    takes 20 ms a frame: all 100 pushes return while it has sent nothing,
    so the producer is not paced by it (no clock involved; were a push to
    wait for the client, the client's 60 s guard would release it and
    frames would be sent before the last push returned)."""
    metrics = ServingMetrics()
    sent = []
    release = threading.Event()

    def slow_send(item):
        release.wait(timeout=60)
        time.sleep(0.02)
        sent.append(item)

    pusher = serving.FramePusher(slow_send, maxsize=4, metrics=metrics)
    for i in range(100):
        pusher.push(i)
    assert sent == []  # every push returned before the client sent a frame
    release.set()
    pusher.close()
    assert pusher.sent == len(sent) and pusher.sent + pusher.dropped == 100 and pusher.dropped > 0
    assert sent == sorted(sent)
    snap = metrics.snapshot()
    assert snap["frames"] == {"pushed": pusher.sent, "dropped": pusher.dropped}


def test_pusher_fast_client_keeps_every_frame():
    sent = []
    pusher = serving.FramePusher(sent.append, maxsize=8, metrics=ServingMetrics())
    for i in range(50):
        pusher.push(i)
        time.sleep(0.001)
    pusher.close()
    assert sent == list(range(50)) and pusher.dropped == 0


def test_pusher_dead_client_raises_client_gone():
    def broken_send(item):
        raise OSError("connection reset")

    pusher = serving.FramePusher(broken_send, maxsize=4, metrics=ServingMetrics())
    with pytest.raises(serving.ClientGone):
        for i in range(1000):
            pusher.push(i)
            time.sleep(0.001)
    pusher.close()


def test_metrics_record_gaps_rtf_and_failures():
    m = ServingMetrics()
    assert list(instrumented((i for i in range(30)), metrics=m)) == list(range(30))
    snap = m.snapshot()
    assert snap["streams"] == {"started": 1, "completed": 1, "failed": 0}
    assert snap["frame_gap_ms"]["total"] == 30 and snap["rtf"]["last"] > 0

    def boom():
        yield 1
        raise RuntimeError("render died")

    with pytest.raises(RuntimeError):
        list(instrumented(boom(), metrics=m))
    assert m.snapshot()["streams"]["failed"] == 1
    h = LatencyHistogram(edges_ms=(10.0, 100.0))
    for v in (1.0, 50.0, 1e6):
        h.record(v)
    assert h.snapshot()["buckets"] == {"le_10ms": 1, "le_100ms": 1, "gt_100ms": 1}
