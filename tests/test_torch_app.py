"""The port's web app (`inference/app.py`) against the JAX package's
(`genefaceplusplus_tpu/inference/app.py`), on the CPU over loopback.

- The WebSocket framing: `ws_send` / `ws_recv` round-trip every length
  class (7-bit, 16-bit, 64-bit), masked and unmasked; a declared length
  past the cap is refused before the payload is read; `_ws_accept_key`
  gives RFC 6455's example.
- Both apps serve the same seeded uint8 frames (each package's
  `stream_infer` replaced by the same generator): the bytes on the wire
  are equal for the WebSocket (the frames after the upgrade) and for the
  MJPEG stream (the body), the headers equal but for `Date`, and
  `/metrics` parses as JSON. JAX encodes with cv2, the port with
  `jpeg_bytes`.
- End to end over a small CPU `GeneFaceInfer` (16^2 frames, 16 of them):
  the WebSocket and MJPEG frames are `jpeg_bytes` of a direct
  `stream_infer`'s frames at temperature 0, byte for byte; `POST /infer`
  returns a readable AVI."""

import base64
import io
import json
import os
import socket
import struct
import tempfile
import threading
import time
import types

import numpy as np
import pytest

from genefaceplusplus_tpu_torch.data.audio import pcm16
from genefaceplusplus_tpu_torch.data.image_io import jpeg_bytes
from genefaceplusplus_tpu_torch.data.video import read_avi
from genefaceplusplus_tpu_torch.inference import app
from genefaceplusplus_tpu_torch.inference.serving import stream_infer
from genefaceplusplus_tpu_torch.testing import tiny_infer


def _client_frame(payload: bytes, opcode: int = 0x1, mask: bytes = b"\x11\x22\x33\x44", fin: bool = True) -> bytes:
    n = len(payload)
    head = bytes([(0x80 if fin else 0) | opcode])
    bit = 0x80 if mask else 0
    if n < 126:
        head += bytes([bit | n])
    elif n < 65536:
        head += bytes([bit | 126]) + struct.pack(">H", n)
    else:
        head += bytes([bit | 127]) + struct.pack(">Q", n)
    if not mask:
        return head + payload
    return head + mask + bytes(b ^ mask[i % 4] for i, b in enumerate(payload))


def _server_frames(data: bytes):
    """[(opcode, payload)] of unmasked server frames."""
    out, i = [], 0
    while i < len(data):
        opcode, n = data[i] & 0x0F, data[i + 1] & 0x7F
        assert data[i] & 0x80 and not data[i + 1] & 0x80  # FIN, unmasked
        i += 2
        if n == 126:
            n, i = struct.unpack(">H", data[i:i + 2])[0], i + 2
        elif n == 127:
            n, i = struct.unpack(">Q", data[i:i + 8])[0], i + 8
        out.append((opcode, data[i:i + n]))
        i += n
    assert i == len(data)
    return out


@pytest.mark.parametrize("n", [0, 1, 125, 126, 1000, 65535, 65536, 70001])
@pytest.mark.parametrize("masked", [True, False])
def test_ws_round_trip(n, masked):
    payload = np.random.RandomState(n).randint(0, 256, n).astype(np.uint8).tobytes()
    rfile = io.BytesIO(_client_frame(payload, 0x2, mask=b"\x9a\x01\xff\x37" if masked else b""))
    assert app.ws_recv(rfile) == (0x2, payload)
    assert app.ws_recv(rfile) == (None, b"")  # EOF
    wfile = io.BytesIO()
    app.ws_send(wfile, payload, opcode=0x2)
    assert _server_frames(wfile.getvalue()) == [(0x2, payload)]


@pytest.mark.parametrize("head", [bytes([0x81, 0x80 | 127]) + struct.pack(">Q", 2 ** 63),
                                  bytes([0x81, 0x80 | 127]) + struct.pack(">Q", app.WS_MAX_PAYLOAD + 1),
                                  bytes([0x81, 0x80 | 126]) + struct.pack(">H", 60_000)])
def test_ws_refuses_an_oversized_declared_length(head):
    rfile = io.BytesIO(head + b"\x00" * 64)
    with pytest.raises(app.WSMessageTooBig):
        app.ws_recv(rfile, max_len=app.WS_MAX_PAYLOAD if head[1] & 0x7F == 127 else 50_000)
    assert rfile.tell() == len(head)  # neither the mask nor the payload was read


def test_ws_accept_key_is_rfc6455s_example():
    assert app._ws_accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _exchange(port: int, request: bytes) -> bytes:
    """Send `request`, read until the server closes."""
    with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
        s.sendall(request)
        chunks = []
        while True:
            b = s.recv(1 << 16)
            if not b:
                return b"".join(chunks)
            chunks.append(b)


def _ws_request(inp: dict) -> bytes:
    key = base64.b64encode(os.urandom(16)).decode()
    return (f"GET /ws HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n").encode() + _client_frame(
        json.dumps(inp).encode())


def _post(route: str, fields: dict, files: dict) -> bytes:
    boundary = "gfppBoundary7MA4YWxk"
    body = io.BytesIO()
    for name, value in fields.items():
        body.write(f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"\r\n\r\n{value}\r\n'.encode())
    for name, (filename, data) in files.items():
        body.write(f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"; filename="{filename}"\r\n'
                   "Content-Type: application/octet-stream\r\n\r\n".encode() + data + b"\r\n")
    body.write(f"--{boundary}--\r\n".encode())
    data = body.getvalue()
    return (f"POST {route} HTTP/1.1\r\nHost: x\r\nContent-Type: multipart/form-data; boundary={boundary}\r\n"
            f"Content-Length: {len(data)}\r\n\r\n").encode() + data


def _split(response: bytes):
    """(status line, {header: value} without Date, body)."""
    head, body = response.split(b"\r\n\r\n", 1)
    lines = head.decode("latin-1").split("\r\n")
    return lines[0], {k: v for k, v in (line.split(": ", 1) for line in lines[1:]) if k != "Date"}, body


def _mjpeg_parts(body: bytes):
    parts = body.split(b"--frame\r\nContent-Type: image/jpeg\r\n\r\n")
    assert parts[0] == b"" and all(p.endswith(b"\r\n") for p in parts[1:])
    return [p[:-2] for p in parts[1:]]


def _port_server(infer):
    server = app.make_server(infer, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def _stop(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def _features(path, seed=1, t50=32):
    rs = np.random.RandomState(seed)
    feats = {"hubert": rs.randn(t50, 64).astype(np.float32),
             "f0": (np.abs(rs.randn(t50)) * 100 + 80).astype(np.float32),
             "wav16k": (rs.randn(t50 * 320 + 500) * 0.2).astype(np.float32)}
    np.save(path, feats, allow_pickle=True)
    with open(path, "rb") as f:
        return feats, f.read()


def test_both_apps_put_the_same_bytes_on_the_wire(tmp_path, monkeypatch):
    pytest.importorskip("cv2")  # JAX's app encodes with cv2
    from genefaceplusplus_tpu.inference import app as j_app
    from genefaceplusplus_tpu.inference import serving as j_serving

    frames = np.random.RandomState(4).randint(0, 256, (6, 24, 40, 3)).astype(np.uint8)
    frames[2] = 0  # a flat frame too
    calls = []

    def fake_stream(infer, wav, inp):
        calls.append((len(wav), sorted(inp)))
        yield from frames

    monkeypatch.setattr(j_serving, "stream_infer", fake_stream)
    monkeypatch.setattr(app, "stream_infer", fake_stream)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    # JAX's app joins uploads onto a fixed "/tmp" (its only use of os): route them into tmp_path
    j_tmp = tmp_path / "jax_tmp"
    j_tmp.mkdir()
    monkeypatch.setattr(j_app, "os", types.SimpleNamespace(path=types.SimpleNamespace(
        join=lambda _tmp, name: str(j_tmp / name), basename=os.path.basename)))
    feats_path = str(tmp_path / "wire_feats.npy")
    _, feats_bytes = _features(feats_path)
    j_port = _free_port()
    threading.Thread(target=j_app.serve, args=(None, "127.0.0.1", j_port), daemon=True).start()
    server, thread = _port_server(None)
    t_port = server.server_address[1]
    for _ in range(100):  # JAX's server binds in its thread
        try:
            socket.create_connection(("127.0.0.1", j_port), timeout=1).close()
            break
        except OSError:
            time.sleep(0.05)
    try:
        inp = {"drv_aud_features": feats_path, "temperature": 0.0}
        request = _ws_request(inp)
        ws = [_split(_exchange(p, request)) for p in (j_port, t_port)]
        assert ws[0][0] == ws[1][0] == "HTTP/1.1 101 Switching Protocols"
        assert ws[0][1] == ws[1][1] and ws[0][2] == ws[1][2]
        got = _server_frames(ws[1][2])
        assert [p for op, p in got] == [jpeg_bytes(f) for f in frames] + [b""]
        assert [op for op, _ in got] == [0x2] * len(frames) + [0x8]

        request = _post("/stream", {"temperature": "0"}, {"feats": ("wire_feats.npy", feats_bytes)})
        mjpeg = [_split(_exchange(p, request)) for p in (j_port, t_port)]
        assert mjpeg[0][0] == mjpeg[1][0] == "HTTP/1.0 200 OK"
        assert mjpeg[0][1] == mjpeg[1][1] and mjpeg[0][2] == mjpeg[1][2]
        assert _mjpeg_parts(mjpeg[1][2]) == [jpeg_bytes(f) for f in frames]
        assert os.listdir(j_tmp) == ["wire_feats.npy"] and (j_tmp / "wire_feats.npy").read_bytes() == feats_bytes

        for p in (j_port, t_port):
            status, headers, body = _split(_exchange(p, b"GET /metrics HTTP/1.1\r\nHost: x\r\n\r\n"))
            assert status.endswith("200 OK") and headers["Content-Type"] == "application/json"
            assert json.loads(body)["streams"]["started"] >= 2
        forms = [_split(_exchange(p, b"GET / HTTP/1.1\r\nHost: x\r\n\r\n"))[2] for p in (j_port, t_port)]
        assert forms[0] == forms[1] == app.FORM.encode()
    finally:
        _stop(server, thread)
    assert len(calls) == 4 and calls[0] == calls[1] and calls[2] == calls[3]


def test_a_too_big_ws_message_is_closed_with_1009(monkeypatch):
    monkeypatch.setattr(app, "stream_infer", lambda *a: pytest.fail("rendered"))
    server, thread = _port_server(None)
    try:
        head = bytes([0x81, 0x80 | 127]) + struct.pack(">Q", app.WS_MAX_PAYLOAD + 1)
        key = base64.b64encode(os.urandom(16)).decode()
        request = (f"GET /ws HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
                   f"Sec-WebSocket-Key: {key}\r\n\r\n").encode() + head
        _, _, body = _split(_exchange(server.server_address[1], request))
        assert _server_frames(body) == [(0x8, struct.pack(">H", 1009) + b"message too big")]
    finally:
        _stop(server, thread)


def test_the_app_serves_a_cpu_geneface_infer(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    infer = tiny_infer()
    feats_path = str(tmp_path / "request.npy")
    feats, feats_bytes = _features(feats_path)
    inp = {"drv_aud_features": feats_path, "temperature": 0.0}
    direct_inp = dict(inp)
    direct = [jpeg_bytes(f) for f in stream_infer(infer, app._load_stream_audio(direct_inp), direct_inp)]
    assert len(direct) == 16  # at most FramePusher's queue and one in flight: nothing can be dropped
    server, thread = _port_server(infer)
    port = server.server_address[1]
    try:
        _, _, body = _split(_exchange(port, _ws_request(inp)))
        assert _server_frames(body) == [(0x2, jpg) for jpg in direct] + [(0x8, b"")]
        upload = {"feats": ("../up/request.npy", feats_bytes)}  # reduced to its base name
        _, headers, body = _split(_exchange(port, _post("/stream", {"temperature": "0"}, upload)))
        assert headers["Content-Type"] == "multipart/x-mixed-replace; boundary=frame"
        assert _mjpeg_parts(body) == direct
        status, headers, body = _split(_exchange(port, _post("/infer", {"temperature": "0", "blink_mode": "none"},
                                                             upload)))
        assert status == "HTTP/1.0 200 OK" and headers["Content-Type"] == "video/x-msvideo"
        assert int(headers["Content-Length"]) == len(body)
        with open(tmp_path / "reply.avi", "wb") as f:
            f.write(body)
        frames, pcm = read_avi(str(tmp_path / "reply.avi"))
        assert frames.shape == (16, 16, 16, 3)
        np.testing.assert_array_equal(pcm, pcm16(feats["wav16k"]))
        assert body == open(tmp_path / "webui_out.avi", "rb").read()
        metrics = json.loads(_split(_exchange(port, b"GET /metrics HTTP/1.1\r\nHost: x\r\n\r\n"))[2])
        assert metrics["streams"]["completed"] >= 2 and metrics["frames"]["pushed"] >= 32
        status, _, _ = _split(_exchange(port, b"POST /infer HTTP/1.1\r\nHost: x\r\nContent-Type: text/plain\r\n"
                                              b"Content-Length: 2\r\n\r\nhi"))
        assert status.startswith("HTTP/1.0 400")
        status, _, _ = _split(_exchange(port, _post("/infer", {"temperature": "warm"}, {})))
        assert status.startswith("HTTP/1.0 400")  # a control that is not a number
    finally:
        _stop(server, thread)
