"""The web app: a standard-library HTTP server with a form, `/metrics`, a
live MJPEG stream and a WebSocket frame push (port of
`genefaceplusplus_tpu/inference/app.py`).

    python -m genefaceplusplus_tpu_torch.inference.app --a2m_ckpt A --torso_ckpt T [--port 7860]

- `GET /`: the form (the reference's controls: blink mode, temperature,
  lle_percent, mouth_amp, T_thresh, drv_pose).
- `GET /metrics`: `METRICS.snapshot()` as JSON.
- `GET /ws` with an upgrade (RFC 6455): the client sends one text frame, a
  JSON `inp` naming server-side files; each rendered frame comes back as a
  binary JPEG message, then a close frame. A declared length past
  `WS_MAX_PAYLOAD` is answered with a 1009 close before anything is read.
- `POST /stream` (multipart form): frames as `multipart/x-mixed-replace`
  JPEG parts, as the stream renders them.
- `POST /infer` (multipart form): the whole clip, as the file that
  `infer_once` writes (an AVI, `video/x-msvideo`).

Renders are serialised by one lock; `FramePusher` drops the oldest frame
for a slow client and stops the render when the client is gone. JPEG
frames come from `data/image_io.py:jpeg_bytes`, bit-equal to the
`cv2.imencode` of the JAX app. Uploaded files are written under the
temporary directory by their base name, as JAX's app writes them under
`/tmp`. JAX's gradio branch is not ported.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import shutil
import struct
import tempfile
import threading
from email.parser import BytesParser
from email.policy import HTTP
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from genefaceplusplus_tpu_torch.data import audio as audio_lib
from genefaceplusplus_tpu_torch.data.image_io import jpeg_bytes
from genefaceplusplus_tpu_torch.inference.metrics import METRICS, instrumented
from genefaceplusplus_tpu_torch.inference.serving import ClientGone, FramePusher, stream_infer

FORM = """<!doctype html><title>GeneFace++-TPU</title>
<h2>GeneFace++-TPU inference</h2>
<form method=post enctype=multipart/form-data action=/infer>
wav file: <input type=file name=wav><br>
precomputed features npy: <input type=file name=feats><br>
blink mode: <select name=blink_mode><option>period</option><option>none</option></select><br>
temperature: <input name=temperature value=0.2><br>
lle_percent: <input name=lle_percent value=0.2><br>
mouth_amp: <input name=mouth_amp value=0.4><br>
T_thresh: <input name=T_thresh value=0.01><br>
drv_pose: <input name=drv_pose value=nearest><br>
<input type=submit value=Generate>
</form>
<form method=post enctype=multipart/form-data action=/stream>
wav file: <input type=file name=wav>
<input type=submit value="Live stream (MJPEG)">
</form>"""

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
_FLOAT_KEYS = ("temperature", "lle_percent", "mouth_amp", "T_thresh")


def _ws_accept_key(key: str) -> str:
    return base64.b64encode(hashlib.sha1((key + _WS_GUID).encode()).digest()).decode()


def ws_send(wfile, payload: bytes, opcode: int = 0x2) -> None:
    """Write one unmasked server frame (FIN set). opcode 0x1 text, 0x2
    binary, 0x8 close."""
    n = len(payload)
    head = bytes([0x80 | opcode])
    if n < 126:
        head += bytes([n])
    elif n < 65536:
        head += bytes([126]) + struct.pack(">H", n)
    else:
        head += bytes([127]) + struct.pack(">Q", n)
    wfile.write(head + payload)
    wfile.flush()


class WSMessageTooBig(ValueError):
    """The client declared a frame longer than the server accepts."""


# The only inbound message is the JSON `inp`, a few KB. The declared length
# is the client's (up to 2^64 - 1 in the 127 form): cap it far below
# anything that could exhaust memory.
WS_MAX_PAYLOAD = 4 * 2 ** 20


def ws_recv(rfile, max_len: int = WS_MAX_PAYLOAD):
    """Read one client frame -> (opcode, payload); client frames are masked
    (RFC 6455 5.3). Returns (None, b"") at EOF. Raises WSMessageTooBig before
    reading the payload where the declared length exceeds `max_len` (the
    caller answers with a 1009 close frame)."""
    hdr = rfile.read(2)
    if len(hdr) < 2:
        return None, b""
    b1, b2 = hdr
    opcode = b1 & 0x0F
    masked = b2 & 0x80
    n = b2 & 0x7F
    if n == 126:
        n = struct.unpack(">H", rfile.read(2))[0]
    elif n == 127:
        n = struct.unpack(">Q", rfile.read(8))[0]
    if n > max_len:
        raise WSMessageTooBig(f"ws frame of {n} bytes exceeds cap {max_len}")
    mask = rfile.read(4) if masked else b"\x00\x00\x00\x00"
    data = np.frombuffer(rfile.read(n), np.uint8)
    return opcode, (data ^ np.resize(np.frombuffer(mask, np.uint8), len(data))).tobytes()


def _load_stream_audio(inp):
    """The request's 16 kHz waveform: a wav file (`drv_aud`), or the
    `wav16k` of precomputed features (`drv_aud_features`), whose HuBERT rows
    go to `inp['hubert_full']` for `stream_infer`."""
    wav = audio_lib.load_wav_16k(inp["drv_aud"]) if inp.get("drv_aud") else None
    if wav is None and inp.get("drv_aud_features"):
        feats = np.load(inp["drv_aud_features"], allow_pickle=True).tolist()
        inp["hubert_full"] = np.asarray(feats["hubert"], np.float32)
        t = len(inp["hubert_full"]) * audio_lib.HOP_SIZE
        wav = np.asarray(feats.get("wav16k", np.zeros(t, np.float32)))
    return wav


def _jpeg_stream(infer, wav, inp, pusher: FramePusher, lock: threading.Lock) -> None:
    """Render the request's frames under the serve lock and push each as a
    JPEG."""
    with lock:
        for frame in instrumented(stream_infer(infer, wav, inp)):
            pusher.push(jpeg_bytes(frame))


def _form_inp(headers, body: bytes) -> dict:
    """The request `inp` of a multipart/form-data body, as JAX's app builds
    it: the form's controls (floats where JAX converts them), and the `wav`
    and `feats` uploads written under the temporary directory by their base
    name. Raises ValueError for a body that is not such a form."""
    msg = BytesParser(policy=HTTP).parsebytes(
        b"Content-Type: " + headers.get("Content-Type", "").encode("latin-1") + b"\r\n\r\n" + body)
    if not msg.is_multipart():
        raise ValueError("the request is not multipart/form-data")
    form = {part.get_param("name", header="content-disposition"): (part.get_filename(), part.get_payload(decode=True))
            for part in msg.iter_parts()}
    tmp = tempfile.gettempdir()
    inp = {"out_name": os.path.join(tmp, "webui_out.mp4")}
    for k in ("blink_mode", "drv_pose") + _FLOAT_KEYS:
        value = form.get(k, (None, b""))[1].decode()
        if value:
            inp[k] = float(value) if k in _FLOAT_KEYS else value
    for field, key in (("wav", "drv_aud"), ("feats", "drv_aud_features")):
        filename, data = form.get(field, (None, b""))
        if filename:
            path = os.path.join(tmp, os.path.basename(filename))
            with open(path, "wb") as f:
                f.write(data)
            inp[key] = path
    return inp


def make_server(infer, host: str = "0.0.0.0", port: int = 7860) -> ThreadingHTTPServer:
    """The app's server over `infer` (a `GeneFaceInfer` with an a2m), bound
    and not yet serving (`serve_forever`, `shutdown`). Threaded: a long
    `/stream` or `/ws` push does not block other clients, while renders
    take turns on one lock."""
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            route = self.path.split("?")[0].rstrip("/")
            if route == "/ws" and "websocket" in self.headers.get("Upgrade", "").lower():
                self._handle_ws()
                return
            if route == "/metrics":
                body = json.dumps(METRICS.snapshot(), indent=1).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.end_headers()
            self.wfile.write(FORM.encode())

        def _handle_ws(self):
            """The client upgrades, sends one text frame of JSON `inp`
            (server-side wav or features paths), and receives each rendered
            frame as a binary JPEG message, then a close frame."""
            # RFC 6455 needs an HTTP/1.1 status line; browsers refuse the upgrade under HTTP/1.0
            self.protocol_version = "HTTP/1.1"
            self.send_response(101)
            self.send_header("Upgrade", "websocket")
            self.send_header("Connection", "Upgrade")
            self.send_header("Sec-WebSocket-Accept", _ws_accept_key(self.headers.get("Sec-WebSocket-Key", "")))
            self.end_headers()
            # the socket now carries WebSocket bytes: no keep-alive parse of them as HTTP
            self.close_connection = True
            try:
                try:
                    opcode, payload = ws_recv(self.rfile)
                except WSMessageTooBig:
                    ws_send(self.wfile, struct.pack(">H", 1009) + b"message too big", opcode=0x8)
                    return
                if opcode != 0x1:  # not the JSON text frame
                    ws_send(self.wfile, b"", opcode=0x8)
                    return
                inp = json.loads(payload.decode())
                wav = _load_stream_audio(inp)
                if wav is None:
                    raise ValueError("inp needs 'drv_aud' or 'drv_aud_features'")
                # a slow client drops frames (live) instead of stalling the render and the lock
                pusher = FramePusher(lambda jpg: ws_send(self.wfile, jpg, opcode=0x2),
                                     maxsize=int(inp.get("push_queue_frames", 16)))
                try:
                    _jpeg_stream(infer, wav, inp, pusher, lock)
                except ClientGone:
                    return  # the client left mid-stream: nobody to tell
                finally:
                    pusher.close()
            except Exception as e:  # tell the client before closing
                try:
                    ws_send(self.wfile, f"error: {e}".encode(), opcode=0x1)
                except OSError:
                    return
            try:
                ws_send(self.wfile, b"", opcode=0x8)
            except OSError:
                pass

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n < 0:
                    raise ValueError(f"Content-Length {n}")
                inp = _form_inp(self.headers, self.rfile.read(n))
            except ValueError as e:
                self.send_error(400, str(e))
                return

            if self.path.rstrip("/") == "/stream":
                # multipart/x-mixed-replace: the video starts after the first chunk of audio, not the clip
                wav = _load_stream_audio(inp)
                self.send_response(200)
                self.send_header("Content-Type", "multipart/x-mixed-replace; boundary=frame")
                self.end_headers()

                def send_part(jpg: bytes) -> None:
                    self.wfile.write(b"--frame\r\nContent-Type: image/jpeg\r\n\r\n")
                    self.wfile.write(jpg)
                    self.wfile.write(b"\r\n")

                pusher = FramePusher(send_part, maxsize=int(inp.get("push_queue_frames", 16)))
                try:
                    _jpeg_stream(infer, wav, inp, pusher, lock)
                except ClientGone:
                    pass  # the browser closed the stream
                finally:
                    pusher.close()
                return

            with lock:  # opened under the lock: a later /infer replaces the name, not this file
                f = open(infer.infer_once(inp), "rb")
            with f:
                self.send_response(200)
                self.send_header("Content-Type", "video/x-msvideo")
                self.send_header("Content-Length", str(os.fstat(f.fileno()).st_size))
                self.end_headers()
                shutil.copyfileobj(f, self.wfile)

        def log_message(self, *a):
            pass

    return ThreadingHTTPServer((host, port), Handler)


def serve(infer, host: str = "0.0.0.0", port: int = 7860):
    """Serve the app over `infer` until interrupted."""
    server = make_server(infer, host, port)
    print(f"| serving on http://{host}:{server.server_address[1]}")
    try:
        server.serve_forever()
    finally:
        server.server_close()


def main(argv=None):
    from genefaceplusplus_tpu_torch.inference.cli import build_parser, unported_flags
    from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer

    p = build_parser()
    p.add_argument("--port", type=int, default=7860)
    args = p.parse_args(argv)
    unported_flags(args)
    infer = GeneFaceInfer.from_work_dirs(
        audio2secc_dir=args.a2m_ckpt or None,
        head_model_dir=args.head_ckpt or None,
        torso_model_dir=args.torso_ckpt or None,
        postnet_dir=args.postnet_ckpt or None,
        device=args.device,
    )
    serve(infer, port=args.port)


if __name__ == "__main__":
    main()
