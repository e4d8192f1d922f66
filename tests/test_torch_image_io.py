"""The port's image codec (`genefaceplusplus_tpu_torch/data/image_io.py`,
`csrc/image_codec.cpp`) against cv2, which the JAX package reads and writes
its dataset's images with (libjpeg-turbo and libpng): decodes equal cv2's
exactly, the encoder's bytes equal cv2.imencode's at cv2's defaults (quality
95, 4:2:0), and every unsupported feature raises ValueError naming it.

The committed fixtures (`tests/torch_image_fixtures/`, written by
`make_fixtures`) carry the sha256 of cv2's decodes, so the port's decoder is
held to cv2 where cv2 is absent too (`chip_smoke.py` holds them on the
card's machine). Regenerate them with `python tests/test_torch_image_io.py`.
"""

import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest

from genefaceplusplus_tpu_torch.data import image_io

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_image_fixtures")
SAMPLING = {"4:4:4": 0x111111, "4:2:2": 0x211111, "4:2:0": 0x221111}


def _cv2():
    return pytest.importorskip("cv2")


def frame(h: int, w: int, seed: int, noise: float = 24.0) -> np.ndarray:
    """A seeded uint8 RGB frame: smooth colour waves plus noise."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([127 + 110 * np.sin(x / 7.0 + y / 11.0), 127 + 100 * np.cos(x / 5.0 - y / 3.0),
                    (x * 3 + y * 5) % 256], -1)
    return np.clip(img + rs.randn(h, w, 3) * noise, 0, 255).astype(np.uint8)


def cv2_jpeg(rgb, quality=95, sampling="4:2:0", rst=0, optimize=False, progressive=False) -> bytes:
    cv2 = _cv2()
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
              cv2.IMWRITE_JPEG_RST_INTERVAL, rst, cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize),
              cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)]
    ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(rgb[..., ::-1]), params)
    assert ok
    return enc.tobytes()


def cv2_decode(data: bytes) -> np.ndarray:
    """JAX's read: cv2.imread(IMREAD_UNCHANGED) + cvtColor to RGB(A)."""
    cv2 = _cv2()
    raw = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    if raw.shape[-1] == 4:
        return np.concatenate([cv2.cvtColor(raw[..., :3], cv2.COLOR_BGR2RGB), raw[..., 3:]], -1)
    return cv2.cvtColor(raw, cv2.COLOR_BGR2RGB)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def png_with(rows: bytes, w: int, h: int, depth=8, color=2, interlace=0, extra=b"") -> bytes:
    """A PNG of already-filtered rows, with any header."""
    return (image_io.PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
            + extra + _chunk(b"IDAT", zlib.compress(rows)) + _chunk(b"IEND", b""))


def filtered_png(img: np.ndarray, filters) -> bytes:
    """img's rows written with the given filter type per row (0-4), as a
    PNG encoder would apply them."""
    h, w, ch = img.shape
    a = img.reshape(h, w * ch).astype(np.int64)
    out = []
    for y in range(h):
        ft = filters[y % len(filters)]
        x = a[y]
        up = a[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(ch, np.int64), x[:-ch]])
        ul = np.concatenate([np.zeros(ch, np.int64), up[:-ch]])
        if ft == 0:
            pred = np.zeros_like(x)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        out.append(bytes([ft]) + ((x - pred) % 256).astype(np.uint8).tobytes())
    return png_with(b"".join(out), w, h, color=2 if ch == 3 else 6)


# the fixtures: images written by cv2 (JPEG, PNG) or by hand (the filter
# rows), and the encoder's input (a seeded frame)
ENCODER_INPUT = "encoder_input.npy"


def make_fixtures() -> dict:
    """{file name: bytes} of every fixture but the hashes."""
    cv2 = _cv2()
    img = frame(45, 67, seed=3)
    rgba = np.concatenate([frame(37, 29, seed=4), (frame(37, 29, seed=5, noise=0)[..., :1] > 128) * 255], -1)
    rgba = rgba.astype(np.uint8)
    ok, p_rgb = cv2.imencode(".png", img[..., ::-1].copy())
    ok2, p_rgba = cv2.imencode(".png", np.concatenate([rgba[..., 2::-1], rgba[..., 3:]], -1).copy())
    assert ok and ok2
    return {
        "j444_q90.jpg": cv2_jpeg(img, 90, "4:4:4"),
        "j422_q75.jpg": cv2_jpeg(img, 75, "4:2:2"),
        "j420_q95.jpg": cv2_jpeg(img, 95, "4:2:0"),
        "j420_q50_rst2.jpg": cv2_jpeg(img, 50, "4:2:0", rst=2),
        "j422_q85_rst1_opt.jpg": cv2_jpeg(img, 85, "4:2:2", rst=1, optimize=True),
        "j420_q100_23x17.jpg": cv2_jpeg(frame(23, 17, seed=6), 100, "4:2:0"),
        "j420_1x1.jpg": cv2_jpeg(frame(1, 1, seed=7), 95, "4:2:0"),
        "p_rgb.png": p_rgb.tobytes(),
        "p_rgba.png": p_rgba.tobytes(),
        "p_filters.png": filtered_png(rgba, [0, 1, 2, 3, 4]),
        ENCODER_INPUT: _npy(frame(48, 40, seed=12)),
    }


def _npy(a: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def fixture_hashes(files: dict) -> dict:
    """sha256.json: {"decode": {image: sha256 of cv2's decode}, "encode":
    {"input": ENCODER_INPUT, "sha256": of cv2.imencode's bytes at its
    defaults}}."""
    rgb = np.load(io.BytesIO(files[ENCODER_INPUT]))
    return {
        "decode": {name: hashlib.sha256(np.ascontiguousarray(cv2_decode(data)).tobytes()).hexdigest()
                   for name, data in files.items() if name != ENCODER_INPUT},
        "encode": {"input": ENCODER_INPUT, "sha256": hashlib.sha256(cv2_jpeg(rgb)).hexdigest()},
    }


def _committed():
    files = {}
    for name in sorted(os.listdir(FIXTURES)):
        if name != "sha256.json":
            with open(os.path.join(FIXTURES, name), "rb") as f:
                files[name] = f.read()
    with open(os.path.join(FIXTURES, "sha256.json")) as f:
        return files, json.load(f)


# ---------------------------------------------------------------- JPEG decode


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("quality", [50, 75, 90, 95, 100])
def test_jpeg_decode_matches_cv2(sampling, quality):
    for seed, noise in ((0, 24.0), (1, 90.0)):
        data = cv2_jpeg(frame(45, 67, seed, noise), quality, sampling)
        np.testing.assert_array_equal(image_io.read_jpeg(data), cv2_decode(data))


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("rst,optimize", [(1, False), (3, False), (0, True), (2, True)])
def test_jpeg_decode_restarts_and_optimized_tables(sampling, rst, optimize):
    data = cv2_jpeg(frame(45, 67, seed=2), 80, sampling, rst=rst, optimize=optimize)
    np.testing.assert_array_equal(image_io.read_jpeg(data), cv2_decode(data))


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("hw", [(1, 1), (2, 3), (5, 4), (3, 6), (45, 67), (67, 45), (17, 33), (64, 64)])
def test_jpeg_decode_odd_sizes(sampling, hw):
    data = cv2_jpeg(frame(*hw, seed=hw[0] * 100 + hw[1]), 92, sampling)
    np.testing.assert_array_equal(image_io.read_jpeg(data), cv2_decode(data))


def _random_cases(n: int, seed: int):
    """n seeded draws of (h, w, quality, sampling, rst, frame seed)."""
    rs = np.random.RandomState(seed)
    return [(int(rs.randint(1, 41)), int(rs.randint(1, 41)), int(rs.randint(50, 101)),
             list(SAMPLING)[rs.randint(len(SAMPLING))], int(rs.randint(0, 4)), int(rs.randint(2 ** 16)))
            for _ in range(n)]


@pytest.mark.parametrize("h,w,quality,sampling,rst,seed", _random_cases(25, seed=2024))
def test_jpeg_decode_matches_cv2_any(h, w, quality, sampling, rst, seed):
    data = cv2_jpeg(frame(h, w, seed, noise=60.0), quality, sampling, rst=rst)
    np.testing.assert_array_equal(image_io.read_jpeg(data), cv2_decode(data))


def test_jpeg_decode_512_frame():
    """The binarizer's frame size, at cv2.imwrite's defaults (q95, 4:2:0)."""
    data = cv2_jpeg(frame(512, 512, seed=9, noise=40.0))
    np.testing.assert_array_equal(image_io.read_jpeg(data), cv2_decode(data))


# ---------------------------------------------------------------- JPEG encode


@pytest.mark.parametrize("hw", [(1, 1), (2, 3), (8, 8), (9, 31), (15, 17), (16, 16), (17, 15), (31, 9), (33, 48),
                                (45, 67), (64, 64), (67, 45)])
def test_jpeg_encode_equals_cv2(hw):
    """The port's bytes equal cv2.imencode's at its defaults (q95, 4:2:0);
    cv2 decodes them to what the port's decoder gives."""
    for seed, noise in ((hw[0], 24.0), (hw[1] + 100, 90.0)):
        rgb = frame(*hw, seed=seed, noise=noise)
        data = image_io.jpeg_bytes(rgb)
        assert data == cv2_jpeg(rgb)
        np.testing.assert_array_equal(cv2_decode(data), image_io.read_jpeg(data))


def test_write_jpeg_reads_back(tmp_path):
    """A smooth frame survives q95 4:2:0 within a few levels."""
    y, x = np.mgrid[0:32, 0:48]
    rgb = np.stack([x * 5, y * 7, (x + y) * 3], -1).astype(np.uint8)
    path = str(tmp_path / "f.jpg")
    image_io.write_jpeg(path, rgb)
    back = image_io.read_image(path)
    assert back.shape == rgb.shape and back.dtype == np.uint8
    assert np.abs(back.astype(int) - rgb).mean() < 1.0
    with pytest.raises(ValueError, match="uint8"):
        image_io.jpeg_bytes(rgb.astype(np.float32))


# ---------------------------------------------------------------- PNG


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_png_decode_matches_cv2(channels, level):
    """cv2's PNG writer picks its row filters adaptively, so its files mix
    them."""
    cv2 = _cv2()
    img = frame(40, 52, seed=level)
    if channels == 4:
        img = np.concatenate([img, frame(40, 52, seed=level + 1)[..., :1]], -1)
    bgr = np.concatenate([img[..., 2::-1], img[..., 3:]], -1).copy()
    ok, enc = cv2.imencode(".png", bgr, [cv2.IMWRITE_PNG_COMPRESSION, level])
    assert ok
    got = image_io.read_png(enc.tobytes())
    np.testing.assert_array_equal(got, cv2_decode(enc.tobytes()))
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [4, 3, 2, 1, 0]])
@pytest.mark.parametrize("channels", [3, 4])
def test_png_filter_types(filters, channels):
    img = frame(11, 13, seed=sum(filters) + channels, noise=80.0)
    if channels == 4:
        img = np.concatenate([img, img[..., :1] ^ 0x5A], -1)
    data = filtered_png(img, filters)
    np.testing.assert_array_equal(image_io.read_png(data), img)
    np.testing.assert_array_equal(image_io.read_png(data), cv2_decode(data))


@pytest.mark.parametrize("channels", [3, 4])
def test_png_writer_round_trips(tmp_path, channels):
    img = frame(21, 34, seed=channels)
    if channels == 4:
        img = np.concatenate([img, frame(21, 34, seed=9)[..., 1:2]], -1)
    path = str(tmp_path / "f.png")
    image_io.write_png(path, img)
    np.testing.assert_array_equal(image_io.read_image(path), img)
    np.testing.assert_array_equal(cv2_decode(image_io.png_bytes(img)), img)


def test_png_rgb_bytes_unchanged():
    """The RGB writer's bytes: one IDAT of filter-0 rows at zlib level 6."""
    img = frame(5, 7, seed=1)
    rows = b"".join(b"\x00" + img[y].tobytes() for y in range(5))
    assert image_io.png_bytes(img) == png_with(rows, 7, 5)


def test_read_image_sniffs_the_signature(tmp_path):
    """A JPEG named .png and a PNG named .jpg read as what they are."""
    rgb = frame(9, 10, seed=2)
    (tmp_path / "a.png").write_bytes(image_io.jpeg_bytes(rgb))
    (tmp_path / "b.jpg").write_bytes(image_io.png_bytes(rgb))
    np.testing.assert_array_equal(image_io.read_image(str(tmp_path / "a.png")),
                                  image_io.read_jpeg(image_io.jpeg_bytes(rgb)))
    np.testing.assert_array_equal(image_io.read_image(str(tmp_path / "b.jpg")), rgb)


# ---------------------------------------------------------------- unsupported input


def _jpeg_patched(offset_of, value) -> bytes:
    data = bytearray(image_io.jpeg_bytes(frame(16, 16, seed=0)))
    data[offset_of(bytes(data))] = value
    return bytes(data)


def _sof(data: bytes) -> int:
    return data.index(b"\xff\xc0")


def _bad_dht() -> bytes:
    """The luma AC table's 162 codes all of length 1 (at most one fits):
    the code lengths overflow."""
    data = bytearray(image_io.jpeg_bytes(frame(16, 16, seed=0)))
    p = data.index(b"\xff\xc4\x00\xb5\x10") + 5  # DHT, length 181, class 1 table 0: its 16 counts
    assert sum(data[p:p + 16]) == 162
    data[p:p + 16] = bytes([162] + [0] * 15)
    return bytes(data)


UNSUPPORTED = {
    "progressive": (lambda: cv2_jpeg(frame(16, 16, 0), progressive=True), "progressive"),
    "grayscale jpeg": (lambda: bytes(_cv2().imencode(".jpg", frame(16, 16, 0)[..., 0])[1]), "grayscale"),
    "arithmetic": (lambda: _jpeg_patched(lambda d: _sof(d) + 1, 0xC9), "arithmetic"),
    "lossless": (lambda: _jpeg_patched(lambda d: _sof(d) + 1, 0xC3), "lossless"),
    "12-bit": (lambda: _jpeg_patched(lambda d: _sof(d) + 4, 12), "12-bit"),
    "cmyk": (lambda: _jpeg_patched(lambda d: _sof(d) + 9, 4), "CMYK"),
    "non-interleaved": (lambda: _jpeg_patched(lambda d: d.index(b"\xff\xda") + 4, 1), "non-interleaved"),
    "4:4:0": (lambda: _jpeg_patched(lambda d: _sof(d) + 11, 0x12), "sampling"),
    "bad DHT": (_bad_dht, "bad Huffman table"),
    "truncated jpeg": (lambda: image_io.jpeg_bytes(frame(32, 32, 0))[:-200], "truncated"),
    "truncated jpeg header": (lambda: image_io.jpeg_bytes(frame(32, 32, 0))[:100], "truncated"),
    "grayscale png": (lambda: png_with(b"\x00\x00" * 2, 1, 2, color=0), "grayscale"),
    "16-bit png": (lambda: bytes(_cv2().imencode(".png", (frame(4, 4, 0).astype(np.uint16) * 257))[1]), "16-bit"),
    "palette png": (lambda: png_with(b"\x00\x00" * 2, 1, 2, color=3, extra=_chunk(b"PLTE", b"\x00" * 3)),
                    "palette"),
    "interlaced png": (lambda: png_with(b"\x00" * 8, 1, 2, interlace=1), "interlaced"),
    "tRNS png": (lambda: png_with(b"\x00" * 8, 1, 2, extra=_chunk(b"tRNS", b"\x00" * 6)), "tRNS"),
    "bad filter png": (lambda: png_with(b"\x05" + b"\x00" * 3, 1, 1), "filter type 5"),
    "truncated png": (lambda: image_io.png_bytes(frame(16, 16, 0))[:-30], "truncated"),
    # the IDAT chunk's CRC is the 4 bytes before IEND's 12
    "bad crc": (lambda: image_io.png_bytes(frame(4, 4, 0))[:-16] + b"\x00" * 4
                + image_io.png_bytes(frame(4, 4, 0))[-12:], "bad CRC"),
    "not an image": (lambda: b"GIF89a" + b"\x00" * 20, "not a PNG or JPEG"),
}


@pytest.mark.parametrize("case", list(UNSUPPORTED))
def test_unsupported_input_raises(tmp_path, case):
    make, what = UNSUPPORTED[case]
    path = tmp_path / "x.img"
    path.write_bytes(make())
    with pytest.raises(ValueError, match=f"x.img: .*{what}"):
        image_io.read_image(str(path))


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's output;
    nothing falls back to Python."""
    bad = tmp_path / "image_codec.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(image_io, "SOURCE", bad)
    monkeypatch.setattr(image_io, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="image_codec.cpp"):
        image_io.build_codec()
    assert not list((tmp_path / "build").glob("*.so"))


# ---------------------------------------------------------------- fixtures


def test_fixtures_decode_to_recorded_hashes():
    """Without cv2: the committed files decode to the sha256 of cv2's
    decodes, and the encoder's bytes for the seeded frame to theirs."""
    files, hashes = _committed()
    assert set(hashes["decode"]) | {hashes["encode"]["input"]} == set(files)
    assert sum(map(len, files.values())) < 100_000
    for name, want in hashes["decode"].items():
        got = image_io.read_image(files[name])
        assert hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest() == want, name
    rgb = np.load(io.BytesIO(files[ENCODER_INPUT]))
    np.testing.assert_array_equal(rgb, frame(48, 40, seed=12))
    assert hashlib.sha256(image_io.jpeg_bytes(rgb)).hexdigest() == hashes["encode"]["sha256"]


def test_fixtures_regenerate_with_cv2():
    files, hashes = _committed()
    assert make_fixtures() == files
    assert fixture_hashes(files) == hashes


if __name__ == "__main__":
    os.makedirs(FIXTURES, exist_ok=True)
    made = make_fixtures()
    for fname, blob in made.items():
        with open(os.path.join(FIXTURES, fname), "wb") as f:
            f.write(blob)
    with open(os.path.join(FIXTURES, "sha256.json"), "w") as f:
        json.dump(fixture_hashes(made), f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"{len(made)} fixtures, {sum(map(len, made.values()))} bytes, in {FIXTURES}")
