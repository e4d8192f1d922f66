"""flax's checkpoint format in pure Python: msgpack with numpy leaves.

`unpackb` reads and `packb` writes the bytes of
`flax.serialization.msgpack_restore` / `msgpack_serialize`:

- msgpack maps, arrays, str, bin, ints, floats, bool and nil (maps become
  dicts, arrays lists; `packb` sorts dict keys, as flax's tree copy does,
  and takes the smallest encoding of each value, as msgpack-python does, so
  equal trees give flax's bytes);
- ext type 1, an ndarray: a msgpack array (shape, dtype name, C-order
  bytes). Arrays are read without a copy, as read-only views of the
  buffer. numpy has no `bfloat16`: such a leaf is read as uint16 and comes
  back as a `torch.bfloat16` tensor, and a `torch.bfloat16` tensor is
  written under that name;
- ext type 3, a numpy scalar (an ndarray of shape ()); ext type 2, a
  complex (real, imag);
- chunked arrays: flax writes an array of more than `MAX_CHUNK_SIZE` bytes
  held in a dict as `{'__msgpack_chunked_array__': True, 'shape': {'0':
  d0, ...}, 'chunks': {'0': flat chunk, ...}}`, and joins them back, in
  dicts only, as here.

Anything else (another ext type, a byte msgpack leaves unused, a
truncated buffer) raises.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30  # flax's: arrays above this many bytes are chunked
_CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


class MsgpackError(ValueError):
    pass


# ---------------------------------------------------------------- decoding


def _array_from_ext(data: memoryview):
    shape, dtype_name, buf = _unpack_one(data, views=True)
    shape = tuple(shape)
    if dtype_name == "bfloat16":
        u16 = np.frombuffer(buf, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(u16.view(np.int16).copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)


def _ext(code: int, data: memoryview):
    if code == EXT_NDARRAY:
        return _array_from_ext(data)
    if code == EXT_NPSCALAR:
        arr = _array_from_ext(data)
        return arr if isinstance(arr, torch.Tensor) else arr[()]
    if code == EXT_COMPLEX:
        re_, im = _unpack_one(data)
        return complex(re_, im)
    raise MsgpackError(f"msgpack ext type {code} is not one flax writes")


_FIXED = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
          0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_LEN = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xd9: ">B", 0xda: ">H", 0xdb: ">I",
        0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I", 0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}


def _unpack(buf: memoryview, pos: int, views: bool = False) -> Tuple[Any, int]:
    """(value, position after it); `bin` values are views of `buf` when
    `views`, else bytes."""
    def take(n):
        nonlocal pos
        if pos + n > len(buf):
            raise MsgpackError("truncated msgpack buffer")
        out = buf[pos:pos + n]
        pos += n
        return out

    b = take(1)[0]
    if b <= 0x7f:
        return b, pos
    if b >= 0xe0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8f or b in (0xde, 0xdf):
        n = b & 0x0f if b <= 0x8f else struct.unpack(_LEN[b], take(struct.calcsize(_LEN[b])))[0]
        out = {}
        for _ in range(n):
            k, pos = _unpack(buf, pos, views)
            out[k], pos = _unpack(buf, pos, views)
        return out, pos
    if 0x90 <= b <= 0x9f or b in (0xdc, 0xdd):
        n = b & 0x0f if b <= 0x9f else struct.unpack(_LEN[b], take(struct.calcsize(_LEN[b])))[0]
        out = []
        for _ in range(n):
            v, pos = _unpack(buf, pos, views)
            out.append(v)
        return out, pos
    if 0xa0 <= b <= 0xbf or b in (0xd9, 0xda, 0xdb):
        n = b & 0x1f if b <= 0xbf else struct.unpack(_LEN[b], take(struct.calcsize(_LEN[b])))[0]
        return str(take(n), "utf-8"), pos
    if b == 0xc0:
        return None, pos
    if b in (0xc2, 0xc3):
        return b == 0xc3, pos
    if b in (0xc4, 0xc5, 0xc6):
        n = struct.unpack(_LEN[b], take(struct.calcsize(_LEN[b])))[0]
        data = take(n)
        return (data if views else bytes(data)), pos
    if b in _FIXED:
        return struct.unpack(_FIXED[b], take(struct.calcsize(_FIXED[b])))[0], pos
    if 0xd4 <= b <= 0xd8 or b in (0xc7, 0xc8, 0xc9):
        if b >= 0xd4:
            n = 1 << (b - 0xd4)
        else:
            n = struct.unpack(_LEN[b], take(struct.calcsize(_LEN[b])))[0]
        code = struct.unpack(">b", take(1))[0]
        return _ext(code, take(n)), pos
    raise MsgpackError(f"byte 0x{b:02x} at {pos - 1} starts no msgpack value")


def _unpack_one(data, views: bool = False) -> Any:
    buf = memoryview(data)
    obj, pos = _unpack(buf, 0, views)
    if pos != len(buf):
        raise MsgpackError(f"{len(buf) - pos} bytes after the msgpack value")
    return obj


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if any(isinstance(c, torch.Tensor) for c in chunks):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_dicts(d):
    """flax's `_unchunk_array_leaves_in_place`: through dicts only."""
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            d[k] = _unchunk_dicts(v)
    return d


def unpackb(data) -> Any:
    """The tree in `data` (bytes or any buffer), as `msgpack_restore` gives
    it. numpy leaves are read-only views of `data`."""
    if len(data) == 0:
        raise MsgpackError("empty msgpack buffer")
    return _unchunk_dicts(_unpack_one(data))


# ---------------------------------------------------------------- encoding


def _pack_len(out: list, n: int, fix_base: int, fix_max: int, codes: Tuple[int, int, int]):
    if n <= fix_max and fix_base is not None:
        out.append(bytes([fix_base | n]))
    elif n < 1 << 8 and codes[0] is not None:
        out.append(bytes([codes[0], n]))
    elif n < 1 << 16:
        out.append(bytes([codes[1]]) + struct.pack(">H", n))
    elif n < 1 << 32:
        out.append(bytes([codes[2]]) + struct.pack(">I", n))
    else:
        raise MsgpackError(f"a msgpack object of {n} entries or bytes is too large")


def _pack_int(out: list, x: int):
    if 0 <= x < 0x80 or -32 <= x < 0:
        out.append(struct.pack(">b" if x < 0 else ">B", x))
    elif x >= 0:
        for code, fmt, top in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16), (0xce, ">I", 1 << 32),
                               (0xcf, ">Q", 1 << 64)):
            if x < top:
                out.append(bytes([code]) + struct.pack(fmt, x))
                return
        raise MsgpackError(f"int {x} does not fit msgpack")
    else:
        for code, fmt, low in ((0xd0, ">b", -(1 << 7)), (0xd1, ">h", -(1 << 15)), (0xd2, ">i", -(1 << 31)),
                               (0xd3, ">q", -(1 << 63))):
            if x >= low:
                out.append(bytes([code]) + struct.pack(fmt, x))
                return
        raise MsgpackError(f"int {x} does not fit msgpack")


def _pack_ext(out: list, code: int, data: bytes):
    n = len(data)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.append(bytes([fixed[n]]))
    else:
        _pack_len(out, n, None, -1, (0xc7, 0xc8, 0xc9))
    out.append(struct.pack(">b", code))
    out.append(data)


def _as_numpy(x):
    """(numpy array, dtype name) of an ndarray or a tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        x = x.numpy()
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise MsgpackError("object and structured dtypes are not serialisable")
    return x, x.dtype.name


def _ndarray_bytes(x) -> bytes:
    arr, name = _as_numpy(x)
    out: list = []
    _pack(out, [list(arr.shape), name, arr.tobytes("C")], strict=False)
    return b"".join(out)


def _pack(out: list, x, strict: bool = True):
    t = type(x)
    if x is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if x else b"\xc2")
    elif t is int:
        _pack_int(out, x)
    elif t is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif t is str:
        data = x.encode("utf-8")
        _pack_len(out, len(data), 0xa0, 31, (0xd9, 0xda, 0xdb))
        out.append(data)
    elif t in (bytes, bytearray, memoryview):
        data = memoryview(x).cast("B") if t is memoryview else x
        _pack_len(out, len(data), None, -1, (0xc4, 0xc5, 0xc6))
        out.append(data)
    elif t is list or (not strict and t is tuple):
        _pack_len(out, len(x), 0x90, 15, (None, 0xdc, 0xdd))
        for v in x:
            _pack(out, v, strict)
    elif t is dict:
        _pack_len(out, len(x), 0x80, 15, (None, 0xde, 0xdf))
        for k, v in x.items():
            _pack(out, k, strict)
            _pack(out, v, strict)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _pack_ext(out, EXT_NDARRAY, _ndarray_bytes(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)))
    elif t is complex:
        inner: list = []
        _pack(inner, [x.real, x.imag], strict=False)
        _pack_ext(out, EXT_COMPLEX, b"".join(inner))
    else:
        raise MsgpackError(f"cannot serialise a {t.__name__} to flax msgpack")


def _chunk(arr) -> dict:
    itemsize = arr.element_size() if isinstance(arr, torch.Tensor) else arr.dtype.itemsize
    step = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    n = flat.shape[0]
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(j): flat[i:i + step] for j, i in enumerate(range(0, n, step))}}


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.size * x.dtype.itemsize


def _prepare(x, chunk: bool = True):
    """What flax's `msgpack_serialize` packs: dict keys sorted, as its
    `jax.tree_util.tree_map` copy sorts them, and arrays above
    `MAX_CHUNK_SIZE` bytes chunked where `_chunk_array_leaves_in_place`
    reaches them (through dicts only)."""
    if isinstance(x, dict):
        return {k: _prepare(x[k], chunk) for k in sorted(x)}
    if isinstance(x, list):
        return [_prepare(v, False) for v in x]
    if chunk and isinstance(x, (np.ndarray, torch.Tensor)) and _nbytes(x) > MAX_CHUNK_SIZE:
        return _chunk(x)
    return x


def packb(tree) -> bytes:
    """`tree` (dicts, lists and scalars with ndarray, numpy-scalar or tensor
    leaves) as `flax.serialization.msgpack_serialize` writes it."""
    out: list = []
    _pack(out, _prepare(tree))
    return b"".join(out)
