"""Checkpoints of nested dicts of tensors, in the JAX package's file format.

The port of ``training/checkpoint.py``: one file holding {treedef string,
flat arrays}, msgpack-packed and compressed behind a 4-byte magic
(``NLZS`` zstd when ``zstandard`` imports, ``NLZL`` zlib level 6 when it
does not).  Files are interchangeable with the reference's in both
directions.  The port depends on neither ``msgpack`` nor ``zstandard``
(``zstandard`` is optional, as in the reference): this module carries its
own msgpack codec for the payload's subset (maps with str keys, str,
bin, arrays, non-negative ints): it writes the bytes
``msgpack.packb(payload, use_bin_type=True)`` writes, and reads what
msgpack writes.  Its zlib stream is deflated in 16 MiB pieces on threads
and stitched into one stream (each piece but the last ends in a sync
flush): qwen3-0.6b's 1.19 GB of random bf16 params deflate in 135 s on
one core of an H100 host and in 19 s on its 8 (``tools/ckpt_deflate_time.py``).
A payload of one piece gives the bytes of ``zlib.compress(packed, 6)``.

Leaves are flattened in sorted-key order, as JAX flattens a dict, and the
treedef is the string JAX prints for the tree (``PyTreeDef({'a': {'w':
*}, 'b': *})``).  Arrays are {"dtype": numpy dtype str, "shape", "data"};
bf16 is written as ``"bfloat16"`` over its uint16 bits.  ``restore``
checks the structure against a template and raises ``ValueError`` on a
mismatch.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..device import DeviceLike
from .tree import tree_leaves, tree_unflatten

try:
    import zstandard
except ImportError:  # optional: without it, files are zlib
    zstandard = None

_MAGIC_ZSTD = b"NLZS"
_MAGIC_ZLIB = b"NLZL"
_ZLIB_LEVEL = 6
_ZLIB_PIECE = 1 << 24


# ------------------------------------------------------------ msgpack subset
def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for dicts with str keys,
    lists and tuples, str, bytes and non-negative ints."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


def _pack_len(n: int, fix: int, fix_max: int, codes: Tuple[int, ...],
              out: List[bytes]) -> None:
    """A length header: the fix form up to ``fix_max``, then the 8- (if
    ``codes`` has three), 16- and 32-bit forms."""
    if n <= fix_max:
        out.append(bytes([fix | n]))
        return
    widths = ((0xFF, ">B"), (0xFFFF, ">H"), (0xFFFFFFFF, ">I"))[-len(codes):]
    for code, (limit, fmt) in zip(codes, widths):
        if n <= limit:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f"length {n} exceeds msgpack's 32 bits")


def _pack(obj: Any, out: List[bytes]) -> None:
    if isinstance(obj, bool) or obj is None:
        raise TypeError(f"{obj!r} is outside the checkpoint payload")
    if isinstance(obj, int):
        if obj < 0:
            raise TypeError("negative ints are outside the checkpoint payload")
        if obj <= 0x7F:
            out.append(bytes([obj]))
        elif obj <= 0xFF:
            out.append(b"\xcc" + struct.pack(">B", obj))
        elif obj <= 0xFFFF:
            out.append(b"\xcd" + struct.pack(">H", obj))
        elif obj <= 0xFFFFFFFF:
            out.append(b"\xce" + struct.pack(">I", obj))
        else:
            out.append(b"\xcf" + struct.pack(">Q", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray)):
        if len(obj) <= 0xFF:
            out.append(b"\xc4" + struct.pack(">B", len(obj)))
        elif len(obj) <= 0xFFFF:
            out.append(b"\xc5" + struct.pack(">H", len(obj)))
        else:
            out.append(b"\xc6" + struct.pack(">I", len(obj)))
        out.append(bytes(obj))
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (0xDC, 0xDD), out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (0xDE, 0xDF), out)
        for key, value in obj.items():
            if not isinstance(key, str):
                raise TypeError(f"map key {key!r} is not a str")
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"{type(obj).__name__} is outside the checkpoint "
                        f"payload")


def unpackb(data: bytes) -> Any:
    """``msgpack.unpackb(data, raw=False)`` for what :func:`packb` writes
    and msgpack's other encodings of the same values (any int width)."""
    obj, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} trailing bytes after the payload")
    return obj


_INT = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
        0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LEN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",          # bin
        0xD9: ">B", 0xDA: ">H", 0xDB: ">I",          # str
        0xDC: ">H", 0xDD: ">I",                      # array
        0xDE: ">H", 0xDF: ">I"}                      # map


def _unpack(buf: memoryview, i: int) -> Tuple[Any, int]:
    if i >= len(buf):
        raise ValueError("truncated msgpack payload")
    code = buf[i]
    i += 1
    if code <= 0x7F:
        return code, i
    if code >= 0xE0:
        return code - 0x100, i
    if 0x80 <= code <= 0x9F:
        kind, n = ("map" if code < 0x90 else "array"), code & 0x0F
    elif 0xA0 <= code <= 0xBF:
        kind, n = "str", code & 0x1F
    elif code in _INT:
        fmt = _INT[code]
        size = struct.calcsize(fmt)
        return struct.unpack_from(fmt, buf, i)[0], i + size
    elif code in _LEN:
        fmt = _LEN[code]
        n = struct.unpack_from(fmt, buf, i)[0]
        i += struct.calcsize(fmt)
        kind = ("bin" if code <= 0xC6 else "str" if code <= 0xDB
                else "array" if code <= 0xDD else "map")
    else:
        raise ValueError(f"msgpack type 0x{code:02x} is outside the "
                         f"checkpoint payload")
    if kind in ("str", "bin"):
        if i + n > len(buf):
            raise ValueError("truncated msgpack payload")
        raw = bytes(buf[i:i + n])
        return (raw.decode("utf-8") if kind == "str" else raw), i + n
    if kind == "array":
        items = []
        for _ in range(n):
            item, i = _unpack(buf, i)
            items.append(item)
        return items, i
    out = {}
    for _ in range(n):
        key, i = _unpack(buf, i)
        out[key], i = _unpack(buf, i)
    return out, i


# ----------------------------------------------------------------- framing
def _zlib(data: bytes) -> bytes:
    """One zlib stream at level 6, its pieces deflated in parallel (zlib
    lets go of the interpreter lock while it deflates)."""
    view = memoryview(data)
    pieces = [view[i:i + _ZLIB_PIECE]
              for i in range(0, len(data), _ZLIB_PIECE)] or [view]

    def deflate(i: int) -> bytes:
        c = zlib.compressobj(_ZLIB_LEVEL, zlib.DEFLATED, -15)
        last = i == len(pieces) - 1
        return c.compress(pieces[i]) + c.flush(
            zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH)

    workers = min(len(pieces), os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        body = b"".join(ex.map(deflate, range(len(pieces))))
    # the header of a level-6 stream with a 32 KiB window, the adler32 of
    # the whole payload after the deflate data
    return b"\x78\x9c" + body + struct.pack(">I", zlib.adler32(data))


def _compress(packed: bytes) -> bytes:
    if zstandard is not None:
        return _MAGIC_ZSTD + zstandard.ZstdCompressor(level=3).compress(packed)
    return _MAGIC_ZLIB + _zlib(packed)


def _decompress(comp: bytes) -> bytes:
    magic, body = comp[:4], comp[4:]
    if magic == _MAGIC_ZSTD:
        if zstandard is None:
            raise RuntimeError(
                "checkpoint was written with zstd but zstandard is not "
                "installed; install it or re-save with the zlib codec")
        return zstandard.ZstdDecompressor().decompress(body)
    if magic == _MAGIC_ZLIB:
        return zlib.decompress(body)
    # legacy frame (pre-magic): raw zstd stream
    if zstandard is not None:
        return zstandard.ZstdDecompressor().decompress(comp)
    raise RuntimeError("unrecognized checkpoint framing (legacy zstd file "
                       "without zstandard installed?)")


# ------------------------------------------------------------------ arrays
def treedef_str(tree: Any) -> str:
    """The string ``str(jax.tree_util.tree_structure(tree))`` gives for a
    nested dict: keys sorted, each leaf a ``*``."""
    def fmt(node: Any) -> str:
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {fmt(node[k])}"
                                   for k in sorted(node)) + "}"
        return "*"
    return f"PyTreeDef({fmt(tree)})"


def _encode_array(x: torch.Tensor) -> Dict[str, Any]:
    t = x.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        return {"dtype": "bfloat16", "shape": list(t.shape),
                "data": t.view(torch.int16).numpy().tobytes()}
    arr = t.numpy()
    return {"dtype": arr.dtype.str, "shape": list(arr.shape),
            "data": arr.tobytes()}


def _decode_array(d: Dict[str, Any]) -> torch.Tensor:
    shape = tuple(d["shape"])
    if d["dtype"] == "bfloat16":
        raw = np.frombuffer(d["data"], np.int16).reshape(shape)
        return torch.from_numpy(raw.copy()).view(torch.bfloat16)
    arr = np.frombuffer(d["data"], np.dtype(d["dtype"])).reshape(shape)
    return torch.from_numpy(arr.copy())


def save(path: str, tree: Any) -> int:
    """Returns bytes written."""
    leaves = tree_leaves(tree)
    payload = {
        "treedef": treedef_str(tree),
        "n_leaves": len(leaves),
        "leaves": [_encode_array(x) for x in leaves],
    }
    comp = _compress(packb(payload))
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(comp)
    os.replace(tmp, path)   # atomic
    return len(comp)


def restore(path: str, template: Any, device: DeviceLike = None) -> Any:
    """The tree saved at ``path``, checked against ``template`` (a nested
    dict whose leaves have a ``shape``).  Each leaf keeps the file's type
    and goes to ``device``, or else to its template leaf's device."""
    with open(path, "rb") as f:
        comp = f.read()
    payload = unpackb(_decompress(comp))
    leaves = tree_leaves(template)
    if payload["n_leaves"] != len(leaves):
        raise ValueError(
            f"checkpoint has {payload['n_leaves']} leaves; template expects "
            f"{len(leaves)} — structure mismatch")
    if payload["treedef"] != treedef_str(template):
        raise ValueError("checkpoint treedef differs from template treedef")
    out: List[torch.Tensor] = []
    for tpl, enc in zip(leaves, payload["leaves"]):
        arr = _decode_array(enc)
        if tuple(arr.shape) != tuple(tpl.shape):
            raise ValueError(f"leaf shape {tuple(arr.shape)} != template "
                             f"{tuple(tpl.shape)}")
        dev = device if device is not None else getattr(tpl, "device", "cpu")
        out.append(arr.to(dev))
    return tree_unflatten(template, out)


def exists(path: str) -> bool:
    return os.path.exists(path)
