"""Model bundles and resumable train states (counterpart of
``rankaae_tpu/utils/checkpoint.py``).

A bundle is ``<path>``, a msgpack map ``{version, params, batch_stats}`` of
the JAX package's nested pytrees (numpy leaves, see ``utils/weights.py``),
and ``<path>.json``, the manifest ``{version, config[, extra]}``.  The bytes
are those flax's ``msgpack_serialize`` writes, so a bundle written by either
package loads in the other.

This module reads and writes that format itself, without the ``msgpack``
package: the subset flax uses — maps, arrays, strings, binaries, ints,
floats, bool and nil, and its extension types 1 (an ndarray, packed as
``(shape, dtype name, C-order bytes)``) and 3 (a numpy scalar, packed the
same way).

A train state (:func:`save_train_state`) is the port's own format: one
msgpack map ``{format, state, extra}`` holding the host tree of
``RankAAETrainer.state_tree`` (module weights, moments, plateau states,
trackers, generator states) and scalar metadata such as the epoch it
belongs to, written atomically.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Tuple

import numpy as np

from rankaae_tpu_torch.utils.config import TrainConfig

BUNDLE_VERSION = 1
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


# --------------------------------------------------------------------------- #
# msgpack: the subset flax writes
# --------------------------------------------------------------------------- #

def _pack_len(out: bytearray, n: int, fix: int, fix_max: int, codes: Tuple[int, ...]) -> None:
    """A length header: ``fix | n`` below ``fix_max``, else the 8/16/32-bit
    form of ``codes`` (``codes[0]`` None where there is no 8-bit form)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n < 1 << 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    elif n < 1 << 32:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise ValueError(f"msgpack object of length {n} is too long")


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError(f"cannot pack an array of dtype {arr.dtype}")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, np.ndarray) or isinstance(obj, np.generic):
        code = _EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR
        data = _ndarray_payload(np.asarray(obj))
        n = len(data)
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixed:
            out.append(fixed[n])
        else:
            _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", code) + data
    elif isinstance(obj, int):
        if 0 <= obj < 128 or -32 <= obj < 0:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
        elif obj >= 0:
            for code, fmt, top in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16),
                                   (0xCE, ">BI", 1 << 32), (0xCF, ">BQ", 1 << 64)):
                if obj < top:
                    out += struct.pack(fmt, code, obj)
                    break
            else:
                raise ValueError(f"integer {obj} does not fit in 64 bits")
        else:
            for code, fmt, low in ((0xD0, ">Bb", -(1 << 7)), (0xD1, ">Bh", -(1 << 15)),
                                   (0xD2, ">Bi", -(1 << 31)), (0xD3, ">Bq", -(1 << 63))):
                if obj >= low:
                    out += struct.pack(fmt, code, obj)
                    break
            else:
                raise ValueError(f"integer {obj} does not fit in 64 bits")
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """msgpack bytes of ``obj`` (dict keys in insertion order)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _unpack(buf: bytes, pos: int) -> Tuple[Any, int]:
    b = buf[pos]
    pos += 1

    def take(fmt):
        return struct.unpack_from(fmt, buf, pos)[0], pos + struct.calcsize(fmt)

    def seq(n, p, pairs):
        items = []
        for _ in range(n * (2 if pairs else 1)):
            item, p = _unpack(buf, p)
            items.append(item)
        if pairs:
            return dict(zip(items[0::2], items[1::2])), p
        return items, p

    def ext(code, n, p):
        data = buf[p:p + n]
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack extension type {code}")
        shape, dtype, raw = unpackb(data)
        arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
        return (arr if code == _EXT_NDARRAY else arr[()]), p + n

    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return seq(b & 0x0F, pos, True)
    if 0x90 <= b <= 0x9F:
        return seq(b & 0x0F, pos, False)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return buf[pos:pos + n].decode("utf-8"), pos + n
    if b == 0xC0:
        return None, pos
    if b in (0xC2, 0xC3):
        return b == 0xC3, pos
    if b in (0xC4, 0xC5, 0xC6, 0xD9, 0xDA, 0xDB):
        n, pos = take({0xC4: ">B", 0xC5: ">H", 0xC6: ">I",
                       0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
        data = bytes(buf[pos:pos + n])
        return (data if b <= 0xC6 else data.decode("utf-8")), pos + n
    if b in (0xC7, 0xC8, 0xC9):
        n, pos = take({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
        code, pos = take(">b")
        return ext(code, n, pos)
    if 0xD4 <= b <= 0xD8:
        code, pos = take(">b")
        return ext(code, 1 << (b - 0xD4), pos)
    if b in (0xCA, 0xCB):
        return take(">f" if b == 0xCA else ">d")
    fmts = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in fmts:
        return take(fmts[b])
    if b in (0xDC, 0xDD, 0xDE, 0xDF):
        n, pos = take(">H" if b in (0xDC, 0xDE) else ">I")
        return seq(n, pos, b >= 0xDE)
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x} at offset {pos - 1}")


def unpackb(data: bytes) -> Any:
    """The object of msgpack bytes ``data`` (the subset flax writes)."""
    obj, end = _unpack(data, 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} trailing bytes after the msgpack object")
    return obj


# --------------------------------------------------------------------------- #
# bundles
# --------------------------------------------------------------------------- #

def save_model_bundle(path: str, params: Dict[str, Any], batch_stats: Dict[str, Any],
                      cfg: TrainConfig, extra: Dict[str, Any] | None = None) -> str:
    """Write ``<path>`` (msgpack) + ``<path>.json`` (config manifest).
    ``params``/``batch_stats`` are ``{role: nested dict of numpy arrays}``,
    as ``utils/weights.py::to_jax`` returns them."""
    payload = {"version": BUNDLE_VERSION, "params": params, "batch_stats": batch_stats}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(packb(payload))
    manifest = {"version": BUNDLE_VERSION, "config": cfg.to_dict()}
    if extra:
        manifest["extra"] = extra
    with open(path + ".json", "w") as f:
        json.dump(manifest, f, indent=1)
    return path


def load_model_bundle(path: str) -> Tuple[Dict[str, Any], Dict[str, Any], TrainConfig, Dict]:
    """Returns (params, batch_stats, cfg, extra)."""
    with open(path, "rb") as f:
        payload = unpackb(f.read())
    with open(path + ".json") as f:
        manifest = json.load(f)
    cfg = TrainConfig(**manifest["config"])
    return payload["params"], payload["batch_stats"], cfg, manifest.get("extra", {})


# --------------------------------------------------------------------------- #
# train states
# --------------------------------------------------------------------------- #

#: the train-state file's format: a map {format, state, extra}
STATE_FORMAT_VERSION = 1


def save_train_state(path: str, tree: Dict[str, Any], extra: Dict[str, Any] | None = None
                     ) -> str:
    """Write ``tree`` (``RankAAETrainer.state_tree``) and the scalar
    metadata ``extra`` (the epoch the state belongs to) into one file, via
    a temporary file and a rename, so a crash leaves the old file or the
    new one (``rankaae_tpu/utils/checkpoint.py:95``)."""
    payload = {"format": STATE_FORMAT_VERSION, "state": tree, "extra": dict(extra or {})}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(packb(payload))
    os.replace(tmp, path)
    return path


def load_train_state(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(tree, extra)`` of a file :func:`save_train_state` wrote
    (``rankaae_tpu/utils/checkpoint.py:124``); ``RankAAETrainer.
    load_state_tree`` checks the tree against the config."""
    with open(path, "rb") as f:
        payload = unpackb(f.read())
    if not isinstance(payload, dict) or payload.get("format") != STATE_FORMAT_VERSION:
        raise ValueError(f"{path} is not a train state of format {STATE_FORMAT_VERSION}")
    return payload["state"], payload["extra"]
