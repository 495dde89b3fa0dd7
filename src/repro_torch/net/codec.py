"""Versioned binary wire codec for the federation transport.

Port of ``repro/net/codec.py``; a frame either package encodes is the
other's byte for byte.  One message = one frame::

    MAGIC(4) | wire_version(1, u8) | header_len(4, u32 BE) | header JSON | arrays

The header is UTF-8 JSON with exactly four keys: ``kind`` (message
type), ``meta`` (small JSON metadata: client id, base_version, weight,
model version), ``tree`` (the skeleton of the tree, arrays replaced by
indices) and ``arrays`` (the manifest: each array's wire dtype and
shape, the payloads concatenated in order after the header).  The
skeleton keeps container types: a tuple decodes as a tuple, a list as a
list, and dict keys keep their order.

The codec works on host numpy arrays; callers move tensors to and from
the device.  Precision: ``encode_message(..., precision="bf16")`` casts
floating payloads to bfloat16 on the wire, and the decoder upcasts them
back to float32, the ``precision`` transform's rule (cast down, then
straight back up).  numpy has no bfloat16, so the cast goes through
torch's round-to-nearest-even, whose bits are the reference's
(``ml_dtypes``) for every non-NaN float32; a NaN leaves torch as
``0xffff`` and the reference as the quiet NaN ``0x7fc0`` with the input's
sign, which :func:`_to_bf16_bits` writes.  Integer and bool leaves always
travel unchanged.

Decoding is strict and total: anything that does not parse raises
:class:`WireFormatError` (service ledger reason ``malformed``); a
parseable frame from another protocol generation raises
:class:`WireVersionError` (reason ``wire_version``).  Unknown header
keys, unknown dtypes, out-of-range array indices, unused or reused
payload arrays and length mismatches are all refusals, because a
silently mis-decoded delta would corrupt the global model.
"""
from __future__ import annotations

import json
import struct
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.api.spec import WIRE_PRECISIONS
from repro_torch.checkpoint.checkpoint import to_tree, tree_get

MAGIC = b"RPFN"
WIRE_VERSION = 1

_HEADER_KEYS = frozenset({"kind", "meta", "tree", "arrays"})
# wire dtypes the decoder materializes; anything else is a refusal
_WIRE_DTYPES = ("float32", "float64", "bfloat16", "int32", "int64",
                "uint8", "int8", "bool")
_PREFIX = struct.Struct(">4sBI")
# the reference's bfloat16 for a float32 NaN: a quiet NaN, sign kept
_BF16_QNAN = np.uint16(0x7FC0)


class WireError(ValueError):
    """Base class for wire refusals."""


class WireFormatError(WireError):
    """Frame does not parse / violates the codec contract (-> ``malformed``)."""


class WireVersionError(WireError):
    """Frame is from a different wire generation (-> ``wire_version``)."""


def _to_bf16_bits(arr: np.ndarray) -> np.ndarray:
    """float32 -> the bfloat16 bit patterns (uint16), rounded to nearest
    even, NaN as the reference writes it."""
    f32 = np.array(arr, np.float32)          # a C-contiguous copy
    bits = torch.from_numpy(f32).to(torch.bfloat16) \
        .view(torch.int16).numpy().view(np.uint16)
    nan = np.isnan(f32)
    if nan.any():
        sign = (f32.view(np.uint32) >> 16).astype(np.uint16) \
            & np.uint16(0x8000)
        bits = np.where(nan, sign | _BF16_QNAN, bits)
    return bits


def _from_bf16_bits(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint16) -> float32, exactly (the upper half
    of the float32 word); a 0-d input stays an array."""
    word = bits.astype(np.uint32)
    word <<= 16
    return word.view(np.float32)


def _encode_node(node: Any, manifest: List[Dict[str, Any]],
                 payloads: List[bytes], precision: str) -> Any:
    """Map a tree node to its skeleton form, appending array payloads."""
    if node is None:
        return {"z": 0}
    if isinstance(node, dict):
        for k in node:
            if not isinstance(k, str):
                raise WireFormatError(
                    f"wire trees require string dict keys, got {type(k).__name__}")
        return {"d": {k: _encode_node(v, manifest, payloads, precision)
                      for k, v in node.items()}}
    if isinstance(node, tuple):
        return {"t": [_encode_node(v, manifest, payloads, precision) for v in node]}
    if isinstance(node, list):
        return {"l": [_encode_node(v, manifest, payloads, precision) for v in node]}
    if isinstance(node, (bool, int, float, str)):
        return {"s": node}
    arr = np.asarray(node)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    name = arr.dtype.name
    if precision == "bf16" and np.issubdtype(arr.dtype, np.floating):
        arr, name = _to_bf16_bits(arr), "bfloat16"
    if name not in _WIRE_DTYPES:
        raise WireFormatError(f"dtype {name} is not wire-encodable")
    manifest.append({"dtype": name, "shape": [int(s) for s in arr.shape]})
    payloads.append(np.ascontiguousarray(arr).tobytes())
    return {"a": len(manifest) - 1}


def encode_message(kind: str, meta: Dict[str, Any], tree: Any = None, *,
                   precision: str = "fp32") -> bytes:
    """Serialize one message. ``tree`` may be None for array-free messages."""
    if precision not in WIRE_PRECISIONS:
        raise ValueError(f"wire precision must be one of {WIRE_PRECISIONS}, "
                         f"got {precision!r}")
    manifest: List[Dict[str, Any]] = []
    payloads: List[bytes] = []
    skeleton = (None if tree is None
                else _encode_node(tree, manifest, payloads, precision))
    header = json.dumps({"kind": str(kind), "meta": meta, "tree": skeleton,
                         "arrays": manifest}, separators=(",", ":")).encode("utf-8")
    return b"".join([_PREFIX.pack(MAGIC, WIRE_VERSION, len(header)), header,
                     *payloads])


def _decode_node(node: Any, arrays: List[np.ndarray], used: List[bool]) -> Any:
    if not isinstance(node, dict) or len(node) != 1:
        raise WireFormatError(f"malformed skeleton node: {node!r}")
    tag, val = next(iter(node.items()))
    if tag == "z":
        return None
    if tag == "s":
        if not isinstance(val, (bool, int, float, str)):
            raise WireFormatError(f"malformed scalar node: {val!r}")
        return val
    if tag == "d":
        if not isinstance(val, dict):
            raise WireFormatError("dict node payload must be an object")
        return {k: _decode_node(v, arrays, used) for k, v in val.items()}
    if tag in ("t", "l"):
        if not isinstance(val, list):
            raise WireFormatError(f"{tag!r} node payload must be a list")
        items = [_decode_node(v, arrays, used) for v in val]
        return tuple(items) if tag == "t" else items
    if tag == "a":
        if not isinstance(val, int) or isinstance(val, bool) \
                or not 0 <= val < len(arrays):
            raise WireFormatError(f"array index {val!r} out of range")
        if used[val]:
            raise WireFormatError(f"array {val} referenced twice")
        used[val] = True
        return arrays[val]
    raise WireFormatError(f"unknown skeleton tag {tag!r}")


def decode_message(buf: bytes) -> Dict[str, Any]:
    """Parse one frame -> ``{"kind", "meta", "tree"}`` (tree leaves are
    numpy arrays; bfloat16 payloads come back upcast to float32)."""
    if not isinstance(buf, (bytes, bytearray, memoryview)):
        raise WireFormatError("wire frame must be bytes")
    buf = bytes(buf)
    if len(buf) < _PREFIX.size:
        raise WireFormatError(f"truncated frame: {len(buf)} bytes")
    magic, version, header_len = _PREFIX.unpack_from(buf)
    if magic != MAGIC:
        raise WireFormatError(f"bad magic {magic!r}")
    if version != WIRE_VERSION:
        raise WireVersionError(
            f"wire version {version} (this build speaks {WIRE_VERSION})")
    if len(buf) < _PREFIX.size + header_len:
        raise WireFormatError("truncated header")
    try:
        header = json.loads(buf[_PREFIX.size:_PREFIX.size + header_len]
                            .decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireFormatError(f"header is not JSON: {e}") from e
    if not isinstance(header, dict) or set(header) != _HEADER_KEYS:
        raise WireFormatError("header must carry exactly kind/meta/tree/arrays")
    kind, meta = header["kind"], header["meta"]
    if not isinstance(kind, str) or not isinstance(meta, dict):
        raise WireFormatError("kind must be a string and meta an object")
    manifest = header["arrays"]
    if not isinstance(manifest, list):
        raise WireFormatError("arrays manifest must be a list")

    payload = buf[_PREFIX.size + header_len:]
    arrays: List[np.ndarray] = []
    offset = 0
    for i, entry in enumerate(manifest):
        if (not isinstance(entry, dict) or set(entry) != {"dtype", "shape"}
                or entry["dtype"] not in _WIRE_DTYPES
                or not isinstance(entry["shape"], list)
                or not all(isinstance(s, int) and not isinstance(s, bool)
                           and s >= 0 for s in entry["shape"])):
            raise WireFormatError(f"malformed manifest entry {i}: {entry!r}")
        bf16 = entry["dtype"] == "bfloat16"
        dtype = np.dtype(np.uint16 if bf16 else entry["dtype"])
        shape = tuple(entry["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        nbytes = count * dtype.itemsize
        if offset + nbytes > len(payload):
            raise WireFormatError(f"payload truncated at array {i}")
        arr = np.frombuffer(payload, dtype=dtype, count=count,
                            offset=offset).reshape(shape)
        if bf16:
            arr = _from_bf16_bits(arr)
        arrays.append(arr)
        offset += nbytes
    if offset != len(payload):
        raise WireFormatError(
            f"{len(payload) - offset} trailing payload bytes")

    skeleton = header["tree"]
    used = [False] * len(arrays)
    tree = None if skeleton is None else _decode_node(skeleton, arrays, used)
    if not all(used):
        raise WireFormatError("manifest carries arrays the tree never uses")
    return {"kind": kind, "meta": meta, "tree": tree}


def delta_nbytes(tree: Any, *, precision: str = "fp32") -> int:
    """Wire payload size of a tree's arrays (header excluded), the
    bytes on the wire of one upload."""
    total = 0
    for leaf in _iter_arrays(tree):
        arr = np.asarray(leaf)
        itemsize = 2 if (precision == "bf16"
                         and np.issubdtype(arr.dtype, np.floating)) \
            else np.dtype(np.float32).itemsize if arr.dtype == np.float64 \
            else arr.dtype.itemsize
        total += arr.size * itemsize
    return total


def _iter_arrays(node: Any):
    if node is None or isinstance(node, (bool, int, float, str)):
        return
    if isinstance(node, dict):
        for v in node.values():
            yield from _iter_arrays(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _iter_arrays(v)
    else:
        yield node


def sorted_tree(node: Any) -> Any:
    """``node`` with every dict's keys in sorted order, the order in
    which ``jax.tree_util`` rebuilds a dict: the skeleton the reference
    puts on the wire for a parameter tree."""
    if isinstance(node, dict):
        return {k: sorted_tree(node[k]) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return type(node)(sorted_tree(v) for v in node)
    return node


# ---------------------------------------------------------------------------
# the engine's flat parameter dict <-> the reference's wire tree
# ---------------------------------------------------------------------------
def params_to_wire(engine, params) -> Any:
    """An engine-form dict (parameters or a delta, tensors on any
    device) as the host tree the reference puts on the wire: its nested
    dicts and lists, keys sorted, every leaf a numpy array."""
    return sorted_tree(engine._export(params))


def _check_skeleton(node: Any, ref: Any, path: str) -> None:
    where = path or "the root"
    if isinstance(ref, dict):
        if not isinstance(node, dict) or set(node) != set(ref):
            got = sorted(node) if isinstance(node, dict) \
                else type(node).__name__
            raise ValueError(f"delta tree at {where}: expected the keys "
                             f"{sorted(ref)}, got {got}")
        for k, v in ref.items():
            _check_skeleton(node[k], v, f"{path}/{k}")
    elif isinstance(ref, list):
        if not isinstance(node, list) or len(node) != len(ref):
            raise ValueError(f"delta tree at {where}: expected a list of "
                             f"{len(ref)}, got {type(node).__name__}")
        for i, (n, r) in enumerate(zip(node, ref)):
            _check_skeleton(n, r, f"{path}/{i}")
    elif not isinstance(node, np.ndarray):
        raise ValueError(f"delta tree at {where}: expected an array, got "
                         f"{type(node).__name__}")


def params_from_wire(tree: Any, like: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """A decoded wire tree as an engine-form dict shaped like ``like``
    (the live parameters): each leaf float32 on its live tensor's
    device.  A tree that is not the parameters' skeleton (a leaf missing,
    extra or renamed, a tuple for a list) or a leaf that does not
    broadcast to its parameter's shape raises ``ValueError``, where the
    reference's buffer insert refuses it."""
    _check_skeleton(tree, to_tree(like), "")
    out = {}
    for name, ref in like.items():
        leaf = np.broadcast_to(tree_get(tree, name).astype(np.float32),
                               tuple(ref.shape))
        out[name] = torch.from_numpy(np.array(leaf)).to(ref.device,
                                                        ref.dtype)
    return out
