"""The port's wire codec against the reference's, byte for byte.

Twins of ``tests/test_net_codec.py`` on ``repro_torch.net.codec``, and
the cross-package pins: a frame either package encodes is the other's
bitwise (fp32 and bf16, over a tree of dicts, lists, tuples, ``None``,
scalars and int32/int64/bool/float32/float64 leaves), each package
decodes the other's frames, every refusal case of the reference's tests
raises the same exception class from both decoders, and the bf16 cast
(torch's round-to-nearest-even, without ``ml_dtypes``) writes the
reference's bits on the edge cases: ties, signed zeros, infinities,
NaNs with payloads, subnormals and the largest finite values.
"""
import json
import os
import struct

import ml_dtypes
import numpy as np
import pytest
import torch

import repro.net.codec as jcodec
from repro_torch.net import (WIRE_VERSION, WireError, WireFormatError,
                             WireVersionError, decode_message,
                             encode_message)
from repro_torch.net import codec
from repro_torch.net.codec import MAGIC, delta_nbytes

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                                "1"))))

_BF16 = np.dtype(ml_dtypes.bfloat16)
_PREFIX = struct.Struct(">4sBI")


def _frame(header: dict, payload: bytes = b"", *,
           magic: bytes = MAGIC, version: int = WIRE_VERSION) -> bytes:
    """Hand-build a frame, bypassing encode_message's validation; the
    decoder must refuse these on its own."""
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    return _PREFIX.pack(magic, version, len(raw)) + raw + payload


def _tree():
    rng = np.random.default_rng(7)
    return {"beta": rng.normal(size=(4, 8)).astype(np.float32),
            "enc": ({"w": rng.normal(size=(8, 3)).astype(np.float32),
                     "b": np.zeros((3,), np.float32)},
                    {"w": rng.normal(size=(3, 3)).astype(np.float32)}),
            "steps": np.arange(5, dtype=np.int32),
            "mask": np.array([True, False, True]),
            "extras": [np.float32(1.5), None, "tag", 3, False]}


def _rich_tree():
    """Every container and leaf kind the codec carries."""
    rng = np.random.default_rng(11)
    return {"z": {"w": rng.normal(size=(5, 3)).astype(np.float32),
                  "b": rng.normal(size=(3,))},               # float64
            "a": [rng.integers(-9, 9, (4,)).astype(np.int32),
                  rng.integers(-2**40, 2**40, (2, 2)).astype(np.int64),
                  (np.array([True, False]), None)],
            "m": (np.float32(-0.0), 2.5, 7, True, "s", None),
            "e": np.zeros((0, 4), np.float32),
            "u": np.arange(6, dtype=np.uint8).reshape(2, 3),
            "i8": np.array([-128, 127], np.int8)}


def _bf16_edges() -> np.ndarray:
    """float32 bit patterns at the edges of the bfloat16 cast."""
    bits = [0x00000000, 0x80000000,                  # +-0
            0x7F800000, 0xFF800000,                  # +-inf
            0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001, 0x7FA00000,
            0x7F812345, 0xFFFFFFFF, 0x7FFFFFFF, 0x7FBFFFFF,  # NaNs
            0x00000001, 0x80000001, 0x00008000, 0x00018000, 0x00008001,
            0x007FFFFF, 0x00800000,                  # subnormals, min
            0x3F808000, 0x3F818000, 0x3F808001, 0x3F807FFF,  # ties
            0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000, 0x7F7F7FFF,
            0x7F7F8001]                              # largest finite
    rng = np.random.default_rng(0)
    rand = rng.integers(0, 2**32, 200_000, dtype=np.uint64)
    return np.concatenate([np.array(bits, np.uint64), rand]) \
        .astype(np.uint32).view(np.float32)


def _same(a, b):
    """Bitwise equality of two decoded trees, container types included."""
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert a == b


# ---------------------------------------------------------------------------
# cross-package: the same bytes, both directions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_frames_are_the_references_bytes(precision):
    meta = {"client": 2, "base_version": 5, "weight": 40.0}
    tree = _rich_tree()
    mine = encode_message("upload", meta, tree=tree, precision=precision)
    theirs = jcodec.encode_message("upload", meta, tree=tree,
                                   precision=precision)
    assert mine == theirs
    a, b = decode_message(theirs), jcodec.decode_message(mine)
    assert a["kind"] == b["kind"] == "upload" and a["meta"] == b["meta"]
    _same(a["tree"], b["tree"])
    assert isinstance(a["tree"]["m"], tuple)
    assert isinstance(a["tree"]["a"][2], tuple)


def test_bf16_cast_is_the_references_bitwise():
    """Ties round to even, signed zeros and infinities keep their sign,
    subnormals and the largest finite values round as ml_dtypes rounds
    them.  On a NaN torch writes 0xffff and ml_dtypes a quiet NaN with
    the input's sign (0x7fc0 / 0xffc0); the codec writes the latter."""
    f = _bf16_edges()
    with np.errstate(invalid="ignore"):
        want = f.astype(_BF16).view(np.uint16)
    got = codec._to_bf16_bits(f)
    nan = np.isnan(f)
    assert nan.sum() >= 9
    np.testing.assert_array_equal(got, want)
    assert set(want[nan].tolist()) == {0x7FC0, 0xFFC0}
    # through whole frames, and a 0-d leaf keeps its shape
    tree = {"x": f.reshape(-1, 1), "s": np.float32(3.14159)}
    with np.errstate(invalid="ignore"):
        theirs = jcodec.encode_message("upload", {}, tree=tree,
                                       precision="bf16")
    assert encode_message("upload", {}, tree=tree,
                          precision="bf16") == theirs
    # decode: every one of the 65536 bfloat16 patterns upcasts exactly
    every = np.arange(65536, dtype=np.uint32).astype(np.uint16)
    np.testing.assert_array_equal(
        codec._from_bf16_bits(every).view(np.uint32),
        every.view(_BF16).astype(np.float32).view(np.uint32))


# every refusal case of tests/test_net_codec.py
_MALFORMED = [
    (b"", "truncated frame"),
    (b"RPFN\x01", "truncated frame"),
    (b"XXXX" + encode_message("s", {})[4:], "bad magic"),
    (_PREFIX.pack(MAGIC, WIRE_VERSION, 500) + b"{}", "truncated header"),
    (_frame({"kind": "s", "meta": {}, "tree": None, "arrays": [],
             "extra": 1}), "exactly kind/meta/tree/arrays"),
    (_frame({"kind": "s", "meta": {}, "tree": None}),
     "exactly kind/meta/tree/arrays"),
    (_frame({"kind": 7, "meta": {}, "tree": None, "arrays": []}),
     "kind must be a string"),
    (_frame({"kind": "s", "meta": [], "tree": None, "arrays": []}),
     "meta an object"),
    (_frame({"kind": "s", "meta": {}, "tree": None, "arrays": {}}),
     "manifest must be a list"),
    (_PREFIX.pack(MAGIC, WIRE_VERSION, 4) + b"@@@@", "not JSON"),
]
_STRICT = [
    ({"kind": "u", "meta": {}, "tree": {"a": 0},
      "arrays": [{"dtype": "float16", "shape": [2]}]},
     b"\x00" * 4, "malformed manifest"),
    ({"kind": "u", "meta": {}, "tree": {"a": 0},
      "arrays": [{"dtype": "float32", "shape": [1], "x": 1}]},
     b"\x00" * 4, "malformed manifest"),
    ({"kind": "u", "meta": {}, "tree": {"a": 0},
      "arrays": [{"dtype": "float32", "shape": [-1]}]},
     b"", "malformed manifest"),
    ({"kind": "u", "meta": {}, "tree": {"a": 0},
      "arrays": [{"dtype": "float32", "shape": [4]}]},
     b"\x00" * 8, "payload truncated"),
    ({"kind": "u", "meta": {}, "tree": {"a": 0},
      "arrays": [{"dtype": "float32", "shape": [1]}]},
     b"\x00" * 8, "trailing payload"),
    ({"kind": "u", "meta": {}, "tree": {"a": 3},
      "arrays": [{"dtype": "float32", "shape": [1]}]},
     b"\x00" * 4, "out of range"),
    ({"kind": "u", "meta": {}, "tree": {"t": [{"a": 0}, {"a": 0}]},
      "arrays": [{"dtype": "float32", "shape": [1]}]},
     b"\x00" * 4, "referenced twice"),
    ({"kind": "u", "meta": {}, "tree": None,
      "arrays": [{"dtype": "float32", "shape": [1]}]},
     b"\x00" * 4, "never uses"),
    ({"kind": "u", "meta": {}, "tree": {"q": 0}, "arrays": []},
     b"", "unknown skeleton tag"),
    ({"kind": "u", "meta": {}, "tree": {"s": [1, 2]}, "arrays": []},
     b"", "malformed scalar"),
    ({"kind": "u", "meta": {}, "tree": {"a": 0, "s": 1}, "arrays": []},
     b"", "malformed skeleton node"),
    # a bfloat16 payload shorter than its manifest (2 bytes an entry)
    ({"kind": "u", "meta": {}, "tree": {"a": 0},
      "arrays": [{"dtype": "bfloat16", "shape": [3]}]},
     b"\x00" * 4, "payload truncated"),
]


def _refusal(decode, buf):
    with pytest.raises(Exception) as info:
        decode(buf)
    return info.value


@pytest.mark.parametrize("buf, match", _MALFORMED)
def test_malformed_frames_refused_as_the_reference(buf, match):
    mine = _refusal(decode_message, buf)
    theirs = _refusal(jcodec.decode_message, buf)
    assert isinstance(mine, WireFormatError), mine
    assert type(mine).__name__ == type(theirs).__name__
    assert match in str(mine) and str(mine) == str(theirs)


@pytest.mark.parametrize("header, payload, match", _STRICT)
def test_strict_decode_refusals_as_the_reference(header, payload, match):
    buf = _frame(header, payload)
    mine = _refusal(decode_message, buf)
    theirs = _refusal(jcodec.decode_message, buf)
    assert isinstance(mine, WireFormatError), mine
    assert type(mine).__name__ == type(theirs).__name__
    assert match in str(mine) and str(mine) == str(theirs)


def test_wrong_wire_version_is_its_own_refusal():
    good = encode_message("upload", {}, tree=np.zeros(2, np.float32))
    bumped = good[:4] + bytes([99]) + good[5:]
    with pytest.raises(WireVersionError, match="wire version 99"):
        decode_message(bumped)
    with pytest.raises(jcodec.WireVersionError, match="wire version 99"):
        jcodec.decode_message(bumped)
    assert issubclass(WireVersionError, WireError)
    assert not issubclass(WireVersionError, WireFormatError)
    assert issubclass(WireError, ValueError)


def test_encode_refusals():
    with pytest.raises(ValueError, match="wire precision"):
        encode_message("upload", {}, tree=None, precision="fp8")
    with pytest.raises(WireFormatError, match="string dict keys"):
        encode_message("upload", {}, tree={1: np.zeros(2, np.float32)})
    with pytest.raises(WireFormatError, match="not wire-encodable"):
        encode_message("upload", {}, tree=np.zeros(2, np.complex64))
    with pytest.raises(WireFormatError, match="not wire-encodable"):
        encode_message("upload", {}, tree=np.zeros(2, np.float16))


# ---------------------------------------------------------------------------
# the reference's single-package pins, on the port
# ---------------------------------------------------------------------------
def test_roundtrip_preserves_containers_values_and_dtypes():
    tree = _tree()
    msg = decode_message(encode_message(
        "upload", {"client": 2, "base_version": 5, "weight": 40.0},
        tree=tree))
    assert msg["kind"] == "upload"
    assert msg["meta"] == {"client": 2, "base_version": 5, "weight": 40.0}
    out = msg["tree"]
    assert isinstance(out["enc"], tuple) and isinstance(out["extras"], list)
    assert out["extras"][1] is None and out["extras"][2] == "tag"
    assert out["extras"][3] == 3 and out["extras"][4] is False
    np.testing.assert_array_equal(out["beta"], tree["beta"])
    np.testing.assert_array_equal(out["steps"], tree["steps"])
    np.testing.assert_array_equal(out["mask"], tree["mask"])
    assert out["beta"].dtype == np.float32
    assert out["steps"].dtype == np.int32 and out["mask"].dtype == np.bool_


def test_treeless_empty_and_float64_messages():
    msg = decode_message(encode_message("status", {"q": 1}))
    assert msg == {"kind": "status", "meta": {"q": 1}, "tree": None}
    out = decode_message(encode_message(
        "upload", {}, tree={"e": np.zeros((0, 4), np.float32)}))["tree"]
    assert out["e"].shape == (0, 4)
    out = decode_message(encode_message(
        "upload", {}, tree=np.array([1.0, 2.0], np.float64)))["tree"]
    assert out.dtype == np.float32


def test_bf16_matches_the_precision_transform_and_halves_the_payload():
    g = np.random.default_rng(3).normal(size=(16, 16)).astype(np.float32)
    out = decode_message(encode_message(
        "upload", {}, tree={"g": g, "n": np.arange(4, dtype=np.int32)},
        precision="bf16"))["tree"]
    np.testing.assert_array_equal(out["g"],
                                  g.astype(_BF16).astype(np.float32))
    assert out["g"].dtype == np.float32
    np.testing.assert_array_equal(out["n"], np.arange(4, dtype=np.int32))
    assert out["n"].dtype == np.int32
    tree = {"g": np.zeros((8, 8), np.float32),
            "n": np.zeros((4,), np.int32)}
    assert delta_nbytes(tree, precision="fp32") == 8 * 8 * 4 + 4 * 4
    assert delta_nbytes(tree, precision="bf16") == 8 * 8 * 2 + 4 * 4
    assert delta_nbytes(tree) == jcodec.delta_nbytes(tree)
