"""Pure-Python TF1 checkpoint (tensor-bundle) reader/writer + scope mapper.

The port's own copy of ``facet_graph_convolution_tpu/evaluation/
tf_checkpoint.py``: the same reader, writer and ``crc32c`` in pure Python,
with the mapped parameters as float32 tensors on a ``device`` (default
``cuda``) in the layout of :func:`facet_graph_convolution_torch.params.
params_from_jax`.

The reference trains with ``tf.train.Saver`` (train.py:528-534,551-552),
which writes the TensorFlow *tensor bundle* format:

- ``<prefix>.index`` — a LevelDB-style SSTable mapping "" → BundleHeaderProto
  and each variable name → BundleEntryProto (dtype, shape, shard, offset,
  size, crc32c);
- ``<prefix>.data-NNNNN-of-MMMMM`` — raw little-endian tensor bytes.

TensorFlow is not a dependency, so both sides are implemented here from
the on-disk format (LevelDB ``table_format.md`` +
``tensorflow/core/util/tensor_bundle``): :func:`read_tf_checkpoint` /
:func:`write_tf_checkpoint` round-trip the format, and
:func:`load_reference_unet` maps the reference's variable scopes
(model.py:853-941: ``Level{0,1,2}[_1]/Conv[_1]/{weight,bias,assignment,
assignment_1,assignment_2}``, ``.../MLP[_1]/{weight,bias}``) onto this
port's U-Net parameters — enabling executed activation-level parity via
``evaluation.parity`` and reference-side restores of weights the port
trained via :func:`export_unet_to_tf`.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from facet_graph_convolution_torch.config import resolve_device

# ---------------------------------------------------------------------------
# crc32c (Castagnoli) + TF masking
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78
        table = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes, crc: int = 0) -> int:
    table = _crc_table()
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TF's rotated+offset mask (crc32c.h) applied to the raw crc."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# varints + minimal protobuf codec
# ---------------------------------------------------------------------------

def _put_varint(buf: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def _get_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _pb_fields(data: bytes):
    """Yield (field_number, wire_type, value) for a serialized message.
    value is int for varint/fixed, bytes for length-delimited."""
    pos = 0
    while pos < len(data):
        tag, pos = _get_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _get_varint(data, pos)
        elif wire == 1:
            val = struct.unpack_from("<Q", data, pos)[0]
            pos += 8
        elif wire == 2:
            ln, pos = _get_varint(data, pos)
            val = data[pos : pos + ln]
            pos += ln
        elif wire == 5:
            val = struct.unpack_from("<I", data, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _pb_varint_field(field: int, value: int) -> bytes:
    buf = bytearray()
    _put_varint(buf, (field << 3) | 0)
    _put_varint(buf, value)
    return bytes(buf)


def _pb_bytes_field(field: int, value: bytes) -> bytes:
    buf = bytearray()
    _put_varint(buf, (field << 3) | 2)
    _put_varint(buf, len(value))
    return bytes(buf) + value


def _pb_fixed32_field(field: int, value: int) -> bytes:
    buf = bytearray()
    _put_varint(buf, (field << 3) | 5)
    return bytes(buf) + struct.pack("<I", value)


# TF DataType enum ↔ numpy (tensorflow/core/framework/types.proto)
_DTYPES = {
    1: np.dtype("float32"), 2: np.dtype("float64"), 3: np.dtype("int32"),
    4: np.dtype("uint8"), 5: np.dtype("int16"), 6: np.dtype("int8"),
    9: np.dtype("int64"), 10: np.dtype("bool"), 17: np.dtype("uint16"),
    19: np.dtype("float16"), 22: np.dtype("uint32"), 23: np.dtype("uint64"),
}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}


def _decode_entry(data: bytes) -> dict:
    """BundleEntryProto → dict(dtype, shape, shard_id, offset, size, crc)."""
    out = {"dtype": 1, "shape": [], "shard_id": 0, "offset": 0, "size": 0,
           "crc": 0}
    for field, wire, val in _pb_fields(data):
        if field == 1:
            out["dtype"] = val
        elif field == 2:                          # TensorShapeProto
            dims = []
            for f2, w2, v2 in _pb_fields(val):
                if f2 == 2:                       # repeated Dim
                    for f3, w3, v3 in _pb_fields(v2):
                        if f3 == 1:
                            dims.append(v3)
            out["shape"] = dims
        elif field == 3:
            out["shard_id"] = val
        elif field == 4:
            out["offset"] = val
        elif field == 5:
            out["size"] = val
        elif field == 6:
            out["crc"] = val
    return out


def _encode_entry(dtype_code: int, shape: Sequence[int], shard_id: int,
                  offset: int, size: int, crc: int) -> bytes:
    shape_pb = b"".join(
        _pb_bytes_field(2, _pb_varint_field(1, int(d))) for d in shape
    )
    out = _pb_varint_field(1, dtype_code)
    out += _pb_bytes_field(2, shape_pb)
    if shard_id:
        out += _pb_varint_field(3, shard_id)
    if offset:
        out += _pb_varint_field(4, offset)
    out += _pb_varint_field(5, size)
    out += _pb_fixed32_field(6, crc)
    return out


def _decode_header(data: bytes) -> dict:
    out = {"num_shards": 1}
    for field, wire, val in _pb_fields(data):
        if field == 1:
            out["num_shards"] = val
    return out


def _encode_header(num_shards: int = 1) -> bytes:
    # BundleHeaderProto: num_shards + VersionDef{producer=1}
    return _pb_varint_field(1, num_shards) + _pb_bytes_field(
        3, _pb_varint_field(1, 1)
    )


# ---------------------------------------------------------------------------
# LevelDB SSTable (the .index file container)
# ---------------------------------------------------------------------------

_TABLE_MAGIC = 0xDB4775248B80FB57


def _parse_block(content: bytes) -> List[Tuple[bytes, bytes]]:
    """Decode one uncompressed block's (key, value) entries, honouring
    prefix compression and the trailing restart array."""
    if len(content) < 4:
        return []
    (num_restarts,) = struct.unpack_from("<I", content, len(content) - 4)
    data_end = len(content) - 4 - 4 * num_restarts
    entries = []
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = _get_varint(content, pos)
        non_shared, pos = _get_varint(content, pos)
        value_len, pos = _get_varint(content, pos)
        key = key[:shared] + content[pos : pos + non_shared]
        pos += non_shared
        value = content[pos : pos + value_len]
        pos += value_len
        entries.append((key, value))
    return entries


def _read_block(f, offset: int, size: int) -> bytes:
    f.seek(offset)
    raw = f.read(size + 5)
    content, ctype = raw[:size], raw[size]
    if ctype != 0:
        raise ValueError(
            f"compressed table block (type {ctype}) unsupported — the TF "
            "bundle writer emits uncompressed blocks"
        )
    return content


def read_sstable(path: str) -> Dict[bytes, bytes]:
    """All (key, value) pairs of a LevelDB-format table file."""
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        file_size = f.tell()
        f.seek(file_size - 48)
        footer = f.read(48)
        magic = struct.unpack_from("<Q", footer, 40)[0]
        if magic != _TABLE_MAGIC:
            raise ValueError(f"{path}: not an SSTable (bad magic)")
        pos = 0
        _mi_off, pos = _get_varint(footer, pos)
        _mi_size, pos = _get_varint(footer, pos)
        idx_off, pos = _get_varint(footer, pos)
        idx_size, pos = _get_varint(footer, pos)
        out: Dict[bytes, bytes] = {}
        for _k, handle in _parse_block(_read_block(f, idx_off, idx_size)):
            hpos = 0
            b_off, hpos = _get_varint(handle, hpos)
            b_size, hpos = _get_varint(handle, hpos)
            for key, value in _parse_block(_read_block(f, b_off, b_size)):
                out[key] = value
        return out


def _emit_block(out: bytearray, entries: List[Tuple[bytes, bytes]]) -> Tuple[int, int]:
    """Append one uncompressed block (every entry a restart point); returns
    its BlockHandle (offset, size)."""
    offset = len(out)
    restarts = []
    for key, value in entries:
        restarts.append(len(out) - offset)
        _put_varint(out, 0)                      # shared
        _put_varint(out, len(key))               # non_shared
        _put_varint(out, len(value))
        out.extend(key)
        out.extend(value)
    if not restarts:
        restarts = [0]                           # LevelDB blocks always carry
    for r in restarts:                           # at least one restart point
        out.extend(struct.pack("<I", r))
    out.extend(struct.pack("<I", len(restarts)))
    size = len(out) - offset
    content = bytes(out[offset:])
    out.append(0)                                # compression type: none
    out.extend(struct.pack("<I", masked_crc32c(content + b"\x00")))
    return offset, size


def write_sstable(path: str, pairs: Dict[bytes, bytes]) -> None:
    """Write a single-data-block LevelDB table (sorted keys, no compression,
    valid crcs) — readable by TF's table reader."""
    entries = sorted(pairs.items())
    out = bytearray()
    data_handle = _emit_block(out, entries)
    meta_handle = _emit_block(out, [])
    last_key = entries[-1][0] if entries else b""
    hbuf = bytearray()
    _put_varint(hbuf, data_handle[0])
    _put_varint(hbuf, data_handle[1])
    index_handle = _emit_block(out, [(last_key + b"\x00", bytes(hbuf))])
    footer = bytearray()
    _put_varint(footer, meta_handle[0])
    _put_varint(footer, meta_handle[1])
    _put_varint(footer, index_handle[0])
    _put_varint(footer, index_handle[1])
    footer.extend(b"\x00" * (40 - len(footer)))
    footer.extend(struct.pack("<Q", _TABLE_MAGIC))
    out.extend(footer)
    with open(path, "wb") as f:
        f.write(bytes(out))


# ---------------------------------------------------------------------------
# Tensor bundle
# ---------------------------------------------------------------------------

def read_tf_checkpoint(prefix: str) -> Dict[str, np.ndarray]:
    """Read every tensor of a TF1 Saver-V2 checkpoint (``prefix.index`` +
    ``prefix.data-*``) into a name → array dict, without TensorFlow."""
    table = read_sstable(prefix + ".index")
    header = _decode_header(table.get(b"", b""))
    num_shards = max(int(header["num_shards"]), 1)
    shard_files = [
        prefix + f".data-{s:05d}-of-{num_shards:05d}" for s in range(num_shards)
    ]
    out: Dict[str, np.ndarray] = {}
    handles = {}
    try:
        for key, value in sorted(table.items()):
            if key == b"":
                continue
            entry = _decode_entry(value)
            if entry["dtype"] not in _DTYPES:
                raise ValueError(
                    f"{key.decode()}: unsupported dtype code {entry['dtype']}"
                )
            shard = entry["shard_id"]
            if shard not in handles:
                handles[shard] = open(shard_files[shard], "rb")
            f = handles[shard]
            f.seek(entry["offset"])
            raw = f.read(entry["size"])
            arr = np.frombuffer(raw, dtype=_DTYPES[entry["dtype"]])
            out[key.decode()] = arr.reshape(entry["shape"]).copy()
    finally:
        for f in handles.values():
            f.close()
    return out


def write_tf_checkpoint(prefix: str, tensors: Dict[str, np.ndarray]) -> None:
    """Write a TF1 Saver-V2-format checkpoint (single data shard) readable
    by ``tf.train.Saver``/``tf.train.load_checkpoint`` AND by
    :func:`read_tf_checkpoint`."""
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    data_path = prefix + ".data-00000-of-00001"
    pairs: Dict[bytes, bytes] = {b"": _encode_header(1)}
    offset = 0
    with open(data_path, "wb") as f:
        for name in sorted(tensors):
            arr = np.ascontiguousarray(tensors[name])
            if arr.dtype not in _DTYPE_CODES:
                raise ValueError(f"{name}: unsupported dtype {arr.dtype}")
            raw = arr.tobytes()
            f.write(raw)
            pairs[name.encode()] = _encode_entry(
                _DTYPE_CODES[arr.dtype], arr.shape, 0, offset, len(raw),
                masked_crc32c(raw),
            )
            offset += len(raw)
    write_sstable(prefix + ".index", pairs)


# ---------------------------------------------------------------------------
# Reference scope mapping (model.py:853-941)
# ---------------------------------------------------------------------------

# our param name → candidate TF scope prefixes, in graph-construction order.
# Re-entering tf.variable_scope('LevelN') uniquifies the NAME scope to
# 'LevelN_1' (tf.Variable names live in name scopes); the 'LevelN/Conv_k'
# fallbacks cover graphs built with auxiliary_name_scope=False.
_CONV_SCOPES = {
    "conv1": ("Level0/Conv",),
    "conv2": ("Level1/Conv",),
    "conv3": ("Level2/Conv",),
    "dconv3": ("Level2/Conv_1",),
    "upconv2": ("Level1_1/Conv", "Level1/Conv_2"),
    "dconv2": ("Level1_1/Conv_1", "Level1/Conv_3"),
    "upconv1": ("Level0_1/Conv", "Level0/Conv_2"),
    "dconv1": ("Level0_1/Conv_1", "Level0/Conv_3"),
}
_LIN_SCOPES = {
    "fc_coarse": ("Level2/MLP",),
    "out2": ("Level2/MLP_1",),
    "fc_mid": ("Level1_1/MLP", "Level1/MLP"),
    "out1": ("Level1_1/MLP_1", "Level1/MLP_1"),
    "fc1": ("Level0_1/MLP", "Level0/MLP"),
    "out0": ("Level0_1/MLP_1", "Level0/MLP_1"),
}
# non-multiScale graphs create no Level2/Level1 MLPs, so the fine head keeps
# the same names (construction order differs but scopes don't collide)
_CONV_VARS = {"w": "weight", "b": "bias", "u": "assignment",
              "c": "assignment_1", "v": "assignment_2"}
_LIN_VARS = {"w": "weight", "b": "bias"}


def _resolve_scope(tensors: Dict[str, np.ndarray], candidates, probe: str):
    for scope in candidates:
        if f"{scope}/{probe}" in tensors:
            return scope
    return None


def load_reference_unet(prefix: str, device: str = "cuda") -> Tuple[Dict, bool]:
    """Map a reference checkpoint onto the port's U-Net parameters.

    Returns ``(params, multi_scale)``, the tensors float32 on ``device``.
    Raises KeyError with the missing variable name when the checkpoint
    doesn't match the reference architecture. Weight layouts transfer 1:1:
    W [M, out, in], u/v [M, in], c [M], b [out], lin W [in, out]
    (model.py:427-443,763-769 — the port's layouts, :mod:`..params`)."""
    return map_reference_tensors(read_tf_checkpoint(prefix), device)


def map_reference_tensors(tensors: Dict[str, np.ndarray],
                          device: str = "cuda") -> Tuple[Dict, bool]:
    """Scope-map an already-loaded name → array dict (see
    :func:`load_reference_unet`); raises without a card unless ``device``
    is ``cpu``."""
    dev = resolve_device(device)

    def take(scope: str, names: Dict[str, str]) -> Dict[str, torch.Tensor]:
        return {ours: torch.tensor(np.asarray(tensors[f"{scope}/{theirs}"], np.float32),
                                   device=dev)
                for ours, theirs in names.items()}

    params: Dict[str, Dict] = {}
    for name, candidates in _CONV_SCOPES.items():
        scope = _resolve_scope(tensors, candidates, "weight")
        if scope is None:
            raise KeyError(
                f"{name}: none of {candidates} found in checkpoint "
                f"(keys: {sorted(tensors)[:8]}...)"
            )
        params[name] = take(scope, _CONV_VARS)
    multi_scale = _resolve_scope(tensors, _LIN_SCOPES["fc_coarse"], "weight") is not None
    for name, candidates in _LIN_SCOPES.items():
        if not multi_scale and name not in ("fc1", "out0"):
            continue
        scope = _resolve_scope(tensors, candidates, "weight")
        if scope is None:
            raise KeyError(f"{name}: none of {candidates} found in checkpoint")
        params[name] = take(scope, _LIN_VARS)
    return params, multi_scale


def export_unet_to_tf(prefix: str, params: Dict) -> None:
    """Inverse mapping: write the port's U-Net parameters (tensors on any
    device) as a reference-named TF1 checkpoint, so the reference's
    ``tf.train.Saver`` can restore weights the port trained
    (train.py:528-534)."""
    tensors: Dict[str, np.ndarray] = {}
    for scopes, names in ((_CONV_SCOPES, _CONV_VARS), (_LIN_SCOPES, _LIN_VARS)):
        for name, candidates in scopes.items():
            if name not in params:
                continue
            for ours, theirs in names.items():
                tensors[f"{candidates[0]}/{theirs}"] = (
                    params[name][ours].detach().cpu().numpy().astype(np.float32))
    write_tf_checkpoint(prefix, tensors)
