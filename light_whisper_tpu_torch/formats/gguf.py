"""GGUF container reader/writer.

The port's copy of ``light_whisper_tpu/formats/gguf.py``.

The reference ships Qwen3-ASR weights as Q8_0 GGUF files consumed by a C++
runtime (``transcribe-cpp``, see ``qwen3_asr_server.py:114-133`` and the model
registry ``hf_cache_utils.py:11-26``). This module implements the GGUF v3
format natively so the engine can load the very same artifacts:

- memory-mapped zero-copy reads (weights stay out of the Python heap until a
  tensor is materialized on device),
- metadata key/value parsing (the model config — layer counts, dims, RoPE
  parameters, tokenizer vocab/merges — lives in metadata),
- a writer used by tests and export tooling to build valid GGUF files,
  including Q8_0 quantization.

GGML stores dims fastest-first (``ne[0]`` = contiguous row length). Arrays are
exposed in numpy order, i.e. ``shape == tuple(reversed(ne))``; a 2-D weight
reads as ``(out_features, in_features)`` with quantization blocks running
along the last (in-feature) axis.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Dict, List, Sequence, Tuple, Union

import numpy as np

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian
GGUF_VERSION = 3
DEFAULT_ALIGNMENT = 32

# ggml tensor type ids (subset used by Qwen3-ASR Q8_0 artifacts).
GGML_F32 = 0
GGML_F16 = 1
GGML_Q4_0 = 2
GGML_Q8_0 = 8
GGML_I8 = 24
GGML_I16 = 25
GGML_I32 = 26
GGML_I64 = 27
GGML_F64 = 28
GGML_BF16 = 30

Q8_0_BLOCK = 32
Q8_0_BLOCK_BYTES = 2 + Q8_0_BLOCK  # f16 scale + 32 int8 quants
Q4_0_BLOCK = 32
Q4_0_BLOCK_BYTES = 2 + Q4_0_BLOCK // 2  # f16 scale + 16 nibble-pair bytes

_SIMPLE_TYPE_NP = {
    GGML_F32: np.dtype("<f4"),
    GGML_F16: np.dtype("<f2"),
    GGML_I8: np.dtype("i1"),
    GGML_I16: np.dtype("<i2"),
    GGML_I32: np.dtype("<i4"),
    GGML_I64: np.dtype("<i8"),
    GGML_F64: np.dtype("<f8"),
}

# metadata value type ids
_MV_U8, _MV_I8, _MV_U16, _MV_I16, _MV_U32, _MV_I32, _MV_F32, _MV_BOOL = range(8)
_MV_STRING, _MV_ARRAY, _MV_U64, _MV_I64, _MV_F64 = 8, 9, 10, 11, 12

_SCALAR_FMT = {
    _MV_U8: "<B",
    _MV_I8: "<b",
    _MV_U16: "<H",
    _MV_I16: "<h",
    _MV_U32: "<I",
    _MV_I32: "<i",
    _MV_F32: "<f",
    _MV_U64: "<Q",
    _MV_I64: "<q",
    _MV_F64: "<d",
}


# ---------------------------------------------------------------------------
# Q8_0 codec
# ---------------------------------------------------------------------------


def quantize_q8_0(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Quantize along the last axis into (int8 quants, f16 per-block scales).

    Bit-matches ggml's ``quantize_row_q8_0_ref``: ``d = absmax/127`` in
    float32, quants from the *unrounded* inverse (``id = 1/d`` before the
    f16 store — inverting the f16-rounded scale shifts quants by ±1 near
    block edges), rounding half AWAY from zero (C ``roundf``; ``np.rint``
    is ties-to-even), and a zero scale producing zero quants. Byte parity
    with llama.cpp's converter given identical float inputs is what lets
    exported artifacts be diffed against externally produced ones.
    """
    x = np.asarray(x, dtype=np.float32)
    if x.shape[-1] % Q8_0_BLOCK != 0:
        raise ValueError(f"last dim {x.shape[-1]} not divisible by {Q8_0_BLOCK}")
    blocks = x.reshape(*x.shape[:-1], x.shape[-1] // Q8_0_BLOCK, Q8_0_BLOCK)
    absmax = np.max(np.abs(blocks), axis=-1)
    d32 = (absmax / np.float32(127.0)).astype(np.float32)
    inv = np.where(d32 > 0, np.float32(1.0) / np.where(d32 > 0, d32, 1.0), 0.0)
    scaled = blocks * inv[..., None].astype(np.float32)
    q = (np.sign(scaled) * np.floor(np.abs(scaled) + np.float32(0.5))).astype(np.int8)
    return q.reshape(x.shape), d32.astype(np.float16)


def dequantize_q8_0(q: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Inverse of :func:`quantize_q8_0` (float32 output)."""
    q = np.asarray(q)
    blocks = q.reshape(*q.shape[:-1], q.shape[-1] // Q8_0_BLOCK, Q8_0_BLOCK)
    out = blocks.astype(np.float32) * np.asarray(d, dtype=np.float32)[..., None]
    return out.reshape(q.shape)


def _q8_0_to_bytes(q: np.ndarray, d: np.ndarray) -> bytes:
    """Interleave scales/quants into ggml's block_q8_0 wire layout."""
    nblocks = q.size // Q8_0_BLOCK
    out = np.empty(nblocks * Q8_0_BLOCK_BYTES, dtype=np.uint8)
    rec = out.reshape(nblocks, Q8_0_BLOCK_BYTES)
    rec[:, :2] = d.astype("<f2").reshape(-1, 1).view(np.uint8).reshape(nblocks, 2)
    rec[:, 2:] = q.reshape(nblocks, Q8_0_BLOCK).view(np.uint8)
    return out.tobytes()


def _q8_0_from_bytes(raw: np.ndarray, shape: Tuple[int, ...]) -> Tuple[np.ndarray, np.ndarray]:
    """Split block_q8_0 bytes into (int8 quants, f16 scales), both shaped."""
    n_elems = int(np.prod(shape)) if shape else 1
    nblocks = n_elems // Q8_0_BLOCK
    rec = raw[: nblocks * Q8_0_BLOCK_BYTES].reshape(nblocks, Q8_0_BLOCK_BYTES)
    d = rec[:, :2].copy().view("<f2").reshape(*shape[:-1], shape[-1] // Q8_0_BLOCK)
    q = rec[:, 2:].copy().view(np.int8).reshape(shape)
    return q, d


def _q4_0_from_bytes(raw: np.ndarray, shape: Tuple[int, ...]) -> Tuple[np.ndarray, np.ndarray]:
    """Unpack block_q4_0 into (int8 quants in [-8, 7], f16 scales).

    ggml nibble order: byte j of a block holds element j (low nibble) and
    element j+16 (high nibble). The int8 expansion lets Q4_0 artifacts flow
    through the same fused dequant-matmul path as Q8_0 (a true int4 kernel is
    future bandwidth work).
    """
    n_elems = int(np.prod(shape)) if shape else 1
    nblocks = n_elems // Q4_0_BLOCK
    rec = raw[: nblocks * Q4_0_BLOCK_BYTES].reshape(nblocks, Q4_0_BLOCK_BYTES)
    d = rec[:, :2].copy().view("<f2").reshape(*shape[:-1], shape[-1] // Q4_0_BLOCK)
    packed = rec[:, 2:]  # [nblocks, 16]
    q = np.empty((nblocks, Q4_0_BLOCK), dtype=np.int8)
    q[:, :16] = (packed & 0x0F).astype(np.int8) - 8
    q[:, 16:] = (packed >> 4).astype(np.int8) - 8
    return q.reshape(shape), d


def _q8_0_split_into(
    raw: np.ndarray, shape: Tuple[int, ...], q_out: np.ndarray, s_out: np.ndarray
) -> None:
    """Deinterleave block_q8_0 straight into caller-owned buffers.

    ``q_out`` must be a contiguous int8 array of ``shape``; ``s_out`` a
    contiguous float array (any dtype — the f16 scales cast on assignment)
    of ``(*shape[:-1], shape[-1] // 32)``. Loading a flagship artifact moves
    ~2 GB of quants; writing the split directly into its final (fused,
    layer-stacked, padded) destination removes the temp-allocate → concat →
    stack passes that dominate host prep time (loader.py load_timings).
    """
    if not (q_out.flags.c_contiguous and s_out.flags.c_contiguous):
        # reshape of a non-contiguous array copies; the writes below would
        # land in the copy and be silently lost.
        raise ValueError("split_into requires C-contiguous output buffers")
    n_elems = int(np.prod(shape)) if shape else 1
    nblocks = n_elems // Q8_0_BLOCK
    rec = raw[: nblocks * Q8_0_BLOCK_BYTES].reshape(nblocks, Q8_0_BLOCK_BYTES)
    q_out.reshape(nblocks, Q8_0_BLOCK)[...] = rec[:, 2:].view(np.int8)
    s_out.reshape(nblocks)[...] = rec[:, :2].copy().view("<f2").reshape(nblocks)


def _q4_0_split_into(
    raw: np.ndarray, shape: Tuple[int, ...], q_out: np.ndarray, s_out: np.ndarray
) -> None:
    """Q4_0 counterpart of :func:`_q8_0_split_into` (int8-expanded quants)."""
    if not (q_out.flags.c_contiguous and s_out.flags.c_contiguous):
        raise ValueError("split_into requires C-contiguous output buffers")
    n_elems = int(np.prod(shape)) if shape else 1
    nblocks = n_elems // Q4_0_BLOCK
    rec = raw[: nblocks * Q4_0_BLOCK_BYTES].reshape(nblocks, Q4_0_BLOCK_BYTES)
    packed = rec[:, 2:]  # [nblocks, 16]
    qv = q_out.reshape(nblocks, Q4_0_BLOCK)
    qv[:, :16] = (packed & 0x0F).astype(np.int8) - 8
    qv[:, 16:] = (packed >> 4).astype(np.int8) - 8
    s_out.reshape(nblocks)[...] = rec[:, :2].copy().view("<f2").reshape(nblocks)


def quantize_q4_0(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Quantize along the last axis into packed Q4_0 (writer/test support).

    Matches ggml's ``quantize_row_q4_0_ref``: the *signed* extreme of each
    block sets ``d = extreme / -8`` so that extreme maps exactly to index 0
    (value ``-8·d``); indices are ``min(15, floor(x/d + 8.5))``. The scale is
    computed in f32 and stored as f16, like ggml.
    """
    x = np.asarray(x, dtype=np.float32)
    if x.shape[-1] % Q4_0_BLOCK != 0:
        raise ValueError(f"last dim {x.shape[-1]} not divisible by {Q4_0_BLOCK}")
    blocks = x.reshape(-1, Q4_0_BLOCK)
    extreme = blocks[
        np.arange(blocks.shape[0]), np.argmax(np.abs(blocks), axis=-1)
    ]
    d32 = extreme / -8.0
    inv = np.where(d32 != 0.0, 1.0 / np.where(d32 != 0.0, d32, 1.0), 0.0)
    idx = np.minimum(15, np.floor(blocks * inv[:, None] + 8.5)).astype(np.int8)
    q = idx - np.int8(8)
    d_shaped = d32.astype(np.float16).reshape(*x.shape[:-1], x.shape[-1] // Q4_0_BLOCK)
    return q.reshape(x.shape), d_shaped


def _q4_0_to_bytes(q: np.ndarray, d: np.ndarray) -> bytes:
    nblocks = q.size // Q4_0_BLOCK
    blocks = (q.reshape(nblocks, Q4_0_BLOCK).astype(np.int16) + 8).astype(np.uint8)
    packed = (blocks[:, :16] | (blocks[:, 16:] << 4)).astype(np.uint8)
    out = np.empty(nblocks * Q4_0_BLOCK_BYTES, dtype=np.uint8)
    rec = out.reshape(nblocks, Q4_0_BLOCK_BYTES)
    rec[:, :2] = np.asarray(d, dtype="<f2").reshape(-1, 1).view(np.uint8).reshape(nblocks, 2)
    rec[:, 2:] = packed
    return out.tobytes()


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GGUFTensor:
    name: str
    shape: Tuple[int, ...]  # numpy order (reversed ggml ne)
    ggml_type: int
    data_offset: int  # absolute offset in file
    nbytes: int
    _mmap: np.memmap = dataclasses.field(repr=False, default=None)

    def raw(self) -> np.ndarray:
        """Raw byte view into the memory-mapped file (no copy)."""
        return self._mmap[self.data_offset : self.data_offset + self.nbytes]

    def array(self) -> np.ndarray:
        """Materialize as float32/original-dtype numpy array (copies)."""
        if self.ggml_type in _SIMPLE_TYPE_NP:
            dt = _SIMPLE_TYPE_NP[self.ggml_type]
            return (
                self.raw().copy().view(dt).reshape(self.shape)
            )
        if self.ggml_type == GGML_BF16:
            u16 = self.raw().copy().view("<u2").astype(np.uint32) << 16
            return u16.view(np.float32).reshape(self.shape)
        if self.ggml_type == GGML_Q8_0:
            q, d = _q8_0_from_bytes(self.raw(), self.shape)
            return dequantize_q8_0(q, d)
        if self.ggml_type == GGML_Q4_0:
            q, d = _q4_0_from_bytes(self.raw(), self.shape)
            return dequantize_q8_0(q, d)  # same q·d semantics
        raise NotImplementedError(f"ggml type {self.ggml_type}")

    def q8_0_parts(self) -> Tuple[np.ndarray, np.ndarray]:
        """Return (int8 quants, f16 scales) without dequantizing.

        This is the device loading path: int8 quants ship to device memory
        as-is and the dequant fuses into the matmul kernel (``ops.q8_matmul``). Q4_0
        tensors unpack to int8 quants with the same block-scale semantics.
        """
        if self.ggml_type == GGML_Q8_0:
            return _q8_0_from_bytes(self.raw(), self.shape)
        if self.ggml_type == GGML_Q4_0:
            return _q4_0_from_bytes(self.raw(), self.shape)
        raise ValueError(f"{self.name} is not a supported quantized type")

    def q8_0_parts_into(self, q_out: np.ndarray, s_out: np.ndarray) -> None:
        """Split quants/scales directly into caller-owned buffers.

        Same semantics as :meth:`q8_0_parts`, but the outputs land in
        ``q_out`` (int8, this tensor's shape) and ``s_out`` (float, blocks
        along the last axis) — typically views into a preallocated fused /
        layer-stacked destination, skipping the intermediate copies.
        """
        if q_out.shape != self.shape:
            raise ValueError(
                f"{self.name}: q_out shape {q_out.shape} != tensor {self.shape}"
            )
        s_shape = (*self.shape[:-1], self.shape[-1] // Q8_0_BLOCK)
        if s_out.shape != s_shape:
            # the flat reshape(nblocks) below only checks total size — a
            # transposed same-size buffer would accept scrambled scales
            raise ValueError(
                f"{self.name}: s_out shape {s_out.shape} != blocks {s_shape}"
            )
        if s_out.dtype.kind in "iub":
            # int assignment truncates scales toward zero silently
            # (bf16 registers as kind 'V', so test for the bad kinds)
            raise ValueError(f"{self.name}: s_out must be a float buffer")
        if self.ggml_type == GGML_Q8_0:
            _q8_0_split_into(self.raw(), self.shape, q_out, s_out)
        elif self.ggml_type == GGML_Q4_0:
            _q4_0_split_into(self.raw(), self.shape, q_out, s_out)
        else:
            raise ValueError(f"{self.name} is not a supported quantized type")


class GGUFFile:
    def __init__(self, path: str):
        self.path = path
        self.metadata: Dict[str, Any] = {}
        self.tensors: Dict[str, GGUFTensor] = {}
        self._mmap = np.memmap(path, dtype=np.uint8, mode="r")
        self._parse()

    # -- low-level cursor helpers ------------------------------------------

    def _parse(self) -> None:
        buf = self._mmap
        pos = 0

        def take(fmt: str):
            nonlocal pos
            size = struct.calcsize(fmt)
            vals = struct.unpack_from(fmt, buf, pos)
            pos += size
            return vals[0] if len(vals) == 1 else vals

        def take_string() -> str:
            nonlocal pos
            n = take("<Q")
            s = bytes(buf[pos : pos + n]).decode("utf-8")
            pos += n
            return s

        def take_value(vtype: int):
            nonlocal pos
            if vtype in _SCALAR_FMT:
                return take(_SCALAR_FMT[vtype])
            if vtype == _MV_BOOL:
                return bool(take("<B"))
            if vtype == _MV_STRING:
                return take_string()
            if vtype == _MV_ARRAY:
                elem_type = take("<I")
                count = take("<Q")
                if elem_type in _SCALAR_FMT and elem_type != _MV_F64:
                    fmt = _SCALAR_FMT[elem_type]
                    size = struct.calcsize(fmt)
                    arr = np.frombuffer(buf, dtype=np.dtype(fmt[1:]).newbyteorder("<"), count=count, offset=pos)
                    pos += size * count
                    return arr.tolist() if count < 1 << 20 else arr
                if elem_type == _MV_STRING:
                    # Specialized walk: the tokenizer vocab is ~152k strings
                    # and per-element take_string() (struct + numpy-slice +
                    # bytes()) costs ~14 µs each — seconds of load time on
                    # one array. A memoryview + local unpack is ~5× faster.
                    mv = memoryview(buf)
                    unpack_len = struct.Struct("<Q").unpack_from
                    out = []
                    p = pos
                    for _ in range(count):
                        (n,) = unpack_len(mv, p)
                        p += 8
                        out.append(str(mv[p : p + n], "utf-8"))
                        p += n
                    pos = p
                    return out
                return [take_value(elem_type) for _ in range(count)]
            raise ValueError(f"unknown metadata value type {vtype}")

        magic = take("<I")
        if magic != GGUF_MAGIC:
            raise ValueError(f"{self.path}: not a GGUF file")
        version = take("<I")
        if version not in (2, 3):
            raise ValueError(f"unsupported GGUF version {version}")
        tensor_count = take("<Q")
        kv_count = take("<Q")

        for _ in range(kv_count):
            key = take_string()
            vtype = take("<I")
            self.metadata[key] = take_value(vtype)

        alignment = int(self.metadata.get("general.alignment", DEFAULT_ALIGNMENT))

        infos: List[Tuple[str, Tuple[int, ...], int, int]] = []
        for _ in range(tensor_count):
            name = take_string()
            n_dims = take("<I")
            ne = [take("<Q") for _ in range(n_dims)]
            ggml_type = take("<I")
            offset = take("<Q")
            infos.append((name, tuple(reversed(ne)), ggml_type, offset))

        data_start = (pos + alignment - 1) // alignment * alignment
        for name, shape, ggml_type, offset in infos:
            nbytes = tensor_nbytes(shape, ggml_type)
            self.tensors[name] = GGUFTensor(
                name=name,
                shape=shape,
                ggml_type=ggml_type,
                data_offset=data_start + offset,
                nbytes=nbytes,
                _mmap=self._mmap,
            )

    def close(self) -> None:
        # memmap closes when garbage collected; keep explicit hook for parity
        # with the reference runtime's close() semantics.
        self._mmap = None
        for t in self.tensors.values():
            t._mmap = None


def tensor_nbytes(shape: Sequence[int], ggml_type: int) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    if ggml_type in _SIMPLE_TYPE_NP:
        return n * _SIMPLE_TYPE_NP[ggml_type].itemsize
    if ggml_type == GGML_BF16:
        return n * 2
    if ggml_type == GGML_Q8_0:
        if shape and shape[-1] % Q8_0_BLOCK != 0:
            raise ValueError("Q8_0 tensor last dim must be a multiple of 32")
        return n // Q8_0_BLOCK * Q8_0_BLOCK_BYTES
    if ggml_type == GGML_Q4_0:
        if shape and shape[-1] % Q4_0_BLOCK != 0:
            raise ValueError("Q4_0 tensor last dim must be a multiple of 32")
        return n // Q4_0_BLOCK * Q4_0_BLOCK_BYTES
    raise NotImplementedError(f"ggml type {ggml_type}")


def read_gguf(path: str) -> GGUFFile:
    return GGUFFile(path)


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def _encode_value(value: Any) -> bytes:
    """Encode a Python value as (type_id, payload) with inferred type."""
    out = bytearray()
    if isinstance(value, bool):
        out += struct.pack("<I", _MV_BOOL) + struct.pack("<B", int(value))
    elif isinstance(value, int):
        if -(1 << 31) <= value < (1 << 31):
            out += struct.pack("<I", _MV_I32) + struct.pack("<i", value)
        else:
            out += struct.pack("<I", _MV_I64) + struct.pack("<q", value)
    elif isinstance(value, float):
        # f64 keeps config round trips exact (f32 would corrupt epsilons).
        out += struct.pack("<I", _MV_F64) + struct.pack("<d", value)
    elif isinstance(value, str):
        raw = value.encode("utf-8")
        out += struct.pack("<I", _MV_STRING) + struct.pack("<Q", len(raw)) + raw
    elif isinstance(value, (list, tuple, np.ndarray)):
        items = list(value)
        out += struct.pack("<I", _MV_ARRAY)
        if all(isinstance(v, str) for v in items):
            out += struct.pack("<I", _MV_STRING) + struct.pack("<Q", len(items))
            for v in items:
                raw = v.encode("utf-8")
                out += struct.pack("<Q", len(raw)) + raw
        elif all(isinstance(v, bool) for v in items):
            out += struct.pack("<I", _MV_BOOL) + struct.pack("<Q", len(items))
            out += bytes(int(v) for v in items)
        elif all(isinstance(v, (int, np.integer)) for v in items):
            out += struct.pack("<I", _MV_I32) + struct.pack("<Q", len(items))
            for v in items:
                out += struct.pack("<i", int(v))
        elif all(isinstance(v, (int, float, np.floating, np.integer)) for v in items):
            out += struct.pack("<I", _MV_F32) + struct.pack("<Q", len(items))
            for v in items:
                out += struct.pack("<f", float(v))
        else:
            raise TypeError(f"cannot encode heterogeneous array: {items[:4]}")
    else:
        raise TypeError(f"cannot encode metadata value of type {type(value)}")
    return bytes(out)


def write_gguf(
    path: str,
    metadata: Dict[str, Any],
    tensors: Dict[str, Union[np.ndarray, Tuple[np.ndarray, int]]],
    alignment: int = DEFAULT_ALIGNMENT,
) -> None:
    """Write a GGUF v3 file.

    ``tensors`` maps name → array or (array, ggml_type). f32/f16 arrays pass
    through; requesting ``GGML_Q8_0`` quantizes a float array on the fly.
    """
    entries = []  # (name, ne, ggml_type, payload_bytes)
    for name, spec in tensors.items():
        if isinstance(spec, tuple):
            arr, ggml_type = spec
        else:
            arr = spec
            ggml_type = {
                np.dtype(np.float32): GGML_F32,
                np.dtype(np.float16): GGML_F16,
                np.dtype(np.int8): GGML_I8,
                np.dtype(np.int32): GGML_I32,
                np.dtype(np.int64): GGML_I64,
            }[np.dtype(arr.dtype)]
        arr = np.asarray(arr)
        if ggml_type == GGML_Q8_0:
            q, d = quantize_q8_0(arr.astype(np.float32))
            payload = _q8_0_to_bytes(q, d)
        elif ggml_type == GGML_Q4_0:
            q, d = quantize_q4_0(arr.astype(np.float32))
            payload = _q4_0_to_bytes(q, d)
        elif ggml_type == GGML_F16:
            payload = arr.astype("<f2").tobytes()
        elif ggml_type == GGML_F32:
            payload = arr.astype("<f4").tobytes()
        elif ggml_type == GGML_BF16:
            # Round-to-nearest-EVEN like ggml_compute_fp32_to_bf16 (plain
            # +0x8000 is round-half-up); NaNs force the quiet bit.
            u32 = arr.astype(np.float32).view(np.uint32)
            rounded = (u32 + 0x7FFF + ((u32 >> 16) & 1)) >> 16
            is_nan = (u32 & 0x7FFFFFFF) > 0x7F800000
            payload = (
                np.where(is_nan, (u32 >> 16) | 0x0040, rounded)
                .astype("<u2")
                .tobytes()
            )
        elif ggml_type in _SIMPLE_TYPE_NP:
            payload = arr.astype(_SIMPLE_TYPE_NP[ggml_type]).tobytes()
        else:
            raise NotImplementedError(f"writer: ggml type {ggml_type}")
        ne = tuple(reversed(arr.shape))
        entries.append((name, ne, ggml_type, payload))

    meta = dict(metadata)
    meta.setdefault("general.alignment", alignment)

    head = bytearray()
    head += struct.pack("<IIQQ", GGUF_MAGIC, GGUF_VERSION, len(entries), len(meta))
    for key, value in meta.items():
        raw = key.encode("utf-8")
        head += struct.pack("<Q", len(raw)) + raw
        if key == "general.alignment":
            head += struct.pack("<I", _MV_U32) + struct.pack("<I", int(value))
        else:
            head += _encode_value(value)

    # tensor infos with running aligned offsets
    offsets = []
    cursor = 0
    for _name, _ne, _t, payload in entries:
        offsets.append(cursor)
        cursor += len(payload)
        cursor = (cursor + alignment - 1) // alignment * alignment

    for (name, ne, ggml_type, _payload), off in zip(entries, offsets):
        raw = name.encode("utf-8")
        head += struct.pack("<Q", len(raw)) + raw
        head += struct.pack("<I", len(ne))
        for d in ne:
            head += struct.pack("<Q", d)
        head += struct.pack("<IQ", ggml_type, off)

    with open(path, "wb") as f:
        f.write(head)
        data_start = (len(head) + alignment - 1) // alignment * alignment
        f.write(b"\x00" * (data_start - len(head)))
        cursor = 0
        for (_n, _ne, _t, payload), off in zip(entries, offsets):
            f.write(b"\x00" * (off - cursor))
            f.write(payload)
            cursor = off + len(payload)
