"""Batch codec (paper §3.4 'Batch Codec Operations'): serialize + compress
whole KV-cache tensor blocks before they enter the tensor log.

Codecs:
  raw      — numpy bytes, no compression
  zlib     — lossless deflate over the raw bytes
  int8     — per-channel symmetric int8 quantization (the 50–75 % storage
             reduction the paper cites) + optional zlib over the packed ints
The int8 path mirrors ``repro.kernels.kv_codec`` (the Pallas device-side
kernel); this module is the host-side reference used by the storage engine
and is bit-identical to the kernel's oracle.

Payload layout (self-describing: decode never needs an external tag, so a
payload can travel from disk over the wire and be decoded anywhere)::

    u8 codec | u8 zlibbed | u16 ndim | u32 dims... | u8 dtype_code |
    [int8: f32 scales over last axis] | body

Malformed payloads (unknown codec/dtype codes, truncated headers or
bodies, corrupt deflate streams) raise ``CodecError`` — a ``ValueError``
subclass so existing record-level error handling (the cluster protocol's
decode guards) keeps catching it, but typed so callers can distinguish
codec corruption from programming errors.

``transcode`` is the tier-demotion primitive (see ``core.tiering``): it
re-encodes a payload to a target codec without a decode round-trip when
only the zlib layer differs — int8 → int8+zlib is bit-stable, never
re-quantized.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np


class CodecError(ValueError):
    """A payload that cannot be decoded: unknown codec/dtype code,
    truncated header or body, or a corrupt compressed stream."""


CODEC_RAW = 0
CODEC_INT8 = 1
_CODECS = (CODEC_RAW, CODEC_INT8)

# bfloat16 is not a stock numpy dtype: ``np.dtype("bfloat16")`` only works
# once ml_dtypes (shipped with jax) has registered it.  Probe by
# construction — a plain ``hasattr(np, "bfloat16")`` is False even when the
# dtype *is* registered, so it can't tell the two worlds apart.
try:  # ml_dtypes provides bfloat16 for numpy under jax
    import ml_dtypes

    _BFLOAT16: Optional[np.dtype] = np.dtype(ml_dtypes.bfloat16)
except Exception:  # pragma: no cover — ml_dtypes ships with jax here
    try:
        _BFLOAT16 = np.dtype("bfloat16")
    except TypeError:
        _BFLOAT16 = None

HAVE_BFLOAT16 = _BFLOAT16 is not None

_DTYPES = {
    0: np.dtype("float32"),
    1: np.dtype("float16"),
    2: _BFLOAT16,  # None when unavailable: decode raises CodecError
    3: np.dtype("int8"),
}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items() if v is not None}

_HDR = struct.Struct("<BBH")
_U32 = struct.Struct("<I")
# sanity bound on ndim: a corrupt u16 of 65535 would otherwise demand a
# 256 KiB dims header before any other check could fire
_MAX_NDIM = 16


def quantize_int8(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel (last axis) symmetric int8 quantization."""
    xf = x.astype(np.float32)
    absmax = np.max(np.abs(xf), axis=tuple(range(xf.ndim - 1)), keepdims=True)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(xf / scale), -127, 127).astype(np.int8)
    return q, scale.reshape(-1)


def dequantize_int8(q: np.ndarray, scale: np.ndarray, dtype) -> np.ndarray:
    return (q.astype(np.float32) * scale.reshape((1,) * (q.ndim - 1) + (-1,))).astype(dtype)


def header_info(raw) -> Tuple[int, bool, Tuple[int, ...], int]:
    """Parse just the payload header: ``(codec, zlibbed, shape, dtype_code)``.
    Cheap (no body decode) — the tier recoder uses it to decide whether a
    record is already at its target encoding.  Raises ``CodecError`` on a
    malformed header."""
    mv = memoryview(raw)
    if len(mv) < _HDR.size:
        raise CodecError(f"payload truncated: {len(mv)} bytes, header needs {_HDR.size}")
    codec, zl, ndim = _HDR.unpack_from(mv)
    if codec not in _CODECS:
        raise CodecError(f"unknown codec code {codec}")
    if zl not in (0, 1):
        raise CodecError(f"bad zlib flag {zl}")
    if ndim == 0 or ndim > _MAX_NDIM:
        raise CodecError(f"bad ndim {ndim} (must be 1..{_MAX_NDIM})")
    need = _HDR.size + 4 * ndim + 1
    if len(mv) < need:
        raise CodecError(f"payload truncated: {len(mv)} bytes, dims header needs {need}")
    shape = struct.unpack_from(f"<{ndim}I", mv, _HDR.size)
    (dt_code,) = struct.unpack_from("<B", mv, _HDR.size + 4 * ndim)
    if dt_code not in _DTYPES:
        raise CodecError(f"unknown dtype code {dt_code}")
    return codec, bool(zl), shape, dt_code


def _dtype_for(dt_code: int) -> np.dtype:
    dtype = _DTYPES[dt_code]
    if dtype is None:
        raise CodecError(
            "payload encoded as bfloat16 but this host has no bfloat16 "
            "dtype (ml_dtypes is not importable)"
        )
    return dtype


def _split(raw) -> Tuple[int, bool, Tuple[int, ...], int, "memoryview"]:
    """Header fields + a view of the (possibly compressed) body."""
    codec, zl, shape, dt_code = header_info(raw)
    pos = _HDR.size + 4 * len(shape) + 1
    return codec, zl, shape, dt_code, memoryview(raw)[pos:]


class BatchCodec:
    def __init__(self, codec: int = CODEC_INT8, use_zlib: bool = True, zlib_level: int = 1):
        if codec not in _CODECS:
            raise CodecError(f"unknown codec code {codec}")
        self.codec = codec
        self.use_zlib = bool(use_zlib)
        self.zlib_level = zlib_level

    def __repr__(self) -> str:
        name = "int8" if self.codec == CODEC_INT8 else "raw"
        return f"BatchCodec({name}{'+zlib' if self.use_zlib else ''})"

    def encode(self, x: np.ndarray) -> bytes:
        x = np.ascontiguousarray(x)
        try:
            dt_code = _DTYPE_CODES[np.dtype(x.dtype)]
        except KeyError:
            raise CodecError(f"unsupported dtype {x.dtype}") from None
        if x.ndim == 0 or x.ndim > _MAX_NDIM:
            raise CodecError(f"unsupported ndim {x.ndim} (must be 1..{_MAX_NDIM})")
        hdr = _HDR.pack(self.codec, int(self.use_zlib), x.ndim)
        hdr += struct.pack(f"<{x.ndim}I", *x.shape)
        hdr += struct.pack("<B", dt_code)
        if self.codec == CODEC_INT8:
            q, scale = quantize_int8(x)
            body = scale.astype("<f4").tobytes() + q.tobytes()
        else:
            body = x.tobytes()
        if self.use_zlib:
            body = zlib.compress(body, self.zlib_level)
        return hdr + body

    @staticmethod
    def decode(raw) -> np.ndarray:
        """``raw`` may be bytes or a zero-copy memoryview (the tensor-log
        batch read path hands out views into one coalesced read).  Raises
        ``CodecError`` on any malformed payload."""
        codec, zl, shape, dt_code, body = _split(raw)
        dtype = _dtype_for(dt_code)
        if zl:
            try:
                body = zlib.decompress(body)
            except zlib.error as e:
                raise CodecError(f"corrupt zlib body: {e}") from e
        n = 1
        for d in shape:
            n *= d
        if codec == CODEC_INT8:
            c = shape[-1]
            if len(body) != 4 * c + n:
                raise CodecError(
                    f"int8 body is {len(body)} bytes, expected {4 * c + n} "
                    f"for shape {shape}"
                )
            scale = np.frombuffer(body[: 4 * c], dtype="<f4")
            q = np.frombuffer(body[4 * c:], dtype=np.int8).reshape(shape)
            return dequantize_int8(q, scale, dtype)
        if len(body) != n * dtype.itemsize:
            raise CodecError(
                f"raw body is {len(body)} bytes, expected {n * dtype.itemsize} "
                f"for shape {shape} dtype {dtype}"
            )
        return np.frombuffer(body, dtype=dtype).reshape(shape).copy()

    def compression_ratio(self, x: np.ndarray) -> float:
        return x.nbytes / max(1, len(self.encode(x)))


def transcode(raw, target: "BatchCodec") -> Optional[bytes]:
    """Re-encode a payload to ``target``'s encoding; ``None`` when the
    payload is already there.  When only the zlib layer differs the body
    is recompressed verbatim — an int8 → int8+zlib demotion is bit-stable
    (never re-quantized, so repeated demotions cannot accumulate error).
    A codec change (raw → int8) decodes and re-encodes."""
    codec, zl, shape, dt_code, body = _split(raw)
    if codec == target.codec:
        if zl == target.use_zlib:
            return None
        if zl:
            try:
                body = zlib.decompress(body)
            except zlib.error as e:
                raise CodecError(f"corrupt zlib body: {e}") from e
        else:
            body = zlib.compress(body, target.zlib_level)
        hdr = _HDR.pack(codec, int(target.use_zlib), len(shape))
        hdr += struct.pack(f"<{len(shape)}I", *shape)
        hdr += struct.pack("<B", dt_code)
        return hdr + bytes(body)
    return target.encode(BatchCodec.decode(raw))
