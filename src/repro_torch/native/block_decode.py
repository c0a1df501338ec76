"""The LSM store's native block decoder: a chunk of int8 codec payloads
inflated and dequantized in one foreign call that never takes the GIL.

``csrc/block_decode.c`` (plain C, no zlib header) is built by the host's C
compiler into ``build/native/`` at the root of the checkout, as the CUDA
kernels are (``build.py``: named by a hash of its source and flags,
renamed into place, an unchanged source loaded as it is).  ``load()``
builds or loads it once a process; ``KVBlockStore`` calls it at
construction, so no get ever compiles.  A host without a C compiler, or
without zlib's runtime ``libz.so.1``, raises there, naming what is
missing: every process that makes a store, a cache node's included, needs
both.

``decode(dec, payloads)`` is the codec's decode for a list of payloads,
bit for bit and in order: each payload's header is read with the codec's
own parser, and every int8 payload whose output is f16 or f32 (zlib on or
off) is decoded in one call of ``block_decode_int8``, into arrays numpy
allocated beforehand.  Any other payload (raw codec, bf16, int8 outputs,
a header the parser rejects, an empty shape), and any block the call
reports it could not decode, goes through ``BatchCodec.decode``, in order,
so a bad payload raises exactly the ``CodecError`` a serial loop raises
first.
"""

from __future__ import annotations

import ctypes
import math
import shutil
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from ..core.codec import CODEC_INT8, BatchCodec, CodecError, _split
from .build import library_file, load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "block_decode.c"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
CFLAGS = ["-std=c99", "-O3", "-ffp-contract=off", "-fno-fast-math", "-fPIC", "-shared"]
COMPILERS = ("cc", "gcc", "clang")
# output dtype of a payload's dtype code: 0 f32, 1 f16 (core/codec.py's _DTYPES)
_NATIVE_DTYPES = {0: np.dtype(np.float32), 1: np.dtype(np.float16)}
# the native call's arguments after the count, per block: body address, body
# length, zlibbed, rows, cols, f32 output, output address
_FIELD_TYPES = (np.uintp, np.uint64, np.uint8, np.uint64, np.uint64, np.uint8, np.uintp)
# deflate expands a stream at most ~1032-fold: a body that would inflate to
# more than this many times its size is corrupt, and the codec names why
_MAX_INFLATE_RATIO = 1100

_loaded: "NativeDecoder | None" = None


class NativeDecoder:
    """The loaded library and zlib's ``uncompress`` it is handed."""

    def __init__(self, lib: ctypes.CDLL, libz: ctypes.CDLL, path: Path):
        self.path = path
        self._libz = libz  # keeps zlib mapped while ``uncompress`` is in use
        self.uncompress = ctypes.cast(libz.uncompress, ctypes.c_void_p).value
        fn = lib.block_decode_int8
        fn.restype = None
        fn.argtypes = [ctypes.c_int64] + [ctypes.c_void_p] * 9
        self.entry = fn
        self.lib = lib


def compiler() -> str:
    for name in COMPILERS:
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError(
        f"no C compiler ({', '.join(COMPILERS)}) on PATH: the LSM store builds its block "
        f"decoder ({SOURCE.name}) when it is constructed"
    )


def library_path() -> Path:
    return library_file(BUILD_DIR, "block_decode", SOURCE.read_bytes() + " ".join(CFLAGS).encode())


def _libz() -> ctypes.CDLL:
    try:
        return ctypes.CDLL("libz.so.1")
    except OSError as e:
        raise RuntimeError(f"zlib's runtime library libz.so.1 cannot be loaded: {e}") from e


def load() -> NativeDecoder:
    """The process's decoder, built first if its library is not on disk
    yet.  Raises ``RuntimeError`` naming a missing compiler or zlib."""
    global _loaded
    if _loaded is None:
        libz = _libz()
        cc = compiler()
        path = library_path()
        lib = load_library("block_decode", path, lambda tmp: [cc, *CFLAGS, "-o", str(tmp), str(SOURCE)])
        _loaded = NativeDecoder(lib, libz, path)
    return _loaded


def decode(dec: NativeDecoder, payloads: Sequence) -> Tuple[List[np.ndarray], int]:
    """``[BatchCodec.decode(p) for p in payloads]``, bit for bit, with the
    count of blocks the native call decoded."""
    out: List[np.ndarray] = [None] * len(payloads)
    picked, fields = [], []  # payload index; its _FIELD_TYPES (``payloads`` keeps the bodies alive)
    for i, p in enumerate(payloads):
        try:
            codec, zl, shape, dt_code, body = _split(p)
        except CodecError:
            continue  # decoded, so raised, in order below
        dtype = _NATIVE_DTYPES.get(dt_code)
        cols = shape[-1]
        n = math.prod(shape)
        need = 4 * cols + n
        fits = need <= _MAX_INFLATE_RATIO * len(body) + 64 if zl else need == len(body)
        if codec != CODEC_INT8 or dtype is None or n == 0 or not fits:
            continue
        arr = np.empty(shape, dtype=dtype)
        out[i] = arr
        picked.append(i)
        fields.append((np.frombuffer(body, dtype=np.uint8).ctypes.data, len(body), int(zl), n // cols, cols,
                       int(dt_code == 0), arr.ctypes.data))
    status = np.zeros(len(picked), dtype=np.int32)
    if picked:
        args = [np.array(col, dtype=t) for col, t in zip(zip(*fields), _FIELD_TYPES)]
        dec.entry(len(picked), *(a.ctypes.data for a in args), dec.uncompress, status.ctypes.data)
    done = {i for i, s in zip(picked, status) if s == 0}
    for i, p in enumerate(payloads):
        if i not in done:
            out[i] = BatchCodec.decode(p)
    return out, len(done)
