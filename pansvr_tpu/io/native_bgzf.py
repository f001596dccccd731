"""ctypes binding for the native multithreaded BGZF codec
(native/bgzf_codec.cpp), compiled at first use (utils/native_build.py).
io.bgzf uses it for whole-buffer compression and falls back to zlib in
Python when it cannot be built."""

from __future__ import annotations

import ctypes

import numpy as np

_lib = None


def available() -> bool:
    return get_lib() is not None


def get_lib():
    global _lib
    if _lib is None:
        from ..utils.native_build import ensure_built

        path = ensure_built("libpansvr_bgzf.so")
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.bgzf_compress_blocks.restype = ctypes.c_int
        lib.bgzf_decompress_blocks_at.restype = ctypes.c_int
        _lib = lib
    return _lib


def decompress_blocks(data, offs, lens, n_threads: int = 8) -> bytes | None:
    """Decompress many BGZF blocks (extents into `data`) in parallel;
    returns the concatenated payload, or None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(offs)
    if n == 0:
        return b""
    src = np.frombuffer(data, dtype=np.uint8)
    offsets = np.ascontiguousarray(offs, np.int64)
    lens_a = np.ascontiguousarray(lens, np.int32)
    # destination offsets from the ISIZE trailers (last 4 bytes of each
    # block): exact-size output, zero re-concatenation
    tail = (offsets + lens_a - 4).astype(np.int64)
    isz = (
        src[tail].astype(np.int64)
        | (src[tail + 1].astype(np.int64) << 8)
        | (src[tail + 2].astype(np.int64) << 16)
        | (src[tail + 3].astype(np.int64) << 24)
    )
    dst_offs = np.zeros(n + 1, np.int64)
    np.cumsum(isz, out=dst_offs[1:])
    dst = np.empty(int(dst_offs[-1]), dtype=np.uint8)
    rc = lib.bgzf_decompress_blocks_at(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lens_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int(n), ctypes.c_int(n_threads),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        dst_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc < 0:
        return None
    return dst.tobytes()


def compress(data: bytes, level: int = 6, n_threads: int = 8,
             block_size: int = 65000) -> bytes | None:
    """Compress a byte buffer into concatenated BGZF blocks in parallel.
    Returns None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(data)
    if n == 0:
        return b""
    n_blocks = (n + block_size - 1) // block_size
    src = np.frombuffer(data, dtype=np.uint8)
    offsets = (np.arange(n_blocks, dtype=np.int64) * block_size)
    lens = np.full(n_blocks, block_size, dtype=np.int32)
    lens[-1] = n - (n_blocks - 1) * block_size
    dst = np.empty(n_blocks * 65536, dtype=np.uint8)
    dst_lens = np.empty(n_blocks, dtype=np.int32)
    rc = lib.bgzf_compress_blocks(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int(n_blocks), ctypes.c_int(level), ctypes.c_int(n_threads),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        dst_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc < 0:
        return None
    parts = [
        dst[i * 65536 : i * 65536 + dst_lens[i]].tobytes()
        for i in range(n_blocks)
    ]
    return b"".join(parts)
