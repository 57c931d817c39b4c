"""LZ4-frame codec over the system ``liblz4`` (ctypes).

The reference stores per-scene motion as lz4framed-compressed pickles
(``utils/utils.py:111-115``, ``load_compressed_tensor``). Those are standard
LZ4 frames (magic 0x184D2204), and ``liblz4.so`` ships the frame API
(LZ4F_*), so reference ``*_motion.pth`` files load without a Python lz4
package; ``compress`` writes such frames (motion files in the reference's
format, without any Python lz4 package). Copy of ``slrsfs_tpu/data/lz4f.py``.
"""

from __future__ import annotations

import ctypes
import ctypes.util

_LZ4F_VERSION = 100
_MAGIC = b"\x04\x22\x4d\x18"


def _load_lib():
    for name in ("liblz4.so.1", "liblz4.so", ctypes.util.find_library("lz4")):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        if hasattr(lib, "LZ4F_decompress"):
            _bind(lib)
            return lib
    return None


def _bind(lib):
    lib.LZ4F_isError.restype = ctypes.c_uint
    lib.LZ4F_isError.argtypes = [ctypes.c_size_t]
    lib.LZ4F_getErrorName.restype = ctypes.c_char_p
    lib.LZ4F_getErrorName.argtypes = [ctypes.c_size_t]
    lib.LZ4F_createDecompressionContext.restype = ctypes.c_size_t
    lib.LZ4F_createDecompressionContext.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint]
    lib.LZ4F_freeDecompressionContext.restype = ctypes.c_size_t
    lib.LZ4F_freeDecompressionContext.argtypes = [ctypes.c_void_p]
    lib.LZ4F_decompress.restype = ctypes.c_size_t
    lib.LZ4F_decompress.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_void_p]
    lib.LZ4F_compressFrameBound.restype = ctypes.c_size_t
    lib.LZ4F_compressFrameBound.argtypes = [ctypes.c_size_t, ctypes.c_void_p]
    lib.LZ4F_compressFrame.restype = ctypes.c_size_t
    lib.LZ4F_compressFrame.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]


_LIB = _load_lib()


def available() -> bool:
    return _LIB is not None


def _check(code: int) -> int:
    if _LIB.LZ4F_isError(code):
        raise RuntimeError(
            "liblz4: " + _LIB.LZ4F_getErrorName(code).decode("ascii"))
    return code


def decompress(data: bytes) -> bytes:
    """Decompress one LZ4 frame (or a concatenation of frames)."""
    if _LIB is None:
        raise ImportError("liblz4 not found on this system")
    if data[:4] != _MAGIC:
        raise ValueError("not an LZ4 frame (bad magic)")
    dctx = ctypes.c_void_p()
    _check(_LIB.LZ4F_createDecompressionContext(
        ctypes.byref(dctx), _LZ4F_VERSION))
    try:
        src = ctypes.create_string_buffer(data, len(data))
        src_off = 0
        chunk = max(1 << 16, len(data) * 4)
        dst = ctypes.create_string_buffer(chunk)
        out = []
        hint = 0
        while src_off < len(data):
            src_size = ctypes.c_size_t(len(data) - src_off)
            dst_size = ctypes.c_size_t(chunk)
            hint = _check(_LIB.LZ4F_decompress(
                dctx,
                dst, ctypes.byref(dst_size),
                ctypes.byref(src, src_off), ctypes.byref(src_size),
                None))
            if dst_size.value:
                out.append(dst.raw[: dst_size.value])
            if src_size.value == 0 and dst_size.value == 0:
                raise RuntimeError("liblz4: truncated LZ4 frame")
            src_off += src_size.value
        # LZ4F_decompress returns a nonzero "bytes still expected" hint when
        # the frame is incomplete; without this check a truncated input that
        # is fully consumed would return partial plaintext silently and
        # surface later as a confusing pickle error.
        if hint:
            raise RuntimeError("liblz4: truncated LZ4 frame "
                               f"({hint} more bytes expected)")
        return b"".join(out)
    finally:
        _LIB.LZ4F_freeDecompressionContext(dctx)


def compress(data: bytes) -> bytes:
    """Compress ``data`` into a single LZ4 frame (default preferences)."""
    if _LIB is None:
        raise ImportError("liblz4 not found on this system")
    bound = _LIB.LZ4F_compressFrameBound(len(data), None)
    dst = ctypes.create_string_buffer(bound)
    n = _check(_LIB.LZ4F_compressFrame(dst, bound, data, len(data), None))
    return dst.raw[:n]
