"""In-process MP3 decode via the system libmpg123 (ctypes).

A copy of ``shazam_tpu.audio.mp3`` (the port imports nothing of the JAX
package). The reference corpus is MP3 (reference ``__init__.py:86``
decodes with pydub -> ffmpeg). Where ``libmpg123.so.0`` is installed,
MP3 decodes in-process, with no subprocess and the GIL released inside
the C library during each read; where it is not, ``available()`` is
False.

Exposes :func:`available` and :func:`decode_mp3`; ``audio/io.read``
routes ``.mp3`` here first and falls back to the ffmpeg CLI path.
Output is interleaved int16 at the stream's native rate, exactly like
the ffmpeg s16le path.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import threading
from typing import Optional, Tuple

import numpy as np

# libmpg123 constants (mpg123.h)
_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_ENC_SIGNED_16 = 0x040 | 0x080 | 0x10   # 16-bit | signed | s16 tag

_lock = threading.Lock()
_lib = None
_lib_tried = False


def _load() -> Optional[ctypes.CDLL]:
    """dlopen libmpg123 once; None (cached) when absent."""
    global _lib, _lib_tried
    with _lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        names = ["libmpg123.so.0", "libmpg123.so"]
        found = ctypes.util.find_library("mpg123")
        if found:
            names.insert(0, found)
        for name in names:
            try:
                lib = ctypes.CDLL(name)
            except OSError:
                continue
            try:
                _bind(lib)
            except AttributeError:
                continue
            lib.mpg123_init()   # no-op on modern libmpg123, required on old
            _lib = lib
            break
        return _lib


def _bind(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.mpg123_init.restype = c.c_int
    lib.mpg123_new.restype = c.c_void_p
    lib.mpg123_new.argtypes = [c.c_char_p, c.POINTER(c.c_int)]
    lib.mpg123_delete.restype = None
    lib.mpg123_delete.argtypes = [c.c_void_p]
    lib.mpg123_open.restype = c.c_int
    lib.mpg123_open.argtypes = [c.c_void_p, c.c_char_p]
    lib.mpg123_close.restype = c.c_int
    lib.mpg123_close.argtypes = [c.c_void_p]
    lib.mpg123_getformat.restype = c.c_int
    lib.mpg123_getformat.argtypes = [
        c.c_void_p, c.POINTER(c.c_long), c.POINTER(c.c_int),
        c.POINTER(c.c_int)]
    lib.mpg123_format_none.restype = c.c_int
    lib.mpg123_format_none.argtypes = [c.c_void_p]
    lib.mpg123_format.restype = c.c_int
    lib.mpg123_format.argtypes = [c.c_void_p, c.c_long, c.c_int, c.c_int]
    lib.mpg123_read.restype = c.c_int
    lib.mpg123_read.argtypes = [
        c.c_void_p, c.c_void_p, c.c_size_t, c.POINTER(c.c_size_t)]
    lib.mpg123_strerror.restype = c.c_char_p
    lib.mpg123_strerror.argtypes = [c.c_void_p]


def available() -> bool:
    """True when libmpg123 can be loaded on this machine."""
    return _load() is not None


def decode_mp3(path: str,
               limit: Optional[float] = None
               ) -> Tuple[np.ndarray, int, int]:
    """Decode an MP3 file to ``(interleaved int16, sample_rate, channels)``.

    ``limit`` keeps only the first N seconds (decode stops early). Raises
    RuntimeError when libmpg123 is unavailable or the stream is invalid.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(
            f"cannot decode {path!r}: libmpg123 not found on this system")
    if not os.path.exists(path):
        raise FileNotFoundError(path)

    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError(f"mpg123_new failed (error {err.value})")
    try:
        if lib.mpg123_open(h, path.encode()) != _MPG123_OK:
            raise RuntimeError(
                f"mpg123 cannot open {path!r}: "
                f"{lib.mpg123_strerror(h).decode()}")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        enc = ctypes.c_int(0)
        if lib.mpg123_getformat(h, ctypes.byref(rate),
                                ctypes.byref(channels),
                                ctypes.byref(enc)) != _MPG123_OK:
            raise RuntimeError(
                f"mpg123 cannot probe {path!r}: "
                f"{lib.mpg123_strerror(h).decode()}")
        fs, n_ch = int(rate.value), int(channels.value)
        if fs <= 0 or n_ch <= 0:
            raise RuntimeError(f"{path!r}: invalid MP3 format {fs}Hz/{n_ch}ch")
        # pin the output format so rate/encoding can't shift mid-stream
        lib.mpg123_format_none(h)
        if lib.mpg123_format(h, fs, n_ch, _MPG123_ENC_SIGNED_16) \
                != _MPG123_OK:
            raise RuntimeError(f"{path!r}: mpg123 refused s16 output")

        max_bytes = None
        if limit is not None:
            max_bytes = int(limit * fs) * n_ch * 2

        chunks = []
        total = 0
        buf = (ctypes.c_char * (1 << 18))()
        done = ctypes.c_size_t(0)
        while True:
            rc = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(bytes(buf[: done.value]))
                total += done.value
            if rc == _MPG123_DONE:
                break
            if rc == _MPG123_NEW_FORMAT:
                continue        # format pinned above; tag frame boundary
            if rc != _MPG123_OK:
                raise RuntimeError(
                    f"mpg123 decode error in {path!r}: "
                    f"{lib.mpg123_strerror(h).decode()}")
            if max_bytes is not None and total >= max_bytes:
                break
        data = np.frombuffer(b"".join(chunks), dtype="<i2")
        if max_bytes is not None:
            data = data[: max_bytes // 2]
        # whole frames only (defensive: mpg123 emits whole frames already)
        if n_ch > 1 and data.size % n_ch:
            data = data[: data.size - (data.size % n_ch)]
        if data.size == 0:
            raise RuntimeError(f"{path!r}: MP3 decoded to zero samples")
        return data, fs, n_ch
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)
