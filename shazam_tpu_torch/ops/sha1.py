"""Bit-exact lane-parallel SHA-1 of the ``"f1|f2|dt"`` hash messages.

The reference hashes the ASCII string ``f"{f1}|{f2}|{dt}"`` with hashlib
SHA-1 and keeps the first 20 hex chars (80 bits), reference
``__init__.py:179-210``. Those messages are at most 14 bytes (each field
<= 4 decimal digits), so after padding they fill exactly one 512-bit
block; the block is built by integer digit decomposition, never strings,
and the 80 rounds run as elementwise tensor ops over every lane at once.

PyTorch's uint32 lacks add, shifts and compares on the CPU, so every
32-bit word is carried in int64 and masked with ``0xFFFFFFFF`` after each
operation that can carry past bit 31.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_PIPE = 0x7C             # '|'
_MAX_MSG_BYTES = 15      # 4+1+4+1+4 digits/pipes = 14, plus the 0x80 pad byte
_K = (0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xCA62C1D6)
_H0 = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0)


def _rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x << n) & M32) | (x >> (32 - n))


def _num_digits(x: torch.Tensor) -> torch.Tensor:
    """Decimal digit count for 0 <= x <= 9999."""
    return 1 + (x >= 10).long() + (x >= 100).long() + (x >= 1000).long()


def _digit_char(x: torch.Tensor, ndig: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
    """ASCII code of decimal digit ``pos`` (MSB-first) of x."""
    e = ndig - 1 - pos
    div = torch.where(e == 0, 1, torch.where(e == 1, 10,
                                             torch.where(e == 2, 100, 1000)))
    return 0x30 + torch.div(x, div, rounding_mode="floor") % 10


def _block_words(f1: torch.Tensor, f2: torch.Tensor, dt: torch.Tensor):
    """Padded SHA-1 block words w0..w15 (big-endian) of "f1|f2|dt"."""
    d1, d2, d3 = _num_digits(f1), _num_digits(f2), _num_digits(dt)
    pipe1 = d1
    pipe2 = d1 + d2 + 1
    msg_len = d1 + d2 + d3 + 2
    zero = torch.zeros_like(f1)
    byte_cols = []
    for p in range(_MAX_MSG_BYTES):
        c1 = _digit_char(f1, d1, torch.clamp(d1 - 1, max=p))
        c2 = _digit_char(f2, d2, torch.minimum(p - pipe1 - 1, d2 - 1))
        c3 = _digit_char(dt, d3, torch.minimum(p - pipe2 - 1, d3 - 1))
        byte = torch.where(
            p < d1, c1,
            torch.where(
                (p == pipe1) | (p == pipe2), _PIPE,
                torch.where((p > pipe1) & (p < pipe2), c2,
                            torch.where((p > pipe2) & (p < msg_len), c3,
                                        torch.where(p == msg_len, 0x80, zero)))))
        byte_cols.append(byte)
    words = []
    for wi in range(4):  # message bytes 0..15; words 4..14 are zero
        w = zero
        for bi in range(4):
            idx = wi * 4 + bi
            w = (w << 8) | (byte_cols[idx] if idx < _MAX_MSG_BYTES else zero)
        words.append(w)
    words += [zero] * 11
    words.append(msg_len << 3)  # bit length; msg_len < 56 keeps word 14 zero
    return words


def sha1_fingerprint_keys(f1: torch.Tensor, f2: torch.Tensor,
                          dt: torch.Tensor):
    """80-bit SHA-1 prefix of "f1|f2|dt" as (hi, lo, ex16) int64 tensors.

    Inputs are integer tensors of one shape with values in [0, 9999].
    hi = digest bits 0..31, lo = bits 32..63, ex16 = bits 64..79: together
    the reference's first 20 hex chars.
    """
    f1, f2, dt = (v.to(torch.int64) for v in (f1, f2, dt))
    w = _block_words(f1, f2, dt)
    a, b, c, d, e = (torch.full_like(f1, h) for h in _H0)
    for t in range(80):
        j = t % 16
        if t >= 16:
            w[j] = _rotl(w[(j + 13) % 16] ^ w[(j + 8) % 16]
                         ^ w[(j + 2) % 16] ^ w[j], 1)
        if t < 20:
            f = (b & c) | ((b ^ M32) & d)
        elif t < 40 or t >= 60:
            f = b ^ c ^ d
        else:
            f = (b & c) | (b & d) | (c & d)
        tmp = (_rotl(a, 5) + f + e + _K[t // 20] + w[j]) & M32
        a, b, c, d, e = tmp, a, _rotl(b, 30), c, d
    hi = (a + _H0[0]) & M32
    lo = (b + _H0[1]) & M32
    ex = ((c + _H0[2]) & M32) >> 16
    return hi, lo, ex


def keys_to_hex(hi: np.ndarray, lo: np.ndarray, ex: np.ndarray):
    """Host-side: render (hi, lo, ex16) keys as the reference's 20-char hex."""
    hi = np.asarray(hi, dtype=np.uint32)
    lo = np.asarray(lo, dtype=np.uint32)
    ex = np.asarray(ex, dtype=np.uint32)
    return [f"{a:08x}{b:08x}{c:04x}"
            for a, b, c in zip(hi.ravel(), lo.ravel(), ex.ravel())]
