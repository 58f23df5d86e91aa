"""The plain reference fingerprint: the reference pipeline's semantics in
plain torch, independent of the program.

Patterned on the repository's test oracle (``tests/oracle/oracle.py``,
numpy/scipy/hashlib) and imports nothing of the program:

- the PSD of ``mlab.specgram``: symmetric Hann window (``np.hanning``),
  frames of ``wsize`` at hop ``wsize - noverlap``, no detrend, one-sided
  (bins 1..wsize/2-1 doubled), divided by ``fs * sum(window**2)``;
- ``10 * log10`` with exact zeros kept at 0;
- peaks: equal to the maximum of the (2r+1)^2 square around them, the
  window clipped to the array (what scipy's reflect boundary gives a
  maximum), and strictly above ``amp_min``; the zero-background erosion of
  the reference cannot add a peak when ``amp_min > 0``, since its cells
  read 0 dB;
- peaks in (time, frequency) order; anchor i pairs with i+1..i+fan-1 when
  ``min_dt <= dt <= max_dt``;
- the hash of a pair: SHA-1 of ``"f1|f2|dt"``, first 20 hex digits.

The power is computed in ``dtype`` (float64, as ``mlab``) and, when
``power_dtype`` is given, rounded to it before the peaks. The benchmark's
reference rounds it to float32, the spectrogram precision the program's
configuration states (``FingerprintConfig.spectrogram_dtype``), so that
equal neighbours in float32 are equal maxima in both; the control rounds
it to bfloat16, the step below, which would halve the spectrogram's
bytes. Without ``power_dtype`` it is the oracle's float64 pipeline.

Rows are kept as integer triple keys ``(f1 * 2049 + f2) * 256 + dt``: two
pairs share a hash exactly when they share a triple, up to collisions of
the 80-bit truncated SHA-1, so the reference matches on triples and
hashes only the pairs it compares with the program's keys.
"""

from __future__ import annotations

import hashlib

import torch
import torch.nn.functional as F


def triple_key(f1, f2, dt, n_bins: int):
    return (f1 * n_bins + f2) * 256 + dt


def split_key(key: int, n_bins: int):
    """(f1, f2, dt) of a triple key."""
    dt = key % 256
    f12 = key // 256
    return f12 // n_bins, f12 % n_bins, dt


def hex20(key: int, n_bins: int) -> str:
    """The reference's 20-hex-digit hash of a triple key."""
    f1, f2, dt = split_key(int(key), n_bins)
    return hashlib.sha1(f"{f1}|{f2}|{dt}".encode()).hexdigest()[:20]


def db_spectrogram(x: torch.Tensor, n_valid: int, *, fs: int, wsize: int,
                   hop: int, dtype=torch.float64,
                   power_dtype=None) -> torch.Tensor:
    """(B, >= n_valid) samples -> (B, frames, wsize/2+1) dB power, the
    power rounded to ``power_dtype`` first when one is given."""
    x = x[:, :n_valid].to(dtype)
    k = torch.arange(wsize, dtype=dtype, device=x.device)
    win = 0.5 - 0.5 * torch.cos(2 * torch.pi * k / (wsize - 1))
    spec = torch.fft.rfft(x.unfold(1, wsize, hop) * win, dim=-1)
    psd = spec.real.square() + spec.imag.square()
    del spec
    psd[..., 1:-1] *= 2.0
    psd /= fs * win.square().sum()
    if power_dtype is not None:
        psd = psd.to(power_dtype).to(dtype)
    nz = psd != 0
    return torch.where(nz, 10.0 * torch.log10(torch.where(nz, psd, 1.0)), 0.0)


def peak_mask(db: torch.Tensor, amp_min: float, radius: int) -> torch.Tensor:
    """(B, T, F) dB -> bool peaks: the maximum of the clipped square
    around them (two separable max passes) and > ``amp_min``."""
    w = 2 * radius + 1
    m = F.max_pool2d(db[:, None], (w, 1), stride=1, padding=(radius, 0))
    m = F.max_pool2d(m, (1, w), stride=1, padding=(0, radius))[:, 0]
    return (db == m) & (db > amp_min)


def pair_rows(mask: torch.Tensor, *, fan: int, min_dt: int, max_dt: int):
    """Bool (B, T, F) peaks -> (row b, triple key, anchor frame) of every
    pair, int64 tensors, not deduplicated."""
    b, t, f = mask.nonzero(as_tuple=True)     # (b, t, f) lexicographic
    n_bins = mask.shape[2]
    out = []
    for j in range(1, fan):
        same = b[j:] == b[:-j]
        dt = t[j:] - t[:-j]
        ok = same & (dt >= min_dt) & (dt <= max_dt)
        out.append((b[:-j][ok], triple_key(f[:-j][ok], f[j:][ok], dt[ok],
                                           n_bins), t[:-j][ok]))
    return tuple(torch.cat([o[i] for o in out]) for i in range(3))


def unique_rows(b, key, t1):
    """Each (b, key, t1) once, sorted, through one composite key: b
    (< 2^12), then key (< 2049^2 * 256 < 2^31), then t1 (< 2^20)."""
    comp = torch.unique((b << 51) | (key << 20) | t1)
    return comp >> 51, (comp >> 20) & ((1 << 31) - 1), comp & ((1 << 20) - 1)


class Fingerprinter:
    """The reference pipeline at a config's settings (a dict with the
    program's field names, which are the reference's)."""

    def __init__(self, cfg: dict, dtype=torch.float64, power_dtype=None):
        self.fs = cfg.get("sample_rate", 44100)
        self.wsize = cfg.get("window_size", 4096)
        self.hop = self.wsize - int(self.wsize * cfg.get("overlap_ratio", 0.5))
        self.amp_min = cfg.get("amp_min", 10.0)
        self.radius = cfg.get("peak_neighborhood_size", 10)
        self.fan = cfg.get("fan_value", 5)
        self.min_dt = cfg.get("min_hash_time_delta", 0)
        self.max_dt = cfg.get("max_hash_time_delta", 200)
        self.n_bins = self.wsize // 2 + 1
        self.dtype = dtype
        self.power_dtype = power_dtype

    def rows(self, x: torch.Tensor, n_valid: int):
        """(B, >= n_valid) samples -> (b, key, t1) pair rows, each row's
        unique (key, t1) pairs once, sorted by (b, key, t1)."""
        if n_valid < self.wsize:
            z = torch.zeros(0, dtype=torch.int64, device=x.device)
            return z, z, z
        db = db_spectrogram(x, n_valid, fs=self.fs, wsize=self.wsize,
                            hop=self.hop, dtype=self.dtype,
                            power_dtype=self.power_dtype)
        mask = peak_mask(db, self.amp_min, self.radius)
        del db
        return unique_rows(*pair_rows(mask, fan=self.fan, min_dt=self.min_dt,
                                      max_dt=self.max_dt))

    def hex_pairs(self, keys, t1s) -> set:
        """{(hex20, t1)} of pair rows."""
        return {(hex20(k, self.n_bins), int(t)) for k, t in
                zip(keys.tolist(), t1s.tolist())}
