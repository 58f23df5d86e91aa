"""Python client for the HTTP serving daemon (``shazam_tpu_torch/serve.py``).

A copy of ``shazam_tpu/client.py`` (the two daemons speak one protocol).
The reference's "client" was a mic script talking SQL to a shared
database; this framework serves recognition over HTTP, and this module
is the matching SDK — stdlib ``urllib`` + numpy only, so a client
machine needs neither PyTorch nor the framework's heavy deps (the
package ``__init__`` loads ``SIA`` lazily for exactly this reason).

    from shazam_tpu_torch.client import SIAClient

    c = SIAClient("http://localhost:8080")
    print(c.recognize(samples, fs=44100)["results"][0]["song_name"])

    with c.open_stream(channels=1) as s:      # continuous listening
        for chunk in mic_chunks():
            hit = s.feed(chunk, recognize=True)
            if hit["results"]:
                ...

Every method raises ``SIAServerError`` (with the daemon's error text
and HTTP status) on non-2xx replies.
"""

from __future__ import annotations

import io
import json
import urllib.error
import urllib.parse
import urllib.request
import wave
from typing import Dict, List, Optional, Sequence, Union

import numpy as np


class SIAServerError(RuntimeError):
    """A non-2xx reply from the daemon."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message


def _to_int16(arr: np.ndarray) -> np.ndarray:
    """Samples -> int16 PCM, honoring both common float conventions.

    Normalized float audio in [-1, 1] scales to full int16 range
    (``astype(int16)`` would truncate it to all zeros — silence);
    float already at int16 scale is rounded and clipped; integers are
    clipped into range instead of wrapping.
    """
    if arr.dtype == np.int16:
        return arr
    if np.issubdtype(arr.dtype, np.floating):
        peak = float(np.max(np.abs(arr))) if arr.size else 0.0
        if peak <= 1.0:
            arr = arr * 32767.0
        return np.clip(np.rint(arr), -32768, 32767).astype(np.int16)
    return np.clip(arr, -32768, 32767).astype(np.int16)


def encode_wav(samples: Union[np.ndarray, Sequence[np.ndarray]],
               fs: int) -> bytes:
    """int16 PCM WAV bytes from mono samples or a (channels, n) array /
    list of per-channel arrays (the shape ``audio.io.read`` returns).
    Float input in [-1, 1] is treated as normalized full-scale audio."""
    arr = np.asarray(samples)
    if arr.ndim == 1:
        n_ch, frames = 1, _to_int16(arr)
    elif arr.ndim == 2:
        n_ch = arr.shape[0]
        frames = _to_int16(arr).T.reshape(-1)  # interleave
    else:
        raise ValueError(f"samples must be 1-D or (channels, n), "
                         f"got shape {arr.shape}")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(n_ch)
        wf.setsampwidth(2)
        wf.setframerate(int(fs))
        wf.writeframes(frames.tobytes())
    return buf.getvalue()


class SIAClient:
    """One daemon endpoint; methods map 1:1 onto its HTTP routes."""

    def __init__(self, base_url: str = "http://127.0.0.1:8080",
                 timeout_s: float = 600.0, auth_token: Optional[str] = None):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = float(timeout_s)
        # sent on every request; the daemon only checks it on catalog
        # mutations (serve --auth-token)
        self.auth_token = auth_token

    # ---- plumbing --------------------------------------------------------
    def _request(self, method: str, path: str, params: Optional[Dict] = None,
                 body: bytes = b"", raw: bool = False):
        qs = {k: v for k, v in (params or {}).items() if v is not None}
        url = self.base_url + path
        if qs:
            url += "?" + urllib.parse.urlencode(qs)
        req = urllib.request.Request(url, data=body if method == "POST"
                                     else None, method=method)
        if self.auth_token:
            req.add_header("Authorization", f"Bearer {self.auth_token}")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                data = r.read()
        except urllib.error.HTTPError as e:
            detail = e.read()
            try:
                detail = json.loads(detail).get("error", detail.decode())
            except Exception:  # noqa: BLE001 — non-JSON error body
                detail = detail.decode(errors="replace")
            raise SIAServerError(e.code, detail) from None
        return data if raw else json.loads(data)

    # ---- recognition / catalog ------------------------------------------
    def recognize(self, samples=None, fs: Optional[int] = None, *,
                  wav_bytes: Optional[bytes] = None,
                  path: Optional[str] = None,
                  topn: Optional[int] = None) -> Dict:
        """Identify a clip: pass ``samples`` (+ ``fs``), ``wav_bytes``,
        or a ``path`` to an audio file."""
        body = self._audio_body(samples, fs, wav_bytes, path)
        return self._request("POST", "/recognize", {"topn": topn}, body)

    def ingest(self, name: str, samples=None, fs: Optional[int] = None, *,
               wav_bytes: Optional[bytes] = None,
               path: Optional[str] = None) -> Dict:
        """Add a song to the live catalog (online ingest)."""
        body = self._audio_body(samples, fs, wav_bytes, path)
        return self._request("POST", "/ingest", {"name": name}, body)

    def delete(self, songs: Union[str, int, Sequence]) -> Dict:
        """Remove songs by id and/or name (scalar or sequence)."""
        if isinstance(songs, (str, int)):
            songs = [songs]
        spec = ",".join(str(s) for s in songs)
        return self._request("POST", "/delete", {"songs": spec})

    def save(self, path: Optional[str] = None) -> Dict:
        """Snapshot the live index (daemon-side path; defaults to its
        --persist path)."""
        return self._request("POST", "/save", {"path": path})

    def stats(self) -> Dict:
        return self._request("GET", "/stats")

    def healthy(self) -> bool:
        try:
            return bool(self._request("GET", "/healthz").get("ok"))
        except (SIAServerError, OSError):
            return False

    def metrics(self) -> str:
        """Prometheus text exposition (GET /metrics)."""
        return self._request("GET", "/metrics", raw=True).decode()

    # ---- streaming -------------------------------------------------------
    def open_stream(self, channels: int = 1, window_seconds: float = 15.0,
                    engine: str = "host") -> "StreamSession":
        out = self._request("POST", "/stream/open", {
            "channels": channels, "window": window_seconds,
            "engine": engine})
        return StreamSession(self, out["session"], channels)

    @staticmethod
    def _audio_body(samples, fs, wav_bytes, path) -> bytes:
        given = sum(x is not None for x in (samples, wav_bytes, path))
        if given != 1:
            raise ValueError(
                "pass exactly one of samples(+fs), wav_bytes, or path")
        if wav_bytes is not None:
            return wav_bytes
        if path is not None:
            with open(path, "rb") as fh:
                return fh.read()
        if fs is None:
            raise ValueError("samples require fs")
        return encode_wav(samples, fs)


class StreamSession:
    """One continuous-listening session; a context manager that closes
    the server-side state on exit."""

    def __init__(self, client: SIAClient, session_id: str, channels: int):
        self.client = client
        self.session_id = session_id
        self.channels = channels
        self._open = True

    def feed(self, samples: np.ndarray, *, recognize: bool = False,
             topn: Optional[int] = None) -> Dict:
        """Send one chunk (mono array, or (channels, n) to interleave).
        ``recognize=True`` also matches the updated window in the same
        round trip."""
        arr = _to_int16(np.asarray(samples))
        if arr.ndim == 2:
            arr = arr.T.reshape(-1)
        body = np.ascontiguousarray(arr.astype("<i2")).tobytes()
        return self.client._request("POST", "/stream/feed", {
            "session": self.session_id,
            "recognize": 1 if recognize else None,
            "topn": topn}, body)

    def recognize(self, topn: Optional[int] = None) -> Dict:
        return self.client._request("POST", "/stream/recognize", {
            "session": self.session_id, "topn": topn})

    def close(self) -> None:
        if self._open:
            self._open = False
            self.client._request("POST", "/stream/close",
                                 {"session": self.session_id})

    def __enter__(self) -> "StreamSession":
        return self

    def __exit__(self, *exc) -> None:
        try:
            self.close()
        except (SIAServerError, OSError):
            pass  # session may have been TTL-evicted already
