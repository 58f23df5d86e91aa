"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference (``reference/``).

Three layers, each by numbers with limits of their own (``LIMITS``):

- ``store_row_gap``: for songs sampled from the seed, 1 - the Jaccard
  index of the store's (hash, offset) rows of the song against the
  reference's; the widest over the sample;
- ``clip_hash_gap``: for clips sampled from the seed, 1 - the Jaccard
  index of the unique (hash, offset) pairs of the query that the timed
  entry point builds for the clip (``recognized_clip_pairs``,
  ``prepared_batch_pairs``) against the reference's; the median over the
  sample (the widest swings with a few near-equal neighbours that K1's
  float64 sum rounds the other way, PERF.md);
- ``answers_off``: sampled clips with an answer in the window (each
  answer of the clip is compared) whose song or offset differs from the
  reference's answer over the whole catalog;
- ``count_gap``: over the same answers, the widest relative gap of the
  query pairs, the total matches and the top song's matched hashes (a
  lower bound the program flags as one, ``partial_counts``, gaps only
  where it passes the reference's count).

Program outputs are read here; the reference gets only the seed's inputs.
"""

from __future__ import annotations

import numpy as np

# name -> limit: a reading above its limit is not correct. Set from the
# program's readings over many seeds and the bfloat16 control's (PERF.md).
LIMITS = {"store_row_gap": 0.02, "clip_hash_gap": 0.01, "answers_off": 0,
          "count_gap": 0.005, "songs_missing": 0}


def gap(a: set, b: set) -> float:
    """1 - |a & b| / |a | b| (0 for two empty sets)."""
    union = len(a | b)
    return 1.0 - len(a & b) / union if union else 0.0


def hex_rows(hi, lo, ex, t1) -> set:
    return {(f"{int(a):08x}{int(b):08x}{int(c):04x}", int(t))
            for a, b, c, t in zip(hi, lo, ex, t1)}


def store_rows(sia, song_ids: dict) -> dict:
    """{key: set of (hex, offset)} of the store's rows for each catalog
    song id in ``song_ids`` (key -> id)."""
    ix = sia.index
    sid = np.asarray(ix.song_id)
    out = {}
    for key, want in song_ids.items():
        sel = np.nonzero(sid == want)[0]
        out[key] = hex_rows(ix.key_hi[sel], ix.key_lo[sel], ix.key_ex[sel],
                            ix.offset[sel])
    return out


def bucket_len(n: int, step: int = 1 << 18) -> int:
    """The program's padding of a clip (a multiple of 2^18 samples)."""
    return max(-(-n // step) * step, step)


def fingerprint_pairs(fp, row: int = 0) -> set:
    """The unique (hash, offset) pairs of the valid lanes of row ``row``
    of the program's fingerprint lanes (``Fingerprints``)."""
    valid = fp.valid[row].cpu().numpy()
    return hex_rows(*(a[row].cpu().numpy()[valid]
                      for a in (fp.hi, fp.lo, fp.ex, fp.t1)))


def recognized_clip_pairs(sia, clips: dict) -> dict:
    """{k: pairs} of the query fingerprint that ``sia.recognize_clip``
    builds for each clip of ``clips`` ({k: samples}): the entry point is
    driven once more per clip, with the fingerprint and pairing step that
    ``match.ondevice`` calls (``_fingerprint_clip``: K1-K3, SHA-1 and the
    pairing, on every path of ``recognize_clip``) wrapped to keep its
    first output. None where the entry point did not reach that step: a
    program that moves it needs this capture moved too."""
    from shazam_tpu_torch.match import ondevice

    inner = ondevice._fingerprint_clip
    seen = []

    def capture(*args, **kwargs):
        fp = inner(*args, **kwargs)
        seen.append(fp)
        return fp

    out = {}
    ondevice._fingerprint_clip = capture
    try:
        for k, clip in clips.items():
            seen.clear()
            sia.recognize_clip(clip)
            out[k] = fingerprint_pairs(seen[0]) if seen else None
    finally:
        ondevice._fingerprint_clip = inner
    return out


def prepared_batch_pairs(sia, clips: dict, batch: int, filler) -> dict:
    """{k: pairs} of the host queries that ``sia.prepare_batch``, the
    daemon's first stage, builds for each clip of ``clips`` ({k:
    samples}), sent in batches of ``batch`` as the daemon sends them (a
    last short batch filled from ``filler``)."""
    keys = sorted(clips)
    out = {}
    for i in range(0, len(keys), batch):
        part = keys[i: i + batch]
        rows = [clips[k] for k in part]
        rows += [filler[j % len(filler)] for j in range(batch - len(part))]
        pb = sia.prepare_batch(rows, pad_to_pow2=True)
        for k, q in zip(part, pb.queries):
            v = np.asarray(q.valid, bool)
            out[k] = hex_rows(q.hi[v], q.lo[v], q.ex[v], q.t[v])
    return out


def answer_gap(r: dict, ref: dict, index_of) -> tuple:
    """(1 if the song or the offset differs else 0, the widest relative gap
    of the counts, what differs) of the program's answer ``r`` against the
    reference's. The counts are the query pairs, the total matches and the
    top song's matched hashes; matched hashes flagged as lower bounds
    (``partial_counts``) gap only where they pass the reference's.
    ``index_of`` maps a song name to the reference's id."""
    res = (r or {}).get("results") or []
    if ref["song"] is None:
        return (0, 0.0, "") if r is not None and not res else \
            (1, 1.0, "answered where no row matches")
    if not res:
        return 1, 1.0, "no answer"
    top = res[0]
    got = dict(song=index_of(top["song_name"]), offset=top["offset"],
               pairs=top["input_total_hashes"], total=r["total_matches"],
               hashes_matched=top["hashes_matched_in_input"])
    want = {k: ref[k] for k in got}
    wrong = int(got["song"] != want["song"] or got["offset"] != want["offset"])
    gaps = [abs(got[k] - want[k]) / max(want[k], 1)
            for k in ("pairs", "total")]
    over = got["hashes_matched"] - want["hashes_matched"]
    if not r.get("partial_counts"):
        over = abs(over)
    gaps.append(max(over, 0) / max(want["hashes_matched"], 1))
    why = "" if got == want else \
        f"got {got} (partial {r.get('partial_counts')}), reference {want}"
    return wrong, max(gaps), why


def verdict(readings: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) of the numbers read."""
    checks = {k: {"value": v, "limit": LIMITS[k]} for k, v in readings.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
