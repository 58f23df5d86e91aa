"""Runs of the plain reference over a cell's inputs, regenerated from the
seed: never before the window has closed and the program's state is
freed, so that it sets no memory peak and takes nothing the program made.
"""

from __future__ import annotations

import torch

from ..reference.fingerprint import Fingerprinter
from ..reference.match import Catalog, match
from . import catalog

# the reference (the power in the configuration's float32) and its control
# (the power in bfloat16), both computed in float64 (reference/fingerprint.py)
PRECISIONS = {"float32": (torch.float64, torch.float32),
              "bfloat16": (torch.float64, torch.bfloat16)}
REFERENCE = "float32"


def song_index(name: str) -> int:
    """The reference's id of a catalog song name (-1: not a catalog song)."""
    return int(name[4:]) if name.startswith("song") else -1


def listen(cfg: dict, seed: int, device, clips, songs, dtypes,
           on_batch=None):
    """For each dtype name in ``dtypes``: the rows of catalog ``songs``
    ({index: {(hex, offset)}}), the pairs of ``clips`` ({k: {(hex,
    offset)}}) and their answers over the whole catalog ({k: dict}).
    ``clips`` is a dict {k: int16 samples}, or a callable that gives one
    once every batch has passed ``on_batch(first id, audio)``."""
    fps = {d: Fingerprinter(cfg["fingerprint"], *PRECISIONS[d])
           for d in dtypes}
    parts = {d: [] for d in dtypes}
    rows = {d: {} for d in dtypes}
    songs = set(int(s) for s in songs)
    gen = catalog.generator(cfg, seed, device)
    for first, ids, audio in catalog.batches(cfg, gen):
        for d, fp in fps.items():
            b, key, t1 = fp.rows(audio, gen.n_samp)
            parts[d].append((b + first, key, t1))
            for s in songs.intersection(ids):
                sel = b == s - first
                rows[d][s] = fp.hex_pairs(key[sel], t1[sel])
        if on_batch is not None:
            on_batch(first, audio)
        del audio
    if callable(clips):
        clips = clips()
    out = {}
    for d, fp in fps.items():
        cat = Catalog.concat(parts[d])
        parts[d] = None
        pairs, answers = {}, {}
        for k, clip in clips.items():
            x = torch.as_tensor(clip, device=device)[None].float()
            _, key, t1 = fp.rows(x, len(clip))
            pairs[k] = fp.hex_pairs(key, t1)
            answers[k] = match(cat, key, t1)
        out[d] = {"rows": rows[d], "pairs": pairs, "answers": answers}
        del cat
    return out


def rows_of(cfg: dict, audio, n_valid: int, dtype: str = REFERENCE):
    """[{(hex, offset)}] of each row of a (B, N) batch of songs."""
    fp = Fingerprinter(cfg["fingerprint"], *PRECISIONS[dtype])
    b, key, t1 = fp.rows(audio, n_valid)
    return [fp.hex_pairs(key[b == r], t1[b == r])
            for r in range(audio.shape[0])]
