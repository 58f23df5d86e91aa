"""Set-up of a configuration's catalog: songs rendered on the device from
the seed by the benchmark's music generator and ingested in batches
through the program's ``SIA.ingest_device_batch`` into the store the
configuration names. The same songs are rendered again by the reference
after the window, so nothing of the program reaches the reference.
"""

from __future__ import annotations

import math
import sys
import time

from . import music

# rows a second of audio that the music generator gives under the default
# fingerprint configuration (46.9-47.3 on both catalogs, PERF.md)
ROWS_PER_SECOND = 47.4


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def song_name(i: int) -> str:
    return f"song{i:05d}"


def ids_by_name(sia) -> dict:
    """{song name: catalog song id} of every fingerprinted song."""
    return {s["song_name"]: int(s["song_id"]) for s in sia.catalog.get_songs()}


def generator(cfg: dict, seed: int, device):
    """The catalog's song generator: ``gen(ids) -> (B, blen)``."""
    return music.make_music_gen(cfg["song_s"], seed=seed, device=device)


def batches(cfg: dict, gen, ids=None):
    """Yield (first id, ids, audio) over the catalog's songs (or ``ids``)
    in batches of the configuration's ``render_batch``, the songs rendered
    and ingested at once in set-up (a song does not depend on its batch)."""
    ids = list(range(cfg["songs"])) if ids is None else list(ids)
    step = cfg["render_batch"]
    for i in range(0, len(ids), step):
        part = ids[i: i + step]
        yield part[0], part, gen(part)


def reserve_hashes(cfg: dict) -> int:
    """The store's preallocated rows: the catalog's rows (songs x song
    length x the generator's rows a second) rounded up to a power of two,
    as an operator sizes the store for the catalog it holds."""
    rows = cfg["songs"] * cfg["song_s"] * ROWS_PER_SECOND
    return 1 << max(int(math.ceil(math.log2(rows))), 10)


def build(cfg: dict, seed: int, device, on_batch=None):
    """The configuration's SIA holding its catalog. ``on_batch(first id,
    audio)`` sees every rendered batch (the clip cutter). Returns (sia, the
    generator, the rows ingested)."""
    from shazam_tpu_torch.api import SIA
    from shazam_tpu_torch.config import FingerprintConfig

    store = cfg["store"]
    if store != "flat":
        raise ValueError(f"unknown store layout {store!r}")
    sia = SIA(FingerprintConfig(**cfg["fingerprint"]), device_resident=True,
              device_reserve_hashes=reserve_hashes(cfg),
              device=device)
    gen = generator(cfg, seed, device)
    rows, render_s, ingest_s = 0, 0.0, 0.0
    t = time.perf_counter()
    for first, ids, audio in batches(cfg, gen):
        sync(device)
        render_s += time.perf_counter() - t
        t = time.perf_counter()
        stats = sia.ingest_device_batch([song_name(i) for i in ids], audio,
                                        [gen.n_samp] * len(ids))
        if stats["overflowed"] or stats["ingested"] != len(ids):
            raise RuntimeError(f"set-up ingest lost songs: {stats}")
        rows += stats["hashes"]
        sync(device)
        ingest_s += time.perf_counter() - t
        if on_batch is not None:
            on_batch(first, audio)
        del audio
        t = time.perf_counter()
    print(f"set-up: render {render_s:.3f} s, ingest {ingest_s:.3f} s",
          file=sys.stderr, flush=True)
    return sia, gen, rows
