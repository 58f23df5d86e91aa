"""A catalog operator's bulk load: batches of new songs, already on the
card, through ``SIA.ingest_device_batch`` into the configuration's store,
each batch merged.

Rendering a song costs more than ingesting it, so set-up renders a pool
of songs (ids past the catalog's) and each window batch is made from the
pool by a cheap seeded transform on the card, inside the window: two
pool songs mixed at seeded gains, the second rotated by a seeded shift,
which gives every new song rows of its own under a new name.

The store is sized for the catalog (``catalog.reserve_hashes``) and grows
under the load as the program grows it. Mix keys: ``batch``,
``pool_songs``, ``warm_batches`` (ingested in set-up), ``trace_batches``,
``compare_new`` and ``compare_songs`` (the sample the reference checks).
"""

from __future__ import annotations

import time

import numpy as np

from .. import catalog, check, common, host, refrun, trace as tracing
from ..common import Ctx, Outcome
from ..roofline import frames

SONG_PEAK_CAPACITY = 16384   # the program's default song peak capacity


def new_name(b: int, r: int, batch: int) -> str:
    return f"mix{b * batch + r:07d}"


class Mixer:
    """Window batch ``b`` of the seed: (names, (B, blen) audio)."""

    def __init__(self, pool, n_samp: int, batch: int, seed: int):
        self.pool, self.n, self.batch, self.seed = pool, n_samp, batch, seed

    def draws(self, b: int):
        rng = np.random.default_rng([self.seed, 4, b])
        p = self.pool.shape[0]
        a = rng.integers(0, p, self.batch)
        other = (a + rng.integers(1, p, self.batch)) % p
        shift = rng.integers(self.n // 8, self.n - self.n // 8, self.batch)
        ga = rng.uniform(0.6, 1.0, self.batch)
        gb = rng.uniform(0.3, 0.7, self.batch)
        return a, other, shift, ga, gb

    def song(self, b: int, r: int, draws=None):
        """Row ``r`` of window batch ``b``: (blen,) samples."""
        import torch

        a, other, shift, ga, gb = draws or self.draws(b)
        n = self.n
        out = torch.zeros_like(self.pool[0])
        out[:n] = self.pool[a[r], :n] * float(ga[r])
        out[:n].add_(torch.roll(self.pool[other[r], :n], int(shift[r])),
                     alpha=float(gb[r]))
        return out.round_().clamp_(-32768, 32767)

    def __call__(self, b: int):
        import torch

        draws = self.draws(b)
        audio = torch.stack([self.song(b, r, draws)
                             for r in range(self.batch)])
        return [new_name(b, r, self.batch) for r in range(self.batch)], audio


def pool_of(cfg: dict, gen, count: int):
    """The set-up pool: ``count`` songs with ids past the catalog's."""
    import torch

    first = cfg["songs"]
    return torch.cat([audio for _, _, audio in catalog.batches(
        cfg, gen, range(first, first + count))])


def sample_of(ctx: Ctx, first: int, count: int) -> tuple:
    """(new songs, catalog songs) the comparison reads, drawn from the
    seed: ``compare_new`` of the ``count`` window songs from number
    ``first`` on, and ``compare_songs`` of the catalog."""
    rng = np.random.default_rng([ctx.seed, 3])
    new = sorted(int(x) for x in rng.choice(
        np.arange(first, first + count), min(int(ctx.mix["compare_new"]),
                                             count), replace=False))
    old = sorted(int(x) for x in rng.choice(
        ctx.cfg["songs"], int(ctx.mix["compare_songs"]), replace=False))
    return new, old


def names_of(new, old) -> list:
    return [f"mix{x:07d}" for x in new] + [catalog.song_name(x) for x in old]


def reference_rows(cfg: dict, gen, mixer, new, old,
                   dtype: str = refrun.REFERENCE) -> dict:
    """{name: rows} of the sampled songs by the plain reference, their
    samples made again from the seed."""
    want = {}
    for x in new:
        song = mixer.song(*divmod(x, mixer.batch))[None]
        want[f"mix{x:07d}"] = refrun.rows_of(cfg, song, gen.n_samp, dtype)[0]
    for first, ids, audio in catalog.batches(cfg, gen, old):
        for x, rows in zip(ids, refrun.rows_of(cfg, audio, gen.n_samp,
                                               dtype)):
            want[catalog.song_name(x)] = rows
    return want


def compare(prog: dict, want: dict, missing: int) -> dict:
    """The readings of the ingest cell: the store's rows of each sampled
    song (``prog``, or the control's) against the reference's."""
    for x, rows in prog.items():
        if rows != want[x]:
            common.log(f"{x}: {len(rows)} rows in the store, "
                       f"{len(want[x])} in the reference, "
                       f"{len(rows - want[x])} extra, "
                       f"{len(want[x] - rows)} missing, e.g. "
                       f"{sorted(rows - want[x])[:2]} / "
                       f"{sorted(want[x] - rows)[:2]}")
    return {"store_row_gap": max(check.gap(prog[x], want[x]) for x in prog),
            "songs_missing": missing}


def timeline(t0: float, stamps: list, step: float = 5.0) -> str:
    """The window's batches by stretch of ``step`` seconds, and its
    longest batches (their number in the window and ms): whether a run
    that reads slow is slow throughout or stalled in a few batches."""
    if not stamps:
        return "timeline: no batch"
    counts = [0] * (int((stamps[-1] - t0) // step) + 1)
    for t in stamps:
        counts[int((t - t0) // step)] += 1
    gaps = np.diff(np.asarray([t0] + stamps)) * 1e3
    top = np.argsort(gaps)[::-1][:6]
    return (f"timeline: batches a {step:g} s stretch {counts}; batch ms "
            f"median {np.median(gaps):.2f}, p90 "
            f"{np.percentile(gaps, 90):.2f}; longest "
            + ", ".join(f"#{i} {gaps[i]:.1f}" for i in sorted(top)))


def run(ctx: Ctx) -> Outcome:
    mix, cfg = ctx.mix, ctx.cfg
    bsz = int(mix["batch"])
    sia, gen, rows = catalog.build(cfg, ctx.seed, ctx.device)
    mixer = Mixer(pool_of(cfg, gen, int(mix["pool_songs"])), gen.n_samp,
                  bsz, ctx.seed)
    n_valid = [gen.n_samp] * bsz

    def ingest(b: int):
        names, audio = mixer(b)
        st = sia.ingest_device_batch(names, audio, n_valid)
        lost = bsz - st["ingested"] + len(st["overflowed"])
        if lost:
            common.log(f"batch {b}: {lost} songs not ingested: {st}")
        return st, lost

    warm = int(mix["warm_batches"])
    for b in range(warm):
        ingest(b)
    common.sync(ctx.device)
    common.reset_peak(ctx.device)
    common.quiet_gc()
    setup_s = time.perf_counter() - ctx.t_start
    common.log(f"set-up: {rows} catalog rows, {warm} warm batches")

    b, merges, hashes, failed = warm, 0, 0, 0
    stamps = []
    h0 = host.snapshot()
    t0 = time.perf_counter()
    end = t0 + ctx.seconds
    while time.perf_counter() < end:
        st, lost = ingest(b)
        failed += lost
        merges += st["merges"]
        hashes += st["hashes"]
        b += 1
        stamps.append(time.perf_counter())
    common.sync(ctx.device)
    elapsed = time.perf_counter() - t0
    common.log(timeline(t0, stamps))
    peak = common.memory_peak(ctx.device)
    batches = b - warm
    audio_s = batches * bsz * gen.n_samp / ctx.fs
    common.log(f"window: {batches} batches of {bsz} in {elapsed:.3f} s, "
               f"{hashes} rows ({hashes / audio_s:.2f} a second of audio; "
               f"the catalog's {rows / (cfg['songs'] * cfg['song_s']):.2f}),"
               f" {merges} merges")
    common.log_host(ctx, h0)
    tr = None
    if ctx.trace:
        m = int(mix["trace_batches"])
        first = b
        tr = tracing.trace(lambda: [ingest(first + j) for j in range(m)],
                           units=m)
        b += m
    obs = {"trace": tr, "batches": batches, "merges": merges,
           "fp_shape": {"nvf": [frames(gen.n_samp)] * bsz,
                        "n_frames": frames(int(gen.blen)),
                        "cap": max(sia.config.peak_capacity,
                                   SONG_PEAK_CAPACITY)}}

    # the sample: new songs of the window, and catalog songs
    new, old = sample_of(ctx, warm * bsz, batches * bsz)
    names = names_of(new, old)
    ids = catalog.ids_by_name(sia)
    missing = sum(1 for x in names if x not in ids)
    expected = cfg["songs"] + b * bsz
    if len(ids) != expected:
        common.log(f"catalog holds {len(ids)} songs, {expected} ingested")
        missing += abs(expected - len(ids))
    prog = check.store_rows(sia, {x: ids.get(x, -1) for x in names})
    del sia
    common.free(ctx.device)

    t1 = time.perf_counter()
    want = reference_rows(cfg, gen, mixer, new, old)
    common.sync(ctx.device)
    common.log(f"reference: {time.perf_counter() - t1:.3f} s")
    readings = compare(prog, want, missing)
    minutes = audio_s / 60.0
    return Outcome(setup_s=setup_s, attempted=batches * bsz, failed=failed,
                   end_to_end={"ingest_audio_min_per_s": minutes / elapsed},
                   obs=obs, readings=readings, memory_peak=peak, trace=tr)
