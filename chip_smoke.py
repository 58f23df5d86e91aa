#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (each raises on failure; any failure exits non-zero):

1. build: compile the hand-written kernels ``shazam_tpu_torch/csrc/*.cu``
   with nvcc (sm_90a) and load them;
2. kernels: run K1 (spectrogram), K2 (peak mask) and K3 (compaction) on
   the card at the shapes phases 3-7 give them (``_kernel_inputs``,
   ``check_stream_kernels``) --
   ingest (8, 1,572,864) samples, 767 frames, peak capacity 16384; phase
   7's device batch (16, 1,572,864) at 16384 and its retry batch, a dense
   row cycle-padded to (16, 1,572,864), at 32768; clip
   (1, 262,144), 127 frames, capacity 8192; phase 4's 15 s clip (1,
   786,432), 383 frames, capacity 8192; batches of 15 s clips, (2, 4 or
   8, 786,432) with an empty row or three and (32, 786,432), capacity
   8192; a streamed file batch of stereo int16 and float32 rows and a
   resampled 48 kHz file, (8 or 1, 1,572,864), capacity 16384; a
   resampled 10 s clip file (1, 524,288), capacity 8192; phase 6's
   streams: K1 on one device ring quantum (1, 34,816), 16 frames, and on
   the host engine's feeds of 4, 1 and 6 frames, K2 on the (1, 36,
   2,049), (1, 20, 2,049) and (1, 24, 2,049) slabs, K3 on a (1, 321, 65)
   window at capacity 8,192 -- and hold each against its plain PyTorch
   twin on the same inputs: K1 in dB, max |diff| < 1e-3 dB with exact
   zeros equal (both compute in float64; the distance of an f32 FFT from
   the twin is printed beside it, as the gap the bound has to tell
   apart); K2 and K3 bit-exact. Phase 6 also holds, on its own inputs,
   the first launch at every shape it makes (``ShapeAudit``).
   Kernel and plain times (``ms``, ``plain_ms``) are CUDA-event medians
   over back-to-back calls, host launch time included; ``device_ms`` is the
   kernel's own duration in a ``torch.profiler`` trace, the median of a
   few calls; ``bound_ms`` is the least time the card could take, the
   larger of the bytes over 3.35 TB/s and the operations over the peak
   rate of their type (K1: float64, 34 TFLOP/s; K2: float32 compares, 67
   TFLOP/s), counted from this run's inputs; ``library_ms`` is one
   PyTorch call the port never makes: for K1 ``torch.fft.rfft`` in
   float64 over frames windowed beforehand, the cuFFT core of K1's work;
   for K3 ``torch.nonzero`` of the same mask unpacked to bool (B, T,
   2049) beforehand, which reads 32 times K3's input bytes and syncs the
   host, so its ``library_device_ms`` is the number to compare. K2 has no
   such call;
3. end to end: ``SIA(device="cuda")`` ingests the catalog (2,035 seeded
   30 s synthetic songs, synthesized by a process pool, in chunks of 256)
   and ``recognize_clip`` answers seeded 5 s clips cut at frame-aligned
   offsets: every top-1 must be the source song with |offset error| <
   0.1 s, and each kernel's launch counter must have risen in this phase.
   Then ``torch.profiler`` traces the first 4 clips once more, and their
   device busy time over their unprofiled wall time gives the device's
   idle share during ``recognize_clip``. The same clips then go through
   ``recognize_samples(early_exit=True)`` (the dense vote, so under
   ``sparse_vote_threshold``: the apriori match), whose top-1 song and
   offset must equal the full match's; on each clip's query the host loop
   ``match_query_apriori``, the device variant
   ``match_query_apriori_ondevice`` (what ``SIA`` takes) and the full
   match are timed, the two variants must agree field for field and batch
   for batch, and at least one clip must exit early. K1-K3 must launch in
   this early-exit run;
4. big catalog: the same SIA ingests songs 2,035-2,713 (the reference's
   2,714-song catalog), so that n_songs x delta_range passes
   ``sparse_vote_threshold`` and recognition takes the sparse ranks.
   32 seeded 15 s clips, drawn across all 2,714 songs, must be right as
   in phase 3, with latency, peak memory and idle share measured the same
   way, and each kernel's counter must rise in this phase. The first 8
   clips then run again under each variant config (sort rank; scan rank
   with blocked expansion; pruned rank with 2 candidates; decided-first
   and bounds-first escalation on; the dense histogram), and each must
   give the default run's song, offset, total matches and input hashes,
   and its matched-hash count where both counted every row or both
   stopped at the same clamp. Last, each rank alone is timed on one
   clip's query kept on the card;
5. files and batches, on phase 4's SIA: 128 seeded 30 s songs (ids 2,714
   to 2,841) written as WAV files in a temporary directory, a third each
   stereo int16 at 44.1 kHz, mono int16 synthesized at 48 kHz (ingest
   resamples it) and mono IEEE float32, go in through
   ``ingest_directory`` (batches of 8, a merge every 200,000 hashes: at
   least 2 merges, at most 16 channels pending); a second pass must skip
   all 128. The seconds in decode, resampling and merging are printed
   beside the rest. ``recognize_file`` then answers 16 clips written as
   files (8 from the new songs in their formats, 8 of phase 4's), each
   right as in phase 3. ``recognize_batch`` sends phase 4's 32 clips in
   four batches of 8, one of 32 and one of 5 padded to 8, under the
   default and the dense config: each answer must equal
   ``recognize_samples`` on the clip alone by phase 4's rule, and be
   right. The batch dispatches at match_capacity, as the JAX package's
   does, where the solo ladder starts at the fast tier, so two answers
   decided under those two clamps are two lower bounds: each must be at
   most the count of ``recognize_samples`` with every row counted.
   Per-batch latency (p50, max) and the amortized latency per clip are
   printed, and one batched match dispatch must make as many launches
   (kernels, copies, memsets) at B = 32 as at B = 8, counted from the
   host's runtime launch calls in ``torch.profiler`` traces
   (``profiling.host_launches``). K1-K3 must launch in this phase;
6. serve and stream, on phase 5's SIA (2,842 songs): (a) an in-process
   ``RecognitionServer`` (max_batch 16, 10 ms wait) answers 64 mono 15 s
   WAV clips (phase 4's 32 and 32 new ones across all songs, 8 of them
   dense enough to overflow the batch's peak capacity, so that their
   solo retries run K1-K3 on the match thread) and 4 stereo requests
   from 8 client threads, with the pipeline on and then off: every
   answer right and equal to ``recognize_samples`` on the clip alone by
   phase 5's rule, /stats with no error, fewer batches than requests and
   a batch larger than 1; (b) /ingest of two songs, /delete of one, /save,
   a fresh SIA from the snapshot passing ``tools.fsck`` and answering
   alike, and a daemon with a token refusing /ingest without it; (c) per
   stream engine a /stream session of 2 channels and a 15 s window fed
   20 s of a stereo song, recognized right after 16 s and at the end,
   and the same chunks into an in-process ``StreamRecognizer`` whose
   windows are bit-equal to ``fingerprint_batch_fused`` of their samples,
   with no fallback once ready. K1-K3 must launch in this phase, and the
   first launch of each kernel at each distinct shape in this phase (the
   daemon's padded micro-batches, stereo requests, the retries, both
   stream engines' feeds, slabs and windows) is held against its twin on
   the same inputs, at phase 2's tolerances (``ShapeAudit``);
7. device resident, on phase 6's SIA: ``SIA(device_resident=True,
   device_reserve_hashes=2^25)`` starts from the same index
   (``DeviceIndex.from_host``) and a copy of the catalog, and
   ``ingest_device_batch`` takes 63 new seeded 30 s songs as 4 batches of
   (16, 1,572,864) rows uploaded once each: two batches merged
   (``merge_device_run``), two appended (``defer_sort``), the last song
   stereo (two rows, one name), one row 12 s of tied noise, past the peak
   capacity of 16,384, so that its 2x retry runs on the card. The store
   must equal, row for row, the index phase 6's host-backed SIA builds
   from the same songs (``ingest_arrays``, the stereo one through
   ``ingest_channels``), with equal per-song hash counts and overflow
   reports. 32 15 s clips (16 of the new songs) through ``recognize_clip``
   and a ``recognize_batch`` of 8 must give the host-backed SIA's answers
   by phase 5's rule; the clip p50 of both is printed. Then
   ``ingest_channels`` merges a host addition into the store,
   ``delete_songs`` and ``save_index`` follow, and a fresh host-backed SIA
   from the file passes ``tools.fsck`` and answers 4 clips alike. Last,
   the scale probe: the host-backed SIA's uploaded index is dropped and
   the allocator's cache emptied, then random runs (song ids past the
   catalog) grow the store to the reference's largest deployment,
   436,682,654 rows (capacity 2^29); at the start, at 2^26, 2^27 and 2^28
   rows and at 436,682,654 one sorted 1,048,576-row run is timed (CUDA
   events) through ``merge_device_run`` and, from the same state,
   ``append_run`` + ``finalize`` (rows equal), then the ``query_cols()``
   rebuild; the peak device memory is recorded, and 8 catalog clips must
   answer right and as before, their p50 printed. Its launches pass a
   ``ShapeAudit`` as phase 6's do;
8. spans, on phase 7's catalog: ``SIA(device_span_rows=2^22)`` from the
   host-backed SIA's index and a copy of its catalog ingests one device
   batch of 16 new 30 s songs (16, 1,572,864); ``save_index`` writes the
   span-wise file of the JAX package; fresh SIAs load it spanned (straight
   onto the device store, no host sort), spanned with ``stacked=True`` and
   plain (flattened on the host). Each must hold the spanned SIA's rows
   and give its answers, identical and right, to 8 15 s clips (4 of the
   new songs, 4 of phase 4's); save and load seconds are printed. K1-K3
   must launch, and their first launch at each shape passes a
   ``ShapeAudit``;
9. parallel, on phase 7's host-backed SIA (2,842 songs and more):
   ``shazam_tpu_torch/parallel`` at one rank per card, a one-rank NCCL
   group from ``make_mesh`` (its backend and size printed), in the order
   of the JAX package's ``dryrun_multichip``: ``sharded_ingest_step`` at
   phase 3's (8, 1,572,864) equal to ``fingerprint_batch_fused`` row for
   row; ``ShardedCatalog`` by-song (the default ``dense_limit_bytes`` at
   this size) and key-range (``2^30``) behind ``ShardedRecognizer``, 16
   of phase 4's clips each right and equal to ``SIA.recognize_samples``
   by phase 5's rule, both engines' clip p50 printed, one dense-histogram
   all-reduce and one candidate gather timed (CUDA events); early exit
   on 8 clips keeping the full match's top-1; an HTTP daemon over the
   recognizer answering 8 requests as the recognizer does and refusing a
   mutation, and a stream session over it right;
   ``sequence_parallel_fingerprint`` of a 30 s song equal to
   ``fingerprint_samples``; ``distributed_ingest_arrays`` of 16 new songs
   answering 8 clips right and alike after ``save_local_shards`` /
   ``load_local_shards``. K1-K3 must launch and pass a ``ShapeAudit``;
   the group is destroyed at the end;
10. recognition sweep, on a fresh ``SIA(device_resident=True)``: the
   reference's 100-record experiment (``recognizer_test.py:516-614``).
   ``audio.synth_device.make_music_gen`` renders 100 music-like 210 s
   songs on the card in batches of 16 (render seconds and songs/s
   printed), ``ingest_device_batch`` takes each batch from the card (100
   songs in the catalog, no row overflowed), and each song is written
   as a mono int16 WAV beside a seeded 60 s noise WAV into a temporary
   directory (deleted at the end). ``bench.harness.run_recognition_sweep``
   then sweeps 5 s clips of the 100 files four times: clean, AWGN at 0
   dB, the noise file at 0 dB and the acoustic channel at
   ``CALIBRATED_SEVERITY``, each printed with its accuracy, clip
   ``total_time`` p50 and mean, stage p50s and the reference's published
   figure (0.96 clean; 0.8119 at 0 dB of city traffic beside AWGN, not
   comparable). Limits: clean accuracy at least 0.95; 16 clean clips
   re-asked of ``recognize_samples`` give the sweep's song and offset;
   at least 85 % of the right answers at their start within 0.1 s, and
   every right answer's offset where ``delta_votes``, a count of the
   clip's and the whole song's matching hashes apart from the match
   path, peaks; every checkpoint wrote its five files; the final CSV has
   100 rows whose mean ``correct`` equals the summary's and the
   ``ASSK_`` file's accuracy. ``tools.plot.plot_constellation`` renders
   30 s of song 0 where matplotlib is installed (which case is printed),
   and ``utils.profiling.device_trace`` traces one clip into a Chrome
   trace holding CUDA kernel events. K1-K3 must launch and pass a
   ``ShapeAudit``.

It prints the card's name and power limit, build seconds, per-kernel
times, ingest seconds and rows, clip latencies and the idle shares, then
one JSON line of per-kernel and per-phase results and, last,
``{"ok": true, "device": {...}}``.

``--kernels-only`` stops after phase 2 and prints its results as one
JSON line. ``--k1-baseline PATH`` builds PATH, an earlier
``csrc/spectrogram.cu`` with the same C entry point, into a library of
its own and, in phase 2, holds it against K1's plain twin and times it
in turns with the current K1. ``--k2-baseline PATH`` does the same for
an earlier ``csrc/peaks.cu`` and K2 (bit-exact against its twin).
``--k3-baseline PATH`` does it for the one-block-per-song
``csrc/compact.cu`` of commit 11ffc6f, whose entry point
``shz_compact(bits, B, T, cap, times, freqs, n_peaks, stream)`` takes no
scratch (``K3_SONG_BLOCK_ARGTYPES``), through a call of its own that
allocates the outputs (bit-exact against the twin).
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import json
import multiprocessing as mp
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np

FS = 44100
HOP = 2048
CLIP_S = 5.0
# K1 and its plain twin both compute in float64 and round to f32 once, so
# they may differ only by that rounding; an f32 FFT misses this by far
K1_DB_BOUND = 1e-3
PROFILED_CLIPS = 4     # traced clips of phases 3 and 4: each trace costs seconds
BIG_SONGS = 2714       # the reference's recorded catalog size
BIG_CLIP_S = 15.0      # and its clip length
CHECKED_CLIPS = 8
BIG_VARIANTS = (
    ("sort", dict(vote_rank="sort")),
    ("scan_blocked", dict(vote_rank="scan", expand_block=128,
                          expand_block_min_capacity=0)),
    ("pruned", dict(vote_rank="pruned")),
    ("pruned_c2", dict(vote_rank="pruned",      # the certificate's fallback
                       rank_candidates=2)),
    ("decide_first", dict(bounds_probe_min_rows=1,
                          escalation_policy="decide")),
    ("bounds_first", dict(bounds_probe_min_rows=1,
                          escalation_policy="bounds")),
    ("dense", dict(sparse_vote_threshold=1 << 31)),
)
FILE_SONGS = 128       # phase 5's WAV files: songs 2,714 to 2,841
FILE_FORMATS = ("stereo", "mono 48 kHz", "float32")
FILE_BATCH = 8
FILE_MERGE_HASHES = 200_000
FILE_CLIP_S = 10.0
# phase 5's recognize_batch runs over phase 4's 32 clips, as (batch size,
# batches, pad_to_pow2): four batches of 8, one of 32, one of 5 padded to 8
BATCH_PLAN = ((8, 4, False), (32, 1, False), (5, 1, True))
BATCH_CONFIGS = (("default", {}), ("dense", dict(sparse_vote_threshold=1 << 31)))
# phase 6: 32 new 15 s clips (8 of them dense) beside phase 4's 32, sent by
# 8 client threads, plus 4 stereo requests; streams of 20 s, 15 s windows
SERVE_NEW_CLIPS = 32
DENSE_CLIPS = 8
DENSE_NOISE_S = 6.0
SERVE_THREADS = 8
SERVE_STEREO = 4
STREAM_S = 20.0
STREAM_WINDOW_S = 15.0
STREAM_FIRST_RECOGNIZE_S = 16.0
# phase 7: 4 batches of 16 rows of 30 s songs into a device store (one
# stereo song of 2 rows, one row dense enough to pass the ingest's peak
# capacity of 16,384 and fit twice it), 32 clips, then the scale probe
RESIDENT_BATCHES = 4
RESIDENT_BATCH = 16
RESIDENT_RESERVE = 1 << 25
RESIDENT_DENSE_S = 12.0
RESIDENT_CLIPS = 32
RESIDENT_BATCH_CLIPS = 8
PROBE_RUN = 1 << 20
# the reference's largest recorded deployment (SURVEY.md:326,
# fingerprints_queries.sql:3): a capacity of 2^29 rows
REFERENCE_ROWS = 436_682_654
PROBE_AT = (1 << 26, 1 << 27, 1 << 28, REFERENCE_ROWS)   # rows after the
PROBE_CHUNK = 1 << 24                                     # timed run
# phase 3's early exit: the apriori batch (the JAX package's default)
APRIORI_BATCH = 1024
# phase 8: a spanned SIA over phase 7's catalog, one device batch of new
# songs, its span-wise file loaded back three ways, 8 clips
SPAN_ROWS = 1 << 22
SPAN_SONGS = 16
SPAN_CLIPS = 8
# phase 9: the sharded path (parallel/*) at one rank per card
PARALLEL_CLIPS = 16
PARALLEL_EARLY_CLIPS = 8
PARALLEL_DAEMON_CLIPS = 8
PARALLEL_INGEST_ROWS = 8
PARALLEL_NEW_SONGS = 16
PARALLEL_NEW_CLIPS = 8
# phase 10: the reference's 100-record sweep (recognizer_test.py,
# tests_csv/shazam_results_100records_5sec*.csv): 100 music-like 210 s
# songs rendered on the card in batches of 16, 5 s clips, four sweeps
SWEEP_SONGS = 100
SWEEP_SONG_S = 210.0
SWEEP_BATCH = 16
SWEEP_CLIP_S = 5.0
SWEEP_NOISE_S = 60.0
SWEEP_RECHECK = 16
SWEEP_PLOT_S = 30.0
SWEEP_MIN_CLEAN = 0.95
# share of the clean sweep's right answers that must be at their clip's
# start within 0.1 s; the rest must sit where an independent vote count
# peaks (on this music a start often gathers few votes, and the JAX
# package's recognizer then answers the same offset elsewhere:
# tests/test_torch_music_synth.py)
SWEEP_MIN_AT_START = 0.85
# the reference's published accuracies at 5 s: clean, and at 0 dB of its
# city-traffic recording, which no sweep here reproduces (the noise file
# is seeded white noise): printed beside AWGN as a reading, not a target
SWEEP_REFERENCE = {"clean": 0.96, "awgn_0db": 0.8119, "file_0db": None}
SWEEP_REFERENCE_NOTE = {"awgn_0db": "city traffic, not comparable"}
HBM_BYTES_S = 3.35e12   # H100 SXM data sheet, at the 700 W limit
F64_FLOP_S = 34e12      # float64 outside the tensor cores
F32_FLOP_S = 67e12      # float32 outside the tensor cores
DEVICE_CALLS = 5        # profiled calls per device_ms median
KERNELS = (
    ("spectrogram_power", "shazam_tpu_torch/csrc/spectrogram.cu",
     "shazam_tpu/ops/pallas/spectrogram.py:107"),
    ("peak_mask", "shazam_tpu_torch/csrc/peaks.cu",
     "shazam_tpu/ops/pallas/peaks.py:107"),
    ("compact", "shazam_tpu_torch/csrc/compact.cu",
     "shazam_tpu/ops/pallas/compact.py:136"),
)
# the entry point of the one-block-per-song K3 (commit 11ffc6f, no
# scratch): bits, batch, n_frames, capacity, times, freqs, n_peaks (+ the
# stream)
K3_SONG_BLOCK_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p]


def _song(i: int) -> np.ndarray:
    from shazam_tpu_torch.audio import synth_song

    return synth_song(i, 30.0, seed=i)


def _event_ms(fn, calls: int = 10) -> float:
    """Device milliseconds per call over ``calls`` back-to-back calls,
    between two CUDA events (one call alone is mostly launch jitter)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def _timed_pair(kernel_fn, plain_fn, reps: int = 5):
    """Median ms per call of kernel and plain, measured in turns (plain,
    kernel, kernel, plain, ...) after one warm-up of each."""
    import torch

    kernel_fn()
    plain_fn()
    torch.cuda.synchronize()
    k, p = [], []
    for r in range(reps):
        order = ((plain_fn, p), (kernel_fn, k))
        for fn, acc in (order if r % 2 == 0 else order[::-1]):
            acc.append(_event_ms(fn))
    return float(np.median(k)), float(np.median(p))


def _device_busy_ms(fn):
    """Milliseconds in which the card ran any kernel, copy or memset that
    ``fn`` issued: the union of their intervals in a ``torch.profiler``
    trace (``profiling.device_events``: a complete one, else the one that
    lost the fewest kernel records, a lower bound then, said so in the
    output), or None when it holds no device event."""
    from shazam_tpu_torch.profiling import device_events

    events, lost = device_events(fn)
    if lost:
        print(f"  (that trace lost {lost} kernel records: the busy time "
              "below is a lower bound)", flush=True)
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return busy_us / 1e3 if spans else None


def _device_ms(fn) -> float | None:
    """Median device-busy ms of ``DEVICE_CALLS`` calls, each traced
    alone."""
    runs = [_device_busy_ms(fn) for _ in range(DEVICE_CALLS)]
    return None if None in runs else float(np.median(runs))


def _bound(nbytes: float, ops: float, op_rate: float):
    """(bound ms, "bytes" or "operations"): the larger of the two times."""
    by_bytes, by_ops = 1e3 * nbytes / HBM_BYTES_S, 1e3 * ops / op_rate
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def kernel_bounds(n: int, nvf: np.ndarray, n_frames: int, cap: int) -> dict:
    """Each kernel's bound at one shape, from its inputs and outputs, each
    read or written once; where the work depends on the data, what this
    data needs (K1 reads only samples under valid frames and transforms
    only valid frames)."""
    bsz, cells = len(nvf), len(nvf) * n_frames * 2049
    live = nvf[nvf > 0].astype(np.int64)
    k1_in = 4 * int(((live - 1) * HOP + 4096).sum())
    # per valid frame: window 4096 products, a 2048-point complex FFT at
    # the radix-2 count 5 N log2 N, and 26 flops per split pair of bins
    # (E/O, twiddle product, two |X|^2 and two scales) over 1025 pairs
    k1_ops = int(live.sum()) * (4096 + 5 * 2048 * 11 + 26 * 1025)
    mask_bytes = 4 * bsz * n_frames * 65
    return {
        # samples in, power out; float64 ops
        "spectrogram_power": _bound(k1_in + 4 * cells, k1_ops, F64_FLOP_S),
        # power in, mask words out; two separable 21-wide max passes (40
        # compares), the equality and the gate per cell, in float32
        "peak_mask": _bound(4 * cells + mask_bytes, 43 * cells, F32_FLOP_S),
        # mask words in; times, freqs (B, cap) and n_peaks out
        "compact": _bound(mask_bytes + 8 * bsz * cap + 4 * bsz, 0, F32_FLOP_S),
    }


def _modules() -> dict:
    """Each kernel's wrapper module, by kernel name."""
    from shazam_tpu_torch.ops.cuda import compact, peaks, spectrogram

    return {"spectrogram_power": spectrogram, "peak_mask": peaks,
            "compact": compact}


def _baselines(paths: dict) -> dict:
    """{kernel name: Kernel} for earlier sources {kernel name: path}, each
    with its kernel's C entry point, built into a library of its own."""
    from pathlib import Path

    from shazam_tpu_torch import _build

    out = {}
    for name, path in paths.items():
        current = _modules()[name].KERNEL
        argtypes = (K3_SONG_BLOCK_ARGTYPES if name == "compact"
                    else current.argtypes)
        lib_path = _build.BUILD_DIR / f"baseline_{name}_{Path(path).stem}.so"
        secs = _build.compile_library([Path(path).resolve()], lib_path)
        print(f"{name} baseline from {path}: built in {secs:.3f} s",
              flush=True)
        out[name] = _build.Kernel(
            f"{name} (baseline)", current.symbol, argtypes,
            loader=lambda lib_path=lib_path: ctypes.CDLL(str(lib_path)))
    return out


def _k3_song_block(kernel, bits, cap):
    """The one-block-per-song K3 (``K3_SONG_BLOCK_ARGTYPES``) on fresh
    outputs."""
    import torch

    bsz, n_frames, _ = bits.shape
    times = torch.empty((bsz, cap), dtype=torch.int32, device=bits.device)
    freqs = torch.empty_like(times)
    n_peaks = torch.empty((bsz,), dtype=torch.int32, device=bits.device)
    kernel(bits.data_ptr(), bsz, n_frames, cap, times.data_ptr(),
           freqs.data_ptr(), n_peaks.data_ptr())
    return times, freqs, n_peaks


def _wrappers() -> dict:
    return {name: mod.KERNEL for name, mod in _modules().items()}


def _card_view(ptr: int, shape: tuple, typestr: str):
    """A torch tensor over ``shape`` elements of ``typestr`` at the raw
    device pointer ``ptr`` (through ``__cuda_array_interface__``)."""
    import torch

    if not int(np.prod(shape)):
        return torch.empty(shape, dtype=torch.float32 if typestr == "<f4"
                           else torch.int32, device="cuda")

    class View:
        __cuda_array_interface__ = {"shape": tuple(shape), "typestr": typestr,
                                    "data": (ptr, False), "strides": None,
                                    "version": 2}

    return torch.as_tensor(View())


def _launch_arrays(name: str, a: tuple):
    """(shape key, inputs, outputs, scalars) of one launch of kernel
    ``name`` from its C arguments ``a`` (the wrappers' ``KERNEL`` calls),
    each array as (pointer, shape, typestr)."""
    if name == "spectrogram_power":   # samples, N, nvf, B, T, hop, ..., out
        n, bsz, t = a[1], a[3], a[4]
        return ((bsz, n), [(a[0], (bsz, n), "<f4"), (a[2], (bsz,), "<i4")],
                [(a[10], (bsz, t, 2049), "<f4")],
                {"hop": a[5], "scales": (a[8], a[9])})
    if name == "peak_mask":            # power, B, T, threshold, bits
        bsz, t = a[1], a[2]
        return ((bsz, t), [(a[0], (bsz, t, 2049), "<f4")],
                [(a[4], (bsz, t, 65), "<i4")], {"threshold": a[3]})
    bsz, t, cap = a[1], a[2], a[3]    # bits, B, T, cap, times, freqs, n
    return ((bsz, t, cap), [(a[0], (bsz, t, 65), "<i4")],
            [(a[4], (bsz, cap), "<i4"), (a[5], (bsz, cap), "<i4"),
             (a[6], (bsz,), "<i4")], {})


class ShapeAudit:
    """Holds each kernel's first launch at every distinct shape a phase
    gives it against the kernel's plain twin on the same inputs.

    While entered it stands in for each wrapper module's ``KERNEL``, so
    every launch of the phase, from any thread, passes through it. At a
    shape's first launch it copies the inputs and, once launched, the
    outputs (on the launching thread's stream, in order with the kernel);
    :meth:`check` runs the twins on the copies. It launches no kernel of
    its own, so the launch counters count only the phase."""

    def __init__(self, config):
        self.config = config
        self.first: dict = {}   # (kernel, shape) -> (inputs, outputs, scalars)
        self.lock = threading.Lock()
        self.kernels: dict = {}

    def __enter__(self):
        for name, mod in _modules().items():
            self.kernels[name] = mod.KERNEL
            mod.KERNEL = functools.partial(self._launch, name, mod.KERNEL)
        return self

    def __exit__(self, *exc):
        for name, mod in _modules().items():
            mod.KERNEL = self.kernels[name]

    def _launch(self, name, kernel, *args, stream=None):
        if len(args) != len(kernel.argtypes):
            raise AssertionError(f"{name}: {len(args)} arguments, the C "
                                 f"entry point takes {len(kernel.argtypes)}")
        key, ins, outs, scalars = _launch_arrays(name, args)
        with self.lock:
            first = (name, key) not in self.first
            if first:
                self.first[name, key] = None
        if first:
            ins = [_card_view(*a).clone() for a in ins]
        kernel(*args, stream=stream)
        if first:
            outs = [_card_view(*a).clone() for a in outs]
            with self.lock:
                self.first[name, key] = (ins, outs, scalars)

    def check(self) -> dict:
        """Each recorded launch against its twin; raises on a difference.
        Returns {kernel name: [[shape, max err], ...]} (K1's in dB)."""
        import torch

        from shazam_tpu_torch.ops.peaks import (compact_plain,
                                                peak_mask_plain,
                                                power_threshold)
        from shazam_tpu_torch.ops.spectrogram import (db_spectrogram,
                                                      psd_scales,
                                                      spectrogram_power_plain)

        cfg = self.config
        out = {name: [] for name in _modules()}
        for (name, key), rec in sorted(self.first.items()):
            if rec is None:
                raise AssertionError(f"{name} at {key}: the launch failed")
            ins, (got, *more), scalars = rec
            if name == "spectrogram_power":
                if scalars["scales"] != psd_scales(4096, cfg.sample_rate):
                    raise AssertionError(f"K1 at {key}: PSD scales differ")
                want = spectrogram_power_plain(*ins, fs=cfg.sample_rate,
                                               hop=scalars["hop"])
                err = float((db_spectrogram(got) - db_spectrogram(want))
                            .abs().max()) if got.numel() else 0.0
                ok = err < K1_DB_BOUND and torch.equal(got == 0, want == 0)
            elif name == "peak_mask":
                if scalars["threshold"] != power_threshold(cfg.amp_min):
                    raise AssertionError(f"K2 at {key}: gate differs")
                err = int((got != peak_mask_plain(ins[0], cfg.amp_min)).sum())
                ok = err == 0
            else:
                want = compact_plain(ins[0], key[2])
                err = max(int((a.long() - b.long()).abs().max())
                          for a, b in zip((got, *more), want))
                ok = err == 0
            if not ok:
                raise AssertionError(f"{name} at {key}: its first launch "
                                     f"differs from the plain twin ({err})")
            out[name].append([list(key), err])
        return out


def _kernel_inputs():
    """Phase 2's inputs, [(label, rows, peak capacity)], each padded to its
    bucket as the main path pads it: phase 3's ingest (8 x 30 s songs),
    phase 7's device batch (16 x 30 s) and its retry batch (a dense row
    cycle-padded to 16 rows, at twice the capacity), phase 3's 5 s clip, phase 4's 15 s clip, phase 6's daemon micro-batches of
    15 s clips padded to 2 and 4 rows with an empty row (pad_to_pow2; a
    stereo request has the 2-row shape), and phase 5's shapes --
    recognize_batch's 5 clips padded with 3 empty rows and its 32 clips,
    a streamed file batch of stereo int16 and float32 rows, a resampled
    48 kHz file, and a resampled 10 s clip file as recognize_file reads
    them."""
    import tempfile

    from shazam_tpu_torch.audio import read, synth_song
    from shazam_tpu_torch.audio.resample import resample_channels

    songs = [synth_song(i, 30.0, seed=i) for i in range(16)]
    clips = [synth_song(i, BIG_CLIP_S, seed=i) for i in range(32)]
    dense = _dense(songs[5], np.random.default_rng(0), RESIDENT_DENSE_S)
    with tempfile.TemporaryDirectory() as tmp:
        def decoded(i, secs=30.0):
            samples, fs, kind = _file_song(i)
            path = os.path.join(tmp, f"{i}_{secs}.wav")
            _write_file(path, samples[: int(secs * fs)], fs, kind)
            channels, fs, _ = read(path)
            return (resample_channels(channels, fs, FS) if fs != FS
                    else channels)

        # songs 0, 3, 6 are stereo, 2 and 5 float32: 8 rows at 44.1 kHz
        streamed = [ch for i in (0, 2, 3, 5, 6) for ch in decoded(i)]
        resampled, file_clip = decoded(1), decoded(4, FILE_CLIP_S)
    return (("ingest", songs[:8], 16384),
            ("resident_batch", songs, 16384),
            ("resident_retry", [dense] * RESIDENT_BATCH, 32768),
            ("clip", [synth_song(0, CLIP_S, seed=0)], 8192),
            ("big_clip", clips[:1], 8192),
            ("batch_2_padded", clips[:1] + [np.zeros(0, np.int16)], 8192),
            ("batch_4_padded", clips[:3] + [np.zeros(0, np.int16)], 8192),
            ("batch_8_padded", clips[:5] + [np.zeros(0, np.int16)] * 3, 8192),
            ("batch_32", clips, 8192),
            ("file_batch", streamed, 16384),
            ("file_resampled", resampled, 16384),
            ("file_clip", file_clip, 8192))


def _measure(name, label, kfn, pfn, err, lib_fn, bound) -> dict:
    """One kernel at one shape, timed against its plain twin (and the
    library call, where there is one); printed and returned."""
    ms, plain_ms = _timed_pair(kfn, pfn)
    bound_ms, bound_by = bound
    rec = {"ms": ms, "plain_ms": plain_ms, "device_ms": _device_ms(kfn),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": None, "library_device_ms": None, "err": err}
    if lib_fn is not None:
        lib_fn()
        rec["library_ms"] = float(np.median(
            [_event_ms(lib_fn) for _ in range(5)]))
        rec["library_device_ms"] = _device_ms(lib_fn)
    print(f"kernel {name} {label}: {ms:.4f} ms, "
          f"device {rec['device_ms']} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}), plain {plain_ms:.4f} ms, library "
          f"{rec['library_ms']} ms (device "
          f"{rec['library_device_ms']}), max_abs_err {err}"
          + (" dB" if name == "spectrogram_power" else ""), flush=True)
    return rec


def check_stream_kernels(device, out: dict) -> None:
    """Phase 2 at phase 6's stream shapes, which are not padded batches:
    K1 on one device ring quantum, (1, 34,816) samples with 16 valid
    frames, and on the host engine's feeds (``stream.IncrementalFingerprinter``
    runs K1 on each feed's new frames: 4 per CHUNK once a hop of residual
    is carried, 1 and 6 after the odd feeds of 3,001 and 12,345 samples);
    K2 on the device engine's settle and right-strip slab (1, 36, 2,049),
    the left-strip and host edge-strip slab (1, 20, 2,049) and the host
    engine's settle slab of one CHUNK, 4 + 2 radius rows (1, 24, 2,049);
    K3 on a 15 s window's mask (1, 321, 65) at capacity 8,192. Each is
    held against its twin as in ``check_kernels`` and timed beside the
    other shapes."""
    import torch

    from shazam_tpu_torch.ops.cuda import compact as k3
    from shazam_tpu_torch.ops.cuda import peaks as k2
    from shazam_tpu_torch.ops.cuda import spectrogram as k1
    from shazam_tpu_torch.ops.peaks import (compact_plain, peak_mask_plain,
                                            unpack_mask_bits)
    from shazam_tpu_torch.ops.spectrogram import (db_spectrogram, hann_window,
                                                  spectrogram_power_plain)
    from shazam_tpu_torch.stream_device import FRAME_STEP

    song = _song(7).astype(np.float32)
    for label, n_frames in (("stream_quantum", FRAME_STEP),
                            ("host_feed_4", 4), ("host_feed_1", 1),
                            ("host_feed_6", 6)):
        block = (n_frames - 1) * HOP + 4096
        x = torch.from_numpy(song[HOP * 160: HOP * 160 + block]).to(device)[None]
        nv = torch.tensor([n_frames], dtype=torch.int32, device=device)
        power = k1.spectrogram_power(x, nv)
        power_p = spectrogram_power_plain(x, nv)
        err = float((db_spectrogram(power) - db_spectrogram(power_p)).abs().max())
        if not (err < K1_DB_BOUND and torch.equal(power == 0, power_p == 0)):
            raise AssertionError(f"K1 {label}: max|ddB| {err}")
        frames = (x.unfold(1, 4096, HOP).to(torch.float64)
                  * hann_window(4096, device))
        out["spectrogram_power"][label] = _measure(
            "spectrogram_power", f"{label} (1, {block})",
            lambda x=x, nv=nv: k1.spectrogram_power(x, nv),
            lambda x=x, nv=nv: spectrogram_power_plain(x, nv), err,
            lambda frames=frames: torch.fft.rfft(frames, dim=-1),
            kernel_bounds(block, np.array([n_frames]), n_frames,
                          1)["spectrogram_power"])

    # a 15 s window's power (321 frames), and slabs cut from it
    win = int(BIG_CLIP_S * FS)
    n_win = (win - 4096) // HOP + 1
    xw = torch.from_numpy(song[: win]).to(device)[None]
    pw = k1.spectrogram_power(
        xw, torch.tensor([n_win], dtype=torch.int32, device=device))
    for label, rows in (("stream_slab_36", 36), ("stream_slab_20", 20),
                        ("host_slab_24", 24)):
        slab = pw[:, 100: 100 + rows].contiguous()
        bits, want = k2.peak_mask(slab, 10.0), peak_mask_plain(slab, 10.0)
        bad = int((bits != want).sum())
        if bad:
            raise AssertionError(f"K2 {label}: {bad} mask words differ")
        out["peak_mask"][label] = _measure(
            "peak_mask", f"{label} {tuple(slab.shape)}",
            lambda slab=slab: k2.peak_mask(slab, 10.0),
            lambda slab=slab: peak_mask_plain(slab, 10.0), bad, None,
            kernel_bounds(0, np.array([rows]), rows, 1)["peak_mask"])
    bits = k2.peak_mask(pw, 10.0)
    cap = 8192
    got, want = k3.compact(bits, cap), compact_plain(bits, cap)
    bad = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
    if bad:
        raise AssertionError("K3 stream_window: (times, freqs, n_peaks) differ")
    mask = unpack_mask_bits(bits)
    out["compact"]["stream_window"] = _measure(
        "compact", f"stream_window {tuple(bits.shape)}",
        lambda: k3.compact(bits, cap), lambda: compact_plain(bits, cap), bad,
        lambda: torch.nonzero(mask),
        kernel_bounds(0, np.array([n_win]), n_win, cap)["compact"])


def check_kernels(device, baselines=None) -> dict:
    """Phase 2: each kernel against its plain twin at every main-path
    shape; each of ``baselines`` ({kernel name: Kernel}, an earlier K1, K2
    or K3) is held against the same twin and timed in turns with the
    current kernel."""
    import torch

    from shazam_tpu_torch.api import _bucket_len, _pad_rows
    from shazam_tpu_torch.ops.cuda import compact as k3
    from shazam_tpu_torch.ops.cuda import peaks as k2
    from shazam_tpu_torch.ops.cuda import spectrogram as k1
    from shazam_tpu_torch.ops.peaks import (compact_plain, peak_mask_plain,
                                            unpack_mask_bits)
    from shazam_tpu_torch.ops.spectrogram import (db_spectrogram, hann_window,
                                                  spectrogram_power_plain,
                                                  valid_frames)

    out = {name: {} for name, _, _ in KERNELS}
    for label, rows, cap in _kernel_inputs():
        batch, n_valid = _pad_rows(rows, _bucket_len(max(map(len, rows))))
        n = batch.shape[1]
        xs = torch.from_numpy(batch).to(device).to(torch.float32)
        nvf = valid_frames(torch.from_numpy(n_valid), 4096, HOP).numpy()
        nv = torch.from_numpy(nvf).to(device)

        power = k1.spectrogram_power(xs, nv)
        power_p = spectrogram_power_plain(xs, nv)
        power_f32 = spectrogram_power_plain(xs, nv,
                                            compute_dtype=torch.float32)
        torch.cuda.synchronize()
        if not torch.isfinite(power).all():
            raise AssertionError(f"K1 {label}: non-finite power")
        db_p = db_spectrogram(power_p)

        def k1_err(power, who="K1"):
            err = float((db_spectrogram(power) - db_p).abs().max())
            if not (err < K1_DB_BOUND and torch.equal(power == 0, power_p == 0)):
                raise AssertionError(
                    f"{who} {label}: max|ddB| {err} (bound {K1_DB_BOUND}) or "
                    "exact zeros differ")
            return err

        k1_e = k1_err(power)
        f32_err = float((db_spectrogram(power_f32) - db_p).abs().max())
        del power_f32

        bits = k2.peak_mask(power, 10.0)
        bits_p = peak_mask_plain(power, 10.0)
        torch.cuda.synchronize()

        def k2_err(bits, who="K2"):
            err = int((bits != bits_p).sum())
            if err:
                raise AssertionError(f"{who} {label}: {err} mask words differ")
            return err

        k2_e = k2_err(bits)

        got = k3.compact(bits, cap)
        ref = compact_plain(bits, cap)
        torch.cuda.synchronize()

        def k3_err(got, who="K3"):
            err = max(int((a.long() - b.long()).abs().max())
                      for a, b in zip(got, ref))
            if err:
                raise AssertionError(
                    f"{who} {label}: (times, freqs, n_peaks) differ")
            return err

        k3_e = k3_err(got)
        if int(got[2].max()) > cap:
            raise AssertionError(f"K3 {label}: peak capacity {cap} overflowed")

        # the library yardsticks (the port never calls them): cuFFT's
        # float64 rfft of every frame, windowed beforehand; torch.nonzero
        # of the mask, unpacked to bool beforehand
        n_frames = power.shape[1]
        win = hann_window(4096, device)
        frames = xs[:, : (n_frames - 1) * HOP + 4096].unfold(1, 4096, HOP)
        frames = frames.to(torch.float64) * win
        mask = unpack_mask_bits(bits)

        bounds = kernel_bounds(n, nvf, n_frames, cap)
        timings = (
            ("spectrogram_power", lambda: k1.spectrogram_power(xs, nv),
             lambda: spectrogram_power_plain(xs, nv), k1_e,
             lambda: torch.fft.rfft(frames, dim=-1)),
            ("peak_mask", lambda: k2.peak_mask(power, 10.0),
             lambda: peak_mask_plain(power, 10.0), k2_e, None),
            ("compact", lambda: k3.compact(bits, cap),
             lambda: compact_plain(bits, cap), k3_e,
             lambda: torch.nonzero(mask)),
        )
        for name, kfn, pfn, e, lib_fn in timings:
            out[name][label] = _measure(name, f"{label} {tuple(batch.shape)}",
                                        kfn, pfn, e, lib_fn, bounds[name])
        del frames, mask
        checks = {"spectrogram_power": (k1, k1_err, " dB"),
                  "peak_mask": (k2, k2_err, ""),
                  "compact": (k3, k3_err, "")}
        calls = {name: kfn for name, kfn, *_ in timings}
        for name, kernel in (baselines or {}).items():
            mod, check, unit = checks[name]
            current, call = mod.KERNEL, calls[name]
            if name == "compact":   # its entry point takes no scratch
                def baseline(kernel=kernel):
                    return _k3_song_block(kernel, bits, cap)
            else:
                def baseline(mod=mod, kernel=kernel, current=current,
                             call=call):
                    mod.KERNEL = kernel
                    try:
                        return call()
                    finally:
                        mod.KERNEL = current

            err = check(baseline(), f"{name} baseline")
            ms, base_ms = _timed_pair(call, baseline)
            rec = {"ms": base_ms, "device_ms": _device_ms(baseline),
                   "err": err, "current_ms": ms,
                   "current_device_ms": _device_ms(call)}
            out.setdefault(f"{name}_baseline", {})[label] = rec
            print(f"{name} baseline {label}: {base_ms:.4f} ms, device "
                  f"{rec['device_ms']} ms, max_abs_err {err}{unit}; current "
                  f"{ms:.4f} ms in turns, device {rec['current_device_ms']} "
                  "ms", flush=True)
        print(f"K1 {label}: max|ddB| {k1_e:.3g} (bound {K1_DB_BOUND}); an "
              f"f32 torch.fft.rfft is {f32_err:.6f} dB from the same float64 "
              f"twin; n_peaks {got[2].tolist()}", flush=True)
    check_stream_kernels(device, out)
    return out


def _ingest_songs(sia, ids, keep, workers):
    """Synthesize songs ``ids`` in a process pool and ingest them in chunks
    of 256; songs in ``keep`` are synthesized too (ingested only if in
    ``ids``) and returned. Returns (sources, hashes, seconds inside
    SIA.ingest_arrays, wall seconds with synthesis)."""
    sources = {}
    ingest = set(ids)
    jobs = list(ids) + sorted(set(keep) - ingest)
    t0 = time.perf_counter()
    hashes = 0
    sia_s = 0.0  # inside SIA.ingest_arrays; the rest is waiting on synthesis
    ctx = mp.get_context("spawn")
    with ctx.Pool(workers) as pool:
        chunk = []
        for n, (i, song) in enumerate(zip(jobs, pool.imap(_song, jobs,
                                                           chunksize=4))):
            if i in keep:
                sources[i] = song
            if i in ingest:
                chunk.append((f"song{i:05d}", song))
            if chunk and (len(chunk) == 256 or n == len(jobs) - 1):
                stats = sia.ingest_arrays(chunk)
                hashes += stats["hashes"]
                sia_s += stats["seconds"]
                chunk = []
        pool.close()
        pool.join()
    return sources, hashes, sia_s, time.perf_counter() - t0


def _recognize_all(sia, picks, clip_of):
    """recognize_clip on every (song, frame) pick; returns (results,
    latencies in s, wrong picks). Right = top-1 is the source song at
    |offset error| < 0.1 s."""
    results, lat, wrong = [], [], []
    for sid, frame in picks:
        c = clip_of(sid, frame)
        t = time.perf_counter()
        res = sia.recognize_clip(c)
        lat.append(time.perf_counter() - t)
        results.append(res)
        top = res["results"][0] if res["results"] else None
        if (top is None or top["song_name"] != f"song{sid:05d}"
                or abs(top["offset_seconds"] - frame * HOP / FS) >= 0.1):
            wrong.append((sid, frame, top))
    return results, lat, wrong


def _idle_share(sia, picks, clip_of, lat, on_card, label):
    """Device busy time of the first clips, traced, over the host wall time
    the same clips took unprofiled: (busy ms per clip, idle share), both
    None off the card."""
    traced = picks[:PROFILED_CLIPS]
    busy_ms = idle = None
    if on_card:
        busy_ms = _device_busy_ms(
            lambda: [sia.recognize_clip(clip_of(*p)) for p in traced])
    wall_ms = 1e3 * sum(lat[: len(traced)])
    if busy_ms is None:
        print(f"{label} device busy: not measured", flush=True)
        return None, None
    idle = 1.0 - busy_ms / wall_ms
    print(f"{label} device busy {busy_ms / len(traced):.3f} ms per clip "
          f"(torch.profiler, {len(traced)} clips) over "
          f"{wall_ms / len(traced):.3f} ms unprofiled wall: idle share "
          f"{idle:.4f}", flush=True)
    return busy_ms / len(traced), idle


def end_to_end(device, n_songs: int, n_clips: int, seed: int,
               workers: int):
    """Phase 3: ingest the synthetic catalog, recognize seeded clips.
    Returns (the SIA, [(song, frame, clip)], a report dict)."""
    import torch

    from shazam_tpu_torch.api import SIA

    rng = np.random.default_rng(seed)
    clip_len = int(CLIP_S * FS)
    max_frame = (int(30.0 * FS) - clip_len) // HOP
    picks = [(int(rng.integers(n_songs)), int(rng.integers(0, max_frame + 1)))
             for _ in range(n_clips)]

    sia = SIA(device=device)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    sources, hashes, sia_s, ingest_s = _ingest_songs(
        sia, range(n_songs), {sid for sid, _ in picks}, workers)
    rows = sia.index.n_hashes
    counts = sia.catalog.counts()
    if not (rows == hashes == counts["n_hashes"]
            and counts["n_songs"] == n_songs):
        raise AssertionError(f"index rows {rows}, ingested hashes {hashes}, "
                             f"catalog {counts}")
    print(f"ingest: {n_songs} songs x 30 s, {rows} rows, wall {ingest_s:.3f} s "
          f"with synthesis, {sia_s:.3f} s in SIA.ingest_arrays "
          f"({n_songs * 0.5 / sia_s:.3f} audio-min/s)", flush=True)

    def clip_of(sid, frame):
        return sources[sid][frame * HOP: frame * HOP + clip_len]

    sia.recognize_clip(clip_of(*picks[0]))  # uploads the device index
    _results, lat, wrong = _recognize_all(sia, picks, clip_of)
    print(f"recognize_clip: {n_clips} clips of {CLIP_S} s, p50 "
          f"{1e3 * float(np.median(lat)):.3f} ms, max "
          f"{1e3 * max(lat):.3f} ms, wrong {len(wrong)}", flush=True)
    if wrong:
        raise AssertionError(f"wrong top-1: {wrong[:5]}")
    peak_mib = (torch.cuda.max_memory_allocated() / 2**20 if on_card
                else None)
    print(f"peak device memory allocated: {peak_mib} MiB", flush=True)
    busy, idle = _idle_share(sia, picks, clip_of, lat, on_card,
                             "recognize_clip")
    clips = [(sid, frame, clip_of(sid, frame)) for sid, frame in picks]
    return sia, clips, {
        "songs": n_songs, "rows": rows, "ingest_wall_s": ingest_s,
        "ingest_s": sia_s, "clip_p50_ms": 1e3 * float(np.median(lat)),
        "clip_max_ms": 1e3 * max(lat), "peak_device_mib": peak_mib,
        "clip_device_busy_ms": busy, "clip_idle_share": idle}


def _timed_call(fn, device):
    """(fn's result, wall ms of fn ending in a device synchronize) after one
    untimed warm-up call: the match half is launch-bound, so the host's
    launch time is part of what it costs."""
    fn()
    _sync(device)
    t = time.perf_counter()
    out = fn()
    _sync(device)
    return out, 1e3 * (time.perf_counter() - t)


def early_exit(sia, clips) -> dict:
    """Phase 3's clips again with ``recognize_samples(early_exit=True)``:
    the top-1 song and offset must equal the full match's and be right.
    Then the match half alone on each clip's prepared query: the host loop
    (``match_query_apriori``, a read-back per batch), the device variant
    (``match_query_apriori_ondevice``, the flag read at batches 1, 2, 4,
    ...; what ``SIA`` routes to) and the full match (``_match_prepared``),
    each timed; the two apriori variants must agree field for field and
    batch for batch, and at least one clip must exit early."""
    from shazam_tpu_torch.match.apriori import (match_query_apriori,
                                                match_query_apriori_ondevice)
    from shazam_tpu_torch.match.prepare import prepare_query

    dev = sia.device
    index = sia._ensure_device_index()
    ms = {"early_exit_samples": [], "full_samples": [], "host_loop": [],
          "device": [], "full": []}
    used = total = exits = 0
    for sid, frame, c in clips:
        full, ms_full = _timed_call(lambda: sia.recognize_samples([c]), dev)
        fast, ms_fast = _timed_call(
            lambda: sia.recognize_samples([c], early_exit=True), dev)
        a, b = _answer(full), _answer(fast)
        if ((a["song_id"], a["offset"]) != (b["song_id"], b["offset"])
                or not _right(fast, sid, frame * HOP / FS)):
            raise AssertionError(f"early exit on the clip of {sid}: {b}, "
                                 f"the full match {a}")
        ms["full_samples"].append(ms_full)
        ms["early_exit_samples"].append(ms_fast)
        q = prepare_query([sia._fingerprint_channel(c)])
        delta_min, delta_range = sia._delta_params_for(len(c))
        kw = dict(n_songs=sia._n_songs(), delta_min=delta_min,
                  delta_range=delta_range,
                  match_capacity=sia.config.match_capacity,
                  topn=sia.config.topn, batch_size=APRIORI_BATCH)
        host, ms_host = _timed_call(lambda: match_query_apriori(index, q, **kw),
                                    dev)
        on_dev, ms_dev = _timed_call(
            lambda: match_query_apriori_ondevice(index, q, **kw), dev)
        _, ms_match = _timed_call(
            lambda: sia._match_prepared(q, n_samples=len(c)), dev)
        if host[1:] != on_dev[1:] or not all(
                np.array_equal(np.asarray(x), np.asarray(y))
                for x, y in zip(host[0], on_dev[0])):
            raise AssertionError(f"apriori variants differ on the clip of "
                                 f"{sid}: {host} {on_dev}")
        ms["host_loop"].append(ms_host)
        ms["device"].append(ms_dev)
        ms["full"].append(ms_match)
        n_batches = -(-q.n_pairs // APRIORI_BATCH)
        used += on_dev[1]
        total += n_batches
        exits += on_dev[1] < n_batches
    p50 = {k: float(np.median(v)) for k, v in ms.items()}
    print(f"early exit: {len(clips)} clips of {CLIP_S} s, top-1 equal to the "
          f"full match; batches used {used} of {total}, {exits} clips exited "
          f"early; p50 ms: recognize_samples early exit "
          f"{p50['early_exit_samples']:.3f} / full "
          f"{p50['full_samples']:.3f}; match half: host loop "
          f"{p50['host_loop']:.3f}, device variant {p50['device']:.3f}, full "
          f"match {p50['full']:.3f}", flush=True)
    if not exits:
        raise AssertionError("no clip exited early")
    return {"clips": len(clips), "batches_used": used, "batches": total,
            "early_exits": exits, "p50_ms": p50}


def _answer(res):
    top = res["results"][0] if res["results"] else {}
    return {"song_id": top.get("song_id"), "offset": top.get("offset"),
            "matched": top.get("hashes_matched_in_input"),
            "partial": res["partial_counts"],
            "total_matches": res["total_matches"],
            "input_hashes": res["input_hashes"]}


def _same_answer(want, got, exact=None) -> bool:
    """Song, offset, total matches and input hashes equal, and the
    matched hash count where both runs counted every row or both accepted
    a clamped expansion as provably decided (partial_counts: a variant
    that decides at the default's fast tier with its row-by-row expansion
    excludes the same runs). A decided run against an exact one reports
    a lower bound, which may not exceed the exact count. Two decided runs
    clamped at different tiers (phase 5: the batch dispatches at
    match_capacity, the solo ladder starts at the fast tier) report two
    lower bounds, each at most the count of ``exact``, a run that counted
    every row."""
    keys = ("song_id", "offset", "total_matches", "input_hashes")
    if any(want[k] != got[k] for k in keys):
        return False
    if want["partial"] != got["partial"]:
        lower, exact = ((want, got) if want["partial"] else (got, want))
        return lower["matched"] <= exact["matched"]
    if want["partial"] and exact is not None:
        return (not exact["partial"]
                and max(want["matched"], got["matched"]) <= exact["matched"])
    return want["matched"] == got["matched"]


def _match_half(sia, clip, on_card) -> dict:
    """The match half alone at this catalog size: each rank on one clip's
    query, fingerprinted once and kept on the card. Per call: CUDA-event
    ms over 10 back-to-back calls (host enqueue included, since the path
    is launch-bound) and the device-busy ms of a profiled call."""
    from shazam_tpu_torch.match.lookup import match_by_rank
    from shazam_tpu_torch.match.ondevice import fingerprint_probe_on_device

    index = sia._ensure_device_index()
    x, nv = sia._to_device(clip)
    q, *_ = fingerprint_probe_on_device(x, nv, index, **sia._fp_kwargs(),
                                        query_capacity=4096)
    delta_min, delta_range = sia._delta_params_for(len(clip))
    kw = dict(n_songs=sia.index.n_songs, delta_min=delta_min,
              delta_range=delta_range, topn=sia.config.topn)
    fast = sia.config.match_capacity_fast
    paths = {f"{rank} {fast}": dict(rank=rank, match_capacity=fast,
                                    n_candidates=256)
             for rank in ("pruned", "sort", "scan", "dense")}
    paths["scan blocked 65536"] = dict(rank="scan", match_capacity=65536,
                                       expand_block=128, expand_runs=1024)
    out = {}
    for name, kw_rank in paths.items():
        def fn(kw_rank=kw_rank):
            return match_by_rank(index, *q, **kw_rank, **kw)

        fn()
        if not on_card:
            print(f"match half {name}: not measured", flush=True)
            continue
        ms = _event_ms(fn)
        busy = _device_busy_ms(fn)
        out[name] = {"ms": ms, "device_busy_ms": busy}
        print(f"match half {name}: {ms:.4f} ms per call (CUDA events), "
              f"device busy {busy} ms", flush=True)
    return out


def big_catalog(sia, n_base: int, n_total: int, n_clips: int, n_check: int,
                seed: int, workers: int) -> dict:
    """Phase 4: grow the phase-3 catalog to ``n_total`` songs, past
    ``sparse_vote_threshold``, and recognize seeded BIG_CLIP_S clips
    through the sparse ranks; then re-run the first ``n_check`` clips
    under each rank / expansion / escalation variant and require the
    default run's answers. Returns ([(song, frame, clip)], a report)."""
    import dataclasses

    import torch

    rng = np.random.default_rng(seed + 1)
    clip_len = int(BIG_CLIP_S * FS)
    max_frame = (int(30.0 * FS) - clip_len) // HOP
    picks = [(int(rng.integers(n_total)), int(rng.integers(0, max_frame + 1)))
             for _ in range(n_clips)]

    on_card = sia.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    sources, hashes, sia_s, ingest_s = _ingest_songs(
        sia, range(n_base, n_total), {sid for sid, _ in picks}, workers)
    rows = sia.index.n_hashes
    counts = sia.catalog.counts()
    if counts["n_songs"] != n_total or counts["n_hashes"] != rows:
        raise AssertionError(f"catalog {counts}, index rows {rows}")
    index = sia._ensure_device_index()
    index_mb = sum(t.numel() * t.element_size()
                   for t in (index.key64, index.key_sub, index.payload)) / 1e6
    _, delta_range = sia._delta_params_for(clip_len)
    bins = sia.index.n_songs * delta_range
    threshold = sia.config.sparse_vote_threshold
    print(f"big catalog: +{n_total - n_base} songs ({hashes} hashes) to "
          f"{n_total} songs, {rows} rows, {index_mb:.1f} MB device index, "
          f"wall {ingest_s:.3f} s with synthesis, {sia_s:.3f} s in "
          f"SIA.ingest_arrays; vote bins {sia.index.n_songs} x "
          f"{delta_range} = {bins} > sparse_vote_threshold {threshold}",
          flush=True)
    if bins <= threshold:
        raise AssertionError(f"{bins} vote bins do not pass the sparse "
                             f"threshold {threshold}")

    def clip_of(sid, frame):
        return sources[sid][frame * HOP: frame * HOP + clip_len]

    sia.recognize_clip(clip_of(*picks[0]))  # warm-up
    # the phase's peak (as phase 3), then recognition's own: during this
    # phase's ingest the phase-3 device index is still resident
    peak_mib = rec_peak_mib = None
    if on_card:
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        torch.cuda.reset_peak_memory_stats()
    results, lat, wrong = _recognize_all(sia, picks, clip_of)
    two_pass = sum(r["query_time"] > 0 for r in results)
    partial = sum(r["partial_counts"] for r in results)
    print(f"big recognize_clip: {n_clips} clips of {BIG_CLIP_S} s, p50 "
          f"{1e3 * float(np.median(lat)):.3f} ms, max "
          f"{1e3 * max(lat):.3f} ms, wrong {len(wrong)}, handed to "
          f"recognize_samples {two_pass}, decided under a clamp {partial}, "
          f"median total matches "
          f"{int(np.median([r['total_matches'] for r in results]))}",
          flush=True)
    if wrong:
        raise AssertionError(f"big catalog, wrong top-1: {wrong[:5]}")
    if on_card:
        peak_mib = max(peak_mib, torch.cuda.max_memory_allocated() / 2**20)
        rec_peak_mib = torch.cuda.max_memory_allocated() / 2**20
    print(f"big catalog peak device memory allocated: {peak_mib} MiB "
          f"(recognition alone {rec_peak_mib} MiB)", flush=True)
    busy, idle = _idle_share(sia, picks, clip_of, lat, on_card,
                             "big recognize_clip")

    base = sia.config
    want = [_answer(r) for r in results[:n_check]]
    variants = {}
    try:
        for name, kw in BIG_VARIANTS:
            sia.config = dataclasses.replace(base, **kw)
            got, vlat, _ = _recognize_all(sia, picks[:n_check], clip_of)
            variants[name] = 1e3 * float(np.median(vlat))
            print(f"variant {name}: p50 {variants[name]:.3f} ms over "
                  f"{n_check} clips, handed to recognize_samples "
                  f"{sum(r['query_time'] > 0 for r in got)}, decided under "
                  f"a clamp {sum(r['partial_counts'] for r in got)}",
                  flush=True)
            bad = [(p, a, b) for p, a, b in zip(picks, want, map(_answer, got))
                   if not _same_answer(a, b)]
            if bad:
                raise AssertionError(f"variant {name} differs: {bad[:3]}")
    finally:
        sia.config = base
    match_half = _match_half(sia, clip_of(*picks[0]), on_card)
    clips = [(sid, frame, clip_of(sid, frame)) for sid, frame in picks]
    return clips, {"songs": n_total, "rows": rows, "index_mb": index_mb,
            "vote_bins": bins, "ingest_wall_s": ingest_s, "ingest_s": sia_s,
            "clip_p50_ms": 1e3 * float(np.median(lat)),
            "clip_max_ms": 1e3 * max(lat), "two_pass_clips": two_pass,
            "partial_count_clips": partial, "peak_device_mib": peak_mib,
            "recognize_peak_device_mib": rec_peak_mib,
            "clip_device_busy_ms": busy,
            "clip_idle_share": idle, "variant_p50_ms": variants,
            "match_half": match_half}


def _file_song(i: int):
    """Phase 5's song ``i`` as (samples, rate, format): by i % 3 a stereo
    int16 file at 44.1 kHz (right channel 0.7x the left), a mono int16
    song synthesized at 48 kHz, or a mono IEEE float32 file at 44.1 kHz."""
    from shazam_tpu_torch.audio import synth_song

    kind = FILE_FORMATS[i % 3]
    fs = 48000 if kind == "mono 48 kHz" else FS
    return synth_song(i, 30.0, fs=fs, seed=i), fs, kind


def _write_file(path: str, samples: np.ndarray, fs: int, kind: str) -> None:
    from shazam_tpu_torch.audio.io import write_float_wav, write_wav

    if kind == "stereo":
        samples = np.stack([samples, (samples * 0.7).astype(samples.dtype)])
    (write_float_wav if kind == "float32" else write_wav)(path, samples, fs)


@contextlib.contextmanager
def _timed(owner, names, acc: dict):
    """Time every call of ``owner``'s attributes ``names`` into acc[name]
    (seconds, summed) until the block ends."""
    saved = {name: getattr(owner, name) for name in names}

    def wrap(name, fn):
        def timed(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc[name] = acc.get(name, 0.0) + time.perf_counter() - t
        return timed

    for name, fn in saved.items():
        setattr(owner, name, wrap(name, fn))
    try:
        yield acc
    finally:
        for name, fn in saved.items():
            setattr(owner, name, fn)


def _right(res, sid: int, secs: float) -> bool:
    top = res["results"][0] if res["results"] else None
    return (top is not None and top["song_name"] == f"song{sid:05d}"
            and abs(top["offset_seconds"] - secs) < 0.1)


def files_and_batches(sia, first_id: int, n_files: int, big_clips, seed: int,
                      workers: int,
                      merge_hashes: int = FILE_MERGE_HASHES) -> dict:
    """Phase 5 on phase 4's SIA: ingest ``n_files`` 30 s songs from WAV
    files in three formats with ``ingest_directory`` (and again, which
    must skip them all), ``recognize_file`` 16 clips written as files,
    then ``recognize_batch`` phase 4's clips in batches of 8, 32 and 5
    (padded to 8) under the default and the dense config, each answer held
    against ``recognize_samples`` on the clip alone. Last, the device
    launches of one batched match dispatch at B = 8 and B = 32, which must
    be equal."""
    import dataclasses
    import tempfile

    import torch

    from shazam_tpu_torch import api
    from shazam_tpu_torch.audio import mp3
    from shazam_tpu_torch.profiling import host_launches

    on_card = sia.device.type == "cuda"
    ids = list(range(first_id, first_id + n_files))
    rng = np.random.default_rng(seed + 2)
    clip_ids = sorted({ids[k * len(ids) // 8] for k in range(8)})
    max_frame = (int(30.0 * FS) - int(FILE_CLIP_S * FS)) // HOP
    rows_before = sia.index.n_hashes
    print(f"libmpg123 {'present' if mp3.available() else 'absent'} "
          "(MP3 is not exercised here)", flush=True)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        kept = {}
        with mp.get_context("spawn").Pool(workers) as pool:
            for i, song in zip(ids, pool.imap(_file_song, ids, chunksize=4)):
                _write_file(os.path.join(tmp, f"song{i:05d}.wav"), *song)
                if i in clip_ids:
                    kept[i] = song
            pool.close()
            pool.join()
        out["synth_write_s"] = time.perf_counter() - t0
        acc: dict = {}
        with _timed(api, ("read", "resample_channels"), acc), \
                _timed(api.SIA, ("_merge_songs",), acc):
            stats = sia.ingest_directory(tmp, batch_size=FILE_BATCH,
                                         merge_chunk_hashes=merge_hashes)
        decode_s = acc.get("read", 0.0) + acc.get("resample_channels", 0.0)
        merge_s = acc.get("_merge_songs", 0.0)
        print(f"ingest_directory: {n_files} files x 30 s "
              f"({', '.join(FILE_FORMATS)}), {stats['hashes']} hashes, "
              f"{stats['merges']} merges, peak pending channels "
              f"{stats['peak_pending_channels']}, {stats['seconds']:.3f} s: "
              f"decode {acc.get('read', 0.0):.3f} s + resample "
              f"{acc.get('resample_channels', 0.0):.3f} s, merge "
              f"{merge_s:.3f} s, fingerprint and the rest "
              f"{stats['seconds'] - decode_s - merge_s:.3f} s "
              f"({n_files * 0.5 / stats['seconds']:.3f} audio-min/s); "
              f"synthesis and writing {out['synth_write_s']:.3f} s",
              flush=True)
        if (stats["ingested"] != n_files or stats["overflowed"]
                or stats["merges"] < 2
                or stats["peak_pending_channels"] > 2 * FILE_BATCH):
            raise AssertionError(f"ingest_directory stats {stats}")
        again = sia.ingest_directory(tmp, batch_size=FILE_BATCH)
        print(f"ingest_directory again: skipped {again['skipped']}, "
              f"ingested {again['ingested']}", flush=True)
        if again["skipped"] != n_files or again["ingested"]:
            raise AssertionError(f"second ingest_directory {again}")
        counts = sia.catalog.counts()
        if (counts["n_songs"] != first_id + n_files
                or sia.index.n_hashes != rows_before + stats["hashes"]
                or counts["n_hashes"] != sia.index.n_hashes):
            raise AssertionError(f"catalog {counts}, index rows "
                                 f"{sia.index.n_hashes}")
        out.update(files=n_files, formats=list(FILE_FORMATS),
                   ingest=stats, decode_s=decode_s, merge_s=merge_s)

        jobs = []    # (path, song, offset s): new files' clips, phase 4's
        for i in clip_ids:
            samples, fs, kind = kept[i]
            secs = int(rng.integers(0, max_frame + 1)) * HOP / FS
            start = round(secs * fs)
            path = os.path.join(tmp, f"clip{i}.wav")
            _write_file(path, samples[start: start + int(FILE_CLIP_S * fs)],
                        fs, kind)
            jobs.append((path, i, secs))
        for sid, frame, clip in big_clips[:8]:
            path = os.path.join(tmp, f"clip{sid}_{frame}.wav")
            _write_file(path, clip, FS, "mono")
            jobs.append((path, sid, frame * HOP / FS))
        lat, wrong = [], []
        for path, sid, secs in jobs:
            t = time.perf_counter()
            res = sia.recognize_file(path)
            lat.append(time.perf_counter() - t)
            if not _right(res, sid, secs):
                wrong.append((os.path.basename(path), res["results"][:1]))
        print(f"recognize_file: {len(jobs)} clips ({len(clip_ids)} of "
              f"{FILE_CLIP_S} s from the new files, the rest of {BIG_CLIP_S} "
              "s from phase 4), p50 "
              f"{1e3 * float(np.median(lat)):.3f} ms, wrong {len(wrong)}",
              flush=True)
        if wrong:
            raise AssertionError(f"recognize_file wrong: {wrong[:4]}")
        out["recognize_file"] = {"clips": len(jobs),
                                 "p50_ms": 1e3 * float(np.median(lat))}

    clips = [c for _sid, _frame, c in big_clips]
    base = sia.config
    out["batches"] = {}
    exact = {}    # clip -> recognize_samples with every row counted

    def same(j, got):
        want = solo[j]
        if (want["partial"] and got["partial"]
                and want["matched"] != got["matched"]):
            if j not in exact:
                cfg = sia.config
                sia.config = dataclasses.replace(base,
                                                 decision_escalation=False)
                try:
                    exact[j] = _answer(sia.recognize_samples([clips[j]]))
                finally:
                    sia.config = cfg
            return _same_answer(want, got, exact[j])
        return _same_answer(want, got)

    try:
        for name, kw in BATCH_CONFIGS:
            sia.config = dataclasses.replace(base, **kw)
            solo = [_answer(sia.recognize_samples([c])) for c in clips]
            sia.recognize_batch(clips[:FILE_BATCH])    # warm-up
            lat, sizes, res_all = [], [], []
            for batch, count, pad in BATCH_PLAN:
                for lo in range(0, min(batch * count, len(clips)), batch):
                    part = range(lo, min(lo + batch, len(clips)))
                    t = time.perf_counter()
                    res = sia.recognize_batch([clips[j] for j in part],
                                              pad_to_pow2=pad)
                    lat.append(time.perf_counter() - t)
                    sizes.append(len(part))
                    res_all += res
                    bad = [(j, solo[j], _answer(r), exact.get(j))
                           for j, r in zip(part, res)
                           if not (same(j, _answer(r))
                                   and _right(r, big_clips[j][0],
                                              big_clips[j][1] * HOP / FS))]
                    if len(res) != len(part) or bad:
                        raise AssertionError(
                            f"recognize_batch {name}, batch {batch}: "
                            f"{bad[:3]}")
            per_clip = [t / n for t, n in zip(lat, sizes)]
            pb = sia.prepare_batch(clips)
            q = sia._query_to_device(pb.stack)
            n_max = max(map(len, clips))

            def dispatch(bq, q=q, n_max=n_max):
                return lambda: sia._batch_match(
                    [a[:bq] for a in q], n_max, sia.config.match_capacity)

            launches = busy = None
            if on_card:
                for bq in (8, 32):
                    dispatch(bq)()
                torch.cuda.synchronize()
                traced = {bq: host_launches(dispatch(bq)) for bq in (8, 32)}
                launches = {bq: t[0] for bq, t in traced.items()}
                busy = {bq: _device_busy_ms(dispatch(bq)) for bq in (8, 32)}
                print(f"batched dispatch, {name}: launch calls "
                      f"{ {bq: dict(t[1]) for bq, t in traced.items()} }",
                      flush=True)
                if launches[8] != launches[32]:
                    raise AssertionError(
                        f"batched dispatch launches grow with the batch: "
                        f"{launches}")
            rec = {"batch_p50_ms": 1e3 * float(np.median(lat)),
                   "batch_max_ms": 1e3 * max(lat),
                   "clip_amortized_p50_ms": 1e3 * float(np.median(per_clip)),
                   "batches": len(lat), "dispatch_launches": launches,
                   "dispatch_device_busy_ms": busy,
                   "partial_batch_clips": sum(
                       r["partial_counts"] for r in res_all),
                   "exact_counts_taken": len(exact)}
            out["batches"][name] = rec
            print(f"recognize_batch {name}: {len(lat)} batches of sizes "
                  f"{sizes} (the 5 padded to 8) of {BIG_CLIP_S} s clips, "
                  "all equal to recognize_samples; "
                  f"per batch p50 {rec['batch_p50_ms']:.3f} ms, max "
                  f"{rec['batch_max_ms']:.3f} ms; decided under a clamp "
                  f"{rec['partial_batch_clips']} of {len(res_all)} answers, "
                  f"exact counts taken for {len(exact)} clips so far; "
                  f"per clip amortized p50 "
                  f"{rec['clip_amortized_p50_ms']:.3f} ms; one dispatch at "
                  f"B = 8 / 32: device launches {launches}, device busy "
                  f"{busy} ms", flush=True)
    finally:
        sia.config = base
    return out


def _dense(clip: np.ndarray, rng, seconds: float = DENSE_NOISE_S) -> np.ndarray:
    """A clip whose first ``seconds`` (DENSE_NOISE_S) are seeded broadband
    noise that repeats every hop, the rest the song. Frames inside the
    noise are identical, so every frequency-local maximum ties with its
    neighbors in time and counts as a peak: about 12,000 in a 15 s clip,
    past the batch's peak capacity of 8,192. (Untied audio cannot get
    there: two distinct peaks of a 21 x 21 neighborhood lie at least 11
    cells apart, at most 5,430 peaks in 321 frames, and random noise gives
    about 1 in 441 cells.)"""
    n = int(seconds * FS)
    period = rng.normal(0, 8000.0, HOP)
    out = clip.copy()
    out[:n] = np.clip(np.tile(period, -(-n // HOP))[:n], -32768,
                      32767).astype(np.int16)
    return out


def _catalog_song(sid: int, file_first: int):
    """(samples, rate) of catalog song ``sid`` as phases 3-5 ingested it:
    a 30 s song at 44.1 kHz, or phase 5's file song (the left channel of
    a stereo file; 48 kHz where phase 5 synthesized it so)."""
    if sid < file_first:
        return _song(sid), FS
    samples, fs, _kind = _file_song(sid)
    return samples, fs


def _catalog_rate(sid: int, file_first: int) -> int:
    """The rate ``_catalog_song`` returns, without synthesizing."""
    return (48000 if sid >= file_first
            and FILE_FORMATS[sid % 3] == "mono 48 kHz" else FS)


def _serve_jobs(big_clips, n_total: int, file_first: int, seed: int,
                workers: int):
    """Phase 6a's requests: (WAV body, song, offset s, channels as the
    daemon decodes them, kind). Phase 4's 32 clips, 32 new seeded
    frame-aligned clips across all songs (8 of them dense; 48 kHz songs
    are sent at 48 kHz, and the daemon resamples them), and 4 stereo
    requests, in a seeded order. The new clips' songs are synthesized by
    a process pool."""
    from shazam_tpu_torch.audio.resample import resample_channels
    from shazam_tpu_torch.client import encode_wav

    rng = np.random.default_rng(seed + 6)
    clip_len = int(BIG_CLIP_S * FS)
    max_frame = (int(30.0 * FS) - clip_len) // HOP
    jobs = [(encode_wav(c, FS), sid, frame * HOP / FS, [c], "phase 4")
            for sid, frame, c in big_clips]
    picks = []
    for k in range(SERVE_NEW_CLIPS):
        sid = int(rng.integers(n_total))
        secs = int(rng.integers(0, max_frame + 1)) * HOP / FS
        while k < DENSE_CLIPS and _catalog_rate(sid, file_first) != FS:
            # resampling would stretch the noise's period off the hop
            sid = int(rng.integers(n_total))
        picks.append((sid, secs))
    with mp.get_context("spawn").Pool(workers) as pool:
        songs = pool.map(functools.partial(_catalog_song, file_first=file_first),
                         [sid for sid, _ in picks])
    for k, ((sid, secs), (samples, fs)) in enumerate(zip(picks, songs)):
        start = round(secs * fs)
        clip = samples[start: start + int(BIG_CLIP_S * fs)]
        kind = "new"
        if k < DENSE_CLIPS:
            clip, kind = _dense(clip, rng), "dense"
        chans = [clip] if fs == FS else resample_channels([clip], fs, FS)
        jobs.append((encode_wav(clip, fs), sid, secs, chans, kind))
    for sid, frame, c in big_clips[:SERVE_STEREO]:
        right = (c * 0.7).astype(np.int16)
        jobs.append((encode_wav(np.stack([c, right]), FS), sid,
                     frame * HOP / FS, [c, right], "stereo"))
    return [jobs[j] for j in rng.permutation(len(jobs))]


def _overlaps(spans, others) -> int:
    """How many of ``spans`` overlap in time one of ``others``."""
    return sum(any(a < d and c < b for c, d in others) for a, b in spans)


def _daemon_run(sia, jobs, pipeline: bool) -> dict:
    """Phase 6a once: an in-process daemon answers ``jobs`` from
    SERVE_THREADS client threads. Counts the dense clips' retries (the
    peak_over clips of every prepared batch, each re-run alone by the
    match stage) and how many of the match thread's retries overlapped a
    batch being fingerprinted on the batcher thread."""
    from shazam_tpu_torch.client import SIAClient
    from shazam_tpu_torch.serve import RecognitionServer

    peak_over, prepares, retries = [0], [], []
    real_prep, real_solo = sia.prepare_batch, sia.recognize_samples

    def prepare_batch(*a, **kw):
        t = time.perf_counter()
        pb = real_prep(*a, **kw)
        prepares.append((t, time.perf_counter()))
        peak_over[0] += len(pb.peak_over) if pb is not None else 0
        return pb

    def recognize_samples(*a, **kw):
        t = time.perf_counter()
        out = real_solo(*a, **kw)
        if threading.current_thread().name == "sia-matcher":
            retries.append((t, time.perf_counter()))
        return out

    sia.prepare_batch, sia.recognize_samples = prepare_batch, recognize_samples
    srv = RecognitionServer(sia, port=0, max_batch=16, max_wait_ms=10,
                            pipeline=pipeline)
    srv.start_background()
    answers, errors, lat = [None] * len(jobs), [], []
    t0 = time.perf_counter()
    try:
        client = SIAClient(f"http://127.0.0.1:{srv.port}")

        def worker(k):
            for j in range(k, len(jobs), SERVE_THREADS):
                t = time.perf_counter()
                try:
                    answers[j] = client.recognize(wav_bytes=jobs[j][0])
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append((j, repr(e)))
                lat.append(time.perf_counter() - t)

        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(SERVE_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        stats = client.stats()
    finally:
        srv.close()
        del sia.prepare_batch, sia.recognize_samples
    mono = sum(len(j[3]) == 1 for j in jobs)
    rec = {"pipeline": pipeline, "requests": stats["requests"],
           "errors": stats["errors"], "batches": stats["batches"],
           "max_batch": stats["max_batch"], "latency": stats["latency"],
           "client_p50_ms": 1e3 * float(np.median(lat)),
           "client_max_ms": 1e3 * max(lat), "wall_s": wall,
           "match_s": stats.get("match_s"), "prepare_s": stats.get("prepare_s"),
           "dense_retries": peak_over[0],
           "retries_overlapping_a_batch": _overlaps(retries, prepares)}
    print(f"daemon (pipeline {'on' if pipeline else 'off'}): {len(jobs)} "
          f"requests from {SERVE_THREADS} threads in {wall:.3f} s; batches "
          f"{rec['batches']} for {mono} mono requests, largest "
          f"{rec['max_batch']}; queue->response p50 "
          f"{rec['latency'].get('p50_ms')} ms, p99 "
          f"{rec['latency'].get('p99_ms')} ms; client p50 "
          f"{rec['client_p50_ms']:.3f} ms; match_s {rec['match_s']}, "
          f"prepare_s {rec['prepare_s']}; dense retries {peak_over[0]}, of "
          f"which {rec['retries_overlapping_a_batch']} overlapped a batch "
          f"being fingerprinted; errors {rec['errors']}", flush=True)
    if errors or stats["errors"]:
        raise AssertionError(f"daemon errors: {errors[:3]}, /stats "
                             f"errors {stats['errors']}")
    if not (stats["batches"] < mono and stats["max_batch"] > 1):
        raise AssertionError(f"daemon did not batch: {stats}")
    if peak_over[0] < 1:
        raise AssertionError("no dense clip overflowed the batch's peak "
                             "capacity: the retry path did not run")
    rec["answers"] = answers
    return rec


def _held_to_solo(sia, chans, solo, exact, j, got) -> bool:
    """Phase 5's rule: ``got`` equals the solo answer of job ``j``, two
    lower bounds under different clamps each held to the exact count."""
    import dataclasses

    want = solo[j]
    if want["partial"] and got["partial"] and want["matched"] != got["matched"]:
        if j not in exact:
            cfg = sia.config
            sia.config = dataclasses.replace(cfg, decision_escalation=False)
            try:
                exact[j] = _answer(sia.recognize_samples(chans))
            finally:
                sia.config = cfg
        return _same_answer(want, got, exact[j])
    return _same_answer(want, got)


def _mutation(sia, big_clips, new_id: int, seed: int, tmp: str) -> dict:
    """Phase 6b: /ingest two new songs, /delete one, /save, a fresh SIA
    from the snapshot (fsck, same answers), and a token-gated daemon."""
    import sqlite3

    from shazam_tpu_torch.api import SIA
    from shazam_tpu_torch.client import SIAClient, SIAServerError
    from shazam_tpu_torch.serve import RecognitionServer
    from shazam_tpu_torch.tools.fsck import check_integrity

    rng = np.random.default_rng(seed + 7)
    ids = [new_id, new_id + 1]
    clip_len = int(BIG_CLIP_S * FS)
    clips = {}
    for i in ids:
        secs = int(rng.integers(0, (30 * FS - clip_len) // HOP + 1)) * HOP / FS
        clips[i] = (_song(i)[round(secs * FS):][:clip_len], secs)
    out = {}
    srv = RecognitionServer(sia, port=0, max_batch=16, max_wait_ms=10)
    srv.start_background()
    try:
        client = SIAClient(f"http://127.0.0.1:{srv.port}")
        before = client.stats()
        t = time.perf_counter()
        for i in ids:
            res = client.ingest(f"song{i:05d}", _song(i), FS)
            if res["ingested"] != 1:
                raise AssertionError(f"/ingest song {i}: {res}")
        out["ingest_s"] = time.perf_counter() - t
        for i in ids:
            if not _right(client.recognize(clips[i][0], FS), i, clips[i][1]):
                raise AssertionError(f"ingested song {i} not recognized")
        grown = client.stats()
        gone = ids[1]
        res = client.delete(f"song{gone:05d}")
        if res["deleted_songs"] != 1 or res["removed_rows"] <= 0:
            raise AssertionError(f"/delete: {res}")
        hit = client.recognize(clips[gone][0], FS)
        if any(r["song_name"] == f"song{gone:05d}" for r in hit["results"]):
            raise AssertionError("a deleted song is still recognized")
        shrunk = client.stats()
        if not (grown["n_songs"] == before["n_songs"] + 2
                and shrunk["n_songs"] == grown["n_songs"] - 1
                and shrunk["n_hashes"] < grown["n_hashes"]
                and shrunk["index_hashes"] < grown["index_hashes"]):
            raise AssertionError(f"/stats counts: {before}, {grown}, {shrunk}")
        snap = os.path.join(tmp, "snapshot.npz")
        t = time.perf_counter()
        if client.save(snap)["saved"] != snap:
            raise AssertionError("/save")
        out["save_s"] = time.perf_counter() - t
        if client.stats()["errors"]:
            raise AssertionError("daemon errors during the mutations")
    finally:
        srv.close()
    print(f"mutation: /ingest 2 songs in {out['ingest_s']:.3f} s, both "
          f"recognized; /delete song {gone}: no longer returned, songs "
          f"{grown['n_songs']} -> {shrunk['n_songs']}, hashes "
          f"{grown['n_hashes']} -> {shrunk['n_hashes']}; /save in "
          f"{out['save_s']:.3f} s", flush=True)

    # the snapshot holds the index; the catalog is the live one, copied
    cat = os.path.join(tmp, "snapshot.sqlite")
    dst = sqlite3.connect(cat)
    sia.catalog.conn.backup(dst)
    dst.close()
    t = time.perf_counter()
    fresh = SIA(device=sia.device, catalog_path=cat)
    fresh.load_index(snap)
    fresh._ensure_device_index()
    report = check_integrity(fresh, deep=True)
    out["fresh_load_s"] = time.perf_counter() - t
    if not report["ok"] or report["checks"]["store"] != "DeviceIndex":
        raise AssertionError(f"fsck of the snapshot: {report}")
    checked = [(c, sid, frame * HOP / FS) for sid, frame, c in big_clips[:3]]
    checked.append((clips[ids[0]][0], ids[0], clips[ids[0]][1]))
    for c, sid, secs in checked:
        a, b = (_answer(s.recognize_samples([c])) for s in (sia, fresh))
        if a != b or not _right(fresh.recognize_samples([c]), sid, secs):
            raise AssertionError(f"snapshot answers differ: {a} {b}")
    print(f"snapshot: loaded with its catalog in {out['fresh_load_s']:.3f} s "
          f"(fsck deep ok: {report['checks']}), 4 clips answered alike",
          flush=True)
    del fresh

    srv = RecognitionServer(sia, port=0, max_batch=16, max_wait_ms=10,
                            auth_token="phase6-token")
    srv.start_background()
    try:
        client = SIAClient(f"http://127.0.0.1:{srv.port}")
        try:
            client.ingest("song99999", _song(ids[0]), FS)
            raise AssertionError("/ingest without the token was accepted")
        except SIAServerError as e:
            if e.status != 401:
                raise
        sid, frame, c = big_clips[0]
        if not _right(client.recognize(c, FS), sid, frame * HOP / FS):
            raise AssertionError("token-gated daemon: /recognize wrong")
    finally:
        srv.close()
    print("auth: /ingest without the token refused (401), /recognize "
          "answered", flush=True)
    out.update(fsck=report["checks"], deleted=gone)
    return out


def _stream_pieces(n: int):
    """Frames per channel of each feed: CHUNK, with a few odd sizes."""
    from shazam_tpu_torch.stream import CHUNK

    odd = (3001, 12345, 777, CHUNK + 1)
    pieces, k = [], 0
    while sum(pieces) < n:
        step = odd[(k // 7) % len(odd)] if k % 7 == 3 else CHUNK
        pieces.append(min(step, n - sum(pieces)))
        k += 1
    return pieces


def _streams(sia, file_first: int, n_files: int, seed: int) -> dict:
    """Phase 6c: per engine, a /stream session (2 channels, 15 s window)
    fed 20 s of a stereo song, recognized after 16 s and at the end; and
    the same chunks into an in-process StreamRecognizer, whose windows
    must equal fingerprint_batch_fused of their samples bit for bit."""
    import torch

    from shazam_tpu_torch.api import _bucket_len
    from shazam_tpu_torch.client import SIAClient
    from shazam_tpu_torch.ops.fingerprint import fingerprint_batch_fused
    from shazam_tpu_torch.serve import RecognitionServer
    from shazam_tpu_torch.stream import StreamRecognizer

    rng = np.random.default_rng(seed + 8)
    stereo_ids = [i for i in range(file_first, file_first + n_files)
                  if FILE_FORMATS[i % 3] == "stereo"]
    sid = stereo_ids[int(rng.integers(len(stereo_ids)))]
    samples, fs, _kind = _file_song(sid)
    n = int(STREAM_S * FS)
    start = int(rng.integers(0, (30 * FS - n) // HOP + 1)) * HOP
    left = samples[start: start + n]
    chans = [left, (left * 0.7).astype(np.int16)]   # as phase 5 wrote it
    pieces = _stream_pieces(n)

    def interleaved(a, b):
        out = np.empty(2 * (b - a), np.int16)
        out[0::2], out[1::2] = chans[0][a:b], chans[1][a:b]
        return out

    def right(res, fp):
        return _right(res, sid, (start + fp.window_sample_range()[0]) / FS)

    out = {"song": sid, "start_s": start / FS}
    srv = RecognitionServer(sia, port=0, max_batch=16, max_wait_ms=10)
    srv.start_background()
    try:
        client = SIAClient(f"http://127.0.0.1:{srv.port}")
        for engine in ("host", "device"):
            rec = StreamRecognizer(sia, channels=2,
                                   window_seconds=STREAM_WINDOW_S,
                                   engine=engine)
            feed_s, rec_lat, checks, after_ready = 0.0, [], 0, None
            with client.open_stream(channels=2, window_seconds=STREAM_WINDOW_S,
                                    engine=engine) as session:
                served = srv.batcher._streams[session.session_id][0]
                pos, http_hits = 0, []
                for k, step in enumerate(pieces):
                    chunk = interleaved(pos, pos + step)
                    session.feed(chunk)
                    t = time.perf_counter()
                    rec.feed(chunk)
                    feed_s += time.perf_counter() - t
                    first = pos < STREAM_FIRST_RECOGNIZE_S * FS <= pos + step
                    pos += step
                    if first or pos == n:
                        res = session.recognize()
                        if not right(res, served._fps[0]):
                            raise AssertionError(
                                f"/stream/recognize ({engine}) at {pos / FS:.2f}"
                                f" s: {res['results'][:1]}")
                        http_hits.append(pos / FS)
                    if not rec.ready or pos < STREAM_WINDOW_S * FS:
                        continue
                    if after_ready is None:
                        after_ready = rec.fallbacks
                    if k % 4 and pos != n:
                        continue
                    for c, fp in enumerate(rec._fps):
                        a, b = fp.window_sample_range()
                        x = np.zeros((1, _bucket_len(b - a)), np.float32)
                        x[0, : b - a] = chans[c][a:b]
                        want = fingerprint_batch_fused(
                            torch.from_numpy(x).to(sia.device),
                            torch.tensor([b - a], device=sia.device))
                        got = fp.fingerprints()
                        if not all(torch.equal(g, w[0])
                                   for g, w in zip(got, want)):
                            raise AssertionError(
                                f"{engine} stream window [{a}, {b}) of "
                                f"channel {c} differs from the full pass")
                    checks += 1
                    t = time.perf_counter()
                    res = rec.recognize()
                    rec_lat.append(time.perf_counter() - t)
                    if not right(res, rec._fps[0]):
                        raise AssertionError(f"{engine} stream recognize "
                                             f"wrong at {pos / FS:.2f} s")
                served_fallbacks = served.fallbacks
                served_frames = [(f.frames_computed, f.n_frames)
                                 for f in served._fps]
            fed_frames = (n - 4096) // HOP + 1
            frames = [(f.frames_computed, f.n_frames) for f in rec._fps]
            if engine == "device":
                fed_frames -= fed_frames % 16   # whole quanta only
            if any(fc != fed_frames or nf != fed_frames
                   for fc, nf in frames + served_frames):
                raise AssertionError(f"{engine}: frames computed "
                                     f"{frames} {served_frames}, fed "
                                     f"{fed_frames}")
            if rec.fallbacks != after_ready or served_fallbacks:
                raise AssertionError(
                    f"{engine}: fallbacks after ready {rec.fallbacks - after_ready}"
                    f", served session {served_fallbacks}")
            quanta = rec._fps[0].frames_computed / 16
            out[engine] = {
                "feeds": len(pieces), "feed_ms_per_quantum":
                    1e3 * feed_s / quanta,
                "recognize_p50_ms": 1e3 * float(np.median(rec_lat)),
                "recognize_max_ms": 1e3 * max(rec_lat),
                "windows_checked": checks, "frames": fed_frames,
                "fallbacks_after_ready": rec.fallbacks - after_ready,
                "http_recognize_at_s": http_hits}
            print(f"stream {engine}: {len(pieces)} feeds of 2 channels "
                  f"({STREAM_S} s, song {sid}), feed "
                  f"{out[engine]['feed_ms_per_quantum']:.3f} ms per 16 "
                  f"frames (both channels), recognize p50 "
                  f"{out[engine]['recognize_p50_ms']:.3f} ms over "
                  f"{len(rec_lat)} calls; {checks} windows bit-equal to "
                  f"fingerprint_batch_fused; /stream/recognize right at "
                  f"{http_hits} s; fallbacks after ready 0; frames computed "
                  f"= frames fed = {fed_frames}", flush=True)
    finally:
        srv.close()
    return out


def serve_and_stream(sia, big_clips, n_total: int, file_first: int,
                     n_files: int, seed: int, workers: int) -> dict:
    """Phase 6 on phase 5's SIA: (a) the daemon under 8 client threads,
    pipeline on and off, every answer right and equal to
    recognize_samples on the clip alone; (b) online mutation, a snapshot
    and a token-gated daemon; (c) /stream sessions and in-process streams
    on both engines. Every kernel launch of (a)-(c) passes a
    ``ShapeAudit``, which then holds the first launch at each shape
    against its twin. The CLI is not driven here: as subprocesses on the
    card it took phase 6 past 100 s; ``tests/test_torch_cli.py`` holds
    it, its daemon subprocess and SIGTERM included."""
    import tempfile

    out = {}
    secs = out["seconds"] = {}
    with ShapeAudit(sia.config) as audit:
        t = time.perf_counter()
        jobs = _serve_jobs(big_clips, n_total, file_first, seed, workers)
        solo = [_answer(sia.recognize_samples(j[3])) for j in jobs]
        exact = {}
        for pipeline in (True, False):
            run = _daemon_run(sia, jobs, pipeline)
            bad = [(j, jobs[j][4], solo[j], _answer(r))
                   for j, r in enumerate(run.pop("answers"))
                   if not (_right(r, jobs[j][1], jobs[j][2])
                           and _held_to_solo(sia, jobs[j][3], solo, exact, j,
                                             _answer(r)))]
            if bad:
                raise AssertionError(f"daemon (pipeline {pipeline}) answers: "
                                     f"{bad[:3]}")
            out["daemon_pipeline" if pipeline else "daemon_single_thread"] = run
        print(f"daemon: all {len(jobs)} answers right and equal to "
              f"recognize_samples alone, both runs (exact counts taken for "
              f"{len(exact)} clips)", flush=True)
        secs["daemon"] = time.perf_counter() - t
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            out["mutation"] = _mutation(sia, big_clips, n_total, seed, tmp)
        secs["mutation"] = time.perf_counter() - t
        t = time.perf_counter()
        out["streams"] = _streams(sia, file_first, n_files, seed)
        secs["streams"] = time.perf_counter() - t
    t = time.perf_counter()
    out["twin_audit"] = audit.check()
    secs["twin_audit"] = time.perf_counter() - t
    print("phase 6's first launch at each shape equal to its plain twin "
          "(K1 in dB): " + "; ".join(
              f"{name} at {len(v)} shapes {[k for k, _ in v]}, max err "
              f"{max((e for _, e in v), default=0)}"
              for name, v in out["twin_audit"].items()), flush=True)
    print(f"phase 6 seconds: { {k: round(v, 3) for k, v in secs.items()} }",
          flush=True)
    return out


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def _resident_rows(first_id: int, seed: int):
    """Phase 7's batches: [(names, song ids, per-row samples)], 16 rows
    each. Song ``first_id + 5`` is dense (RESIDENT_DENSE_S seconds of tied
    noise, over the ingest capacity and under twice it); the last song is
    stereo, its two rows one name (the right channel 0.7x the left)."""
    rng = np.random.default_rng(seed + 9)
    n_rows = RESIDENT_BATCHES * RESIDENT_BATCH
    ids = list(range(first_id, first_id + n_rows - 1))
    with mp.get_context("spawn").Pool(os.cpu_count() or 1) as pool:
        songs = dict(zip(ids, pool.map(_song, ids)))
        pool.close()
        pool.join()
    songs[ids[5]] = _dense(songs[ids[5]], rng, RESIDENT_DENSE_S)
    rows = [(i, songs[i]) for i in ids]
    rows.append((ids[-1], (songs[ids[-1]] * 0.7).astype(np.int16)))
    batches = [rows[b: b + RESIDENT_BATCH]
               for b in range(0, n_rows, RESIDENT_BATCH)]
    return songs, batches


def _rows_equal(a, b) -> bool:
    return a.n_hashes == b.n_hashes and all(
        np.array_equal(getattr(a, c), getattr(b, c))
        for c in ("key_hi", "key_lo", "key_ex", "song_id", "offset"))


def _random_run(n: int, device, sid0: int, n_sids: int, max_off: int,
                stride: int, gen):
    """``n`` random rows on the card: 80-bit keys (never the sentinel's),
    songs ``sid0`` up, the store's stride. Unsorted: ``finalize`` sorts
    appended rows."""
    import torch

    from shazam_tpu_torch.index.search import query_key64

    hi = torch.randint(0, (1 << 32) - 1, (n,), device=device, generator=gen)
    lo = torch.randint(0, 1 << 32, (n,), device=device, generator=gen)
    key64 = query_key64(hi, lo)
    del hi, lo
    ex = torch.randint(0, 1 << 16, (n,), device=device, generator=gen)
    sid = torch.randint(sid0, sid0 + n_sids, (n,), device=device,
                        generator=gen)
    off = torch.randint(0, max_off + 1, (n,), device=device, generator=gen)
    return key64, ex, sid * stride + off


def _scale_probe(res, seed: int) -> dict:
    """Phase 7's scale probe: grow the store with random rows (song ids
    past the catalog) to 2^27 rows; at the start and at PROBE_AT, time one
    PROBE_RUN-row sorted run through merge_device_run and, from the same
    state, through append_run + finalize (the rows must come out equal),
    then the query_cols() rebuild. CUDA-event ms. No query holds the
    store's search view here, so it is dropped before each write (a
    serving store copies its columns first instead)."""
    import torch

    from shazam_tpu_torch.index.devmerge import lexsort_rows

    store = res._ensure_dev_store()
    dev = store.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 10)
    sid0 = store.n_songs + 16
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    def timed(fn):
        """(result, device ms by CUDA events, wall ms); off the card the
        wall ms stands in for both."""
        _sync(dev)
        t = time.perf_counter()
        if dev.type != "cuda":
            out = fn()
            wall = 1e3 * (time.perf_counter() - t)
            return out, wall, wall
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b), 1e3 * (time.perf_counter() - t)

    def checkpoint():
        run = _random_run(PROBE_RUN, dev, sid0, 1024, 640, store.stride, gen)
        order = lexsort_rows(*run)
        run = tuple(c[order] for c in run)
        n0 = store.n_valid
        store._view = None
        saved = (store.cols, store.n_valid, store._sorted_rows, None)
        _, merge_ms, merge_wall = timed(lambda: store.merge_device_run(
            run, PROBE_RUN, sid0 + 1024, 640))
        merged = store.cols
        store.cols, store.n_valid, store._sorted_rows, store._view = saved
        _, append_ms, _ = timed(lambda: store.append_run(
            run, PROBE_RUN, sid0 + 1024, 640))
        _, finalize_ms, finalize_wall = timed(store.finalize)
        n = store.n_valid
        if n != n0 + PROBE_RUN or not all(
                torch.equal(a[:n], b[:n]) for a, b in zip(store.cols, merged)):
            raise AssertionError(f"scale probe at {n0} rows: append_run + "
                                 "finalize differs from merge_device_run")
        del merged, saved
        _, view_ms, _ = timed(store.query_cols)
        rec = {"rows_before": n0, "rows_after": n, "capacity": store.capacity,
               "merge_device_run_ms": merge_ms, "merge_wall_ms": merge_wall,
               "append_run_ms": append_ms, "finalize_ms": finalize_ms,
               "finalize_wall_ms": finalize_wall, "query_cols_ms": view_ms}
        print(f"scale probe at {n0} rows: merge_device_run of {PROBE_RUN} "
              f"rows {merge_ms:.3f} ms (wall {merge_wall:.3f}); append_run "
              f"{append_ms:.3f} ms + finalize {finalize_ms:.3f} ms (wall "
              f"{finalize_wall:.3f}), rows equal; query_cols rebuild "
              f"{view_ms:.3f} ms; capacity {store.capacity}", flush=True)
        return rec

    t0 = time.perf_counter()
    out = {"start": checkpoint()}
    grow_s = 0.0
    for target in PROBE_AT:
        t = time.perf_counter()
        store._view = None
        while store.n_valid < target - PROBE_RUN:
            n = min(PROBE_CHUNK, target - PROBE_RUN - store.n_valid)
            store.append_run(_random_run(n, dev, sid0, 1024, 640,
                                         store.stride, gen),
                             n, sid0 + 1024, 640)
            store.finalize()
        _sync(dev)
        grow_s += time.perf_counter() - t
        out[str(target)] = checkpoint()
    if store.n_valid != PROBE_AT[-1]:
        raise AssertionError(f"scale probe ended at {store.n_valid} rows")
    out["grow_s"] = grow_s
    out["peak_device_mib"] = (torch.cuda.max_memory_allocated() / 2**20
                              if dev.type == "cuda" else None)
    out["seconds"] = time.perf_counter() - t0
    print(f"scale probe: {store.n_valid} rows reached; growth {grow_s:.3f} s "
          f"in appends of up to {PROBE_CHUNK} rows; peak device memory "
          f"allocated {out['peak_device_mib']} MiB; "
          f"{out['seconds']:.3f} s", flush=True)
    res._host_stale = True
    return out


def device_resident(sia, big_clips, first_id: int, seed: int) -> dict:
    """Phase 7 on phase 6's SIA: a device-resident SIA over the same
    catalog and index ingests RESIDENT_BATCHES batches of 16 rows already
    on the card (two merged, two appended with defer_sort; a stereo song;
    a dense row whose 2x retry runs on the card), held row for row to the
    host-backed SIA ingesting the same songs; 32 clips and a batch of 8
    answered alike by both; ingest_channels, delete_songs, save_index, a
    fresh SIA from the file with fsck; then the scale probe."""
    import tempfile

    import torch

    from shazam_tpu_torch.api import SIA
    from shazam_tpu_torch.tools.fsck import check_integrity

    out = {}
    rng = np.random.default_rng(seed + 11)
    t = time.perf_counter()
    songs, batches = _resident_rows(first_id, seed)
    out["synth_s"] = time.perf_counter() - t

    t = time.perf_counter()
    res = SIA(device=sia.device, device_resident=True,
              device_reserve_hashes=RESIDENT_RESERVE, index=sia.index)
    sia.catalog.conn.backup(res.catalog.conn)
    store = res._ensure_dev_store()
    _sync(sia.device)
    out["from_host_s"] = time.perf_counter() - t
    print(f"device store: from_host of {store.n_valid} rows into capacity "
          f"{store.capacity} in {out['from_host_s']:.3f} s", flush=True)

    blen = 6 << 18
    batch_ms, stats_all = [], []
    for b, rows in enumerate(batches):
        mat = np.zeros((len(rows), blen), np.int16)
        for r, (_i, x) in enumerate(rows):
            mat[r, : len(x)] = x
        x = torch.from_numpy(mat).to(sia.device).to(torch.float32)
        _sync(sia.device)
        t = time.perf_counter()
        st = res.ingest_device_batch([f"song{i:05d}" for i, _x in rows], x,
                                     [len(x_) for _i, x_ in rows],
                                     defer_sort=b >= len(batches) // 2)
        _sync(sia.device)
        batch_ms.append(1e3 * (time.perf_counter() - t))
        stats_all.append(st)
    n_songs = sum(st["ingested"] for st in stats_all)
    fallbacks = sum(st.get("fallbacks", 0) for st in stats_all)
    pending = store._unsorted
    print(f"ingest_device_batch: {len(batches)} batches of "
          f"{RESIDENT_BATCH} x 30 s rows ({n_songs} songs), ms per batch "
          f"{[round(m, 3) for m in batch_ms]}, "
          f"{n_songs / (sum(batch_ms) / 1e3):.3f} songs/s; merges "
          f"{[st['merges'] for st in stats_all]}, fallbacks {fallbacks}, "
          f"overflowed {[st['overflowed'] for st in stats_all]}, appends "
          f"pending {pending}", flush=True)
    if (n_songs != len(songs) or fallbacks != 1 or not pending
            or any(st["overflowed"] for st in stats_all)
            or sum(st["merges"] for st in stats_all) != len(batches) + 1):
        raise AssertionError(f"ingest_device_batch stats {stats_all}")

    # the host-backed SIA ingests the same songs in the same order (ids
    # agree): the mono ones through ingest_arrays, the stereo one last
    t = time.perf_counter()
    stereo = batches[-1][-1][0]
    mono = [(f"song{i:05d}", x) for i, x in songs.items() if i != stereo]
    hst = sia.ingest_arrays(mono)
    hst2 = sia.ingest_channels(f"song{stereo:05d}",
                               [r[1] for r in batches[-1][-2:]])
    out["host_ingest_s"] = time.perf_counter() - t
    t = time.perf_counter()
    got = res.index          # finalizes the appends, syncs to the host
    out["sync_s"] = time.perf_counter() - t
    want = sia.index
    new_ids = sorted(songs)
    names = {f"song{i:05d}" for i in new_ids}
    d_counts, h_counts = (
        {d["song_name"]: d["total_hashes"] for d in s.catalog.get_songs()
         if d["song_name"] in names} for s in (res, sia))
    same_rows = _rows_equal(got, want)
    print(f"store held to the host path: {got.n_hashes} rows "
          f"{'equal' if same_rows else 'DIFFER'} row for row; per-song "
          f"hash counts {'equal' if d_counts == h_counts else 'DIFFER'} "
          f"({len(d_counts)} songs); host fallbacks "
          f"{hst.get('fallbacks', 0)}, overflowed {hst['overflowed']}; host "
          f"ingest {out['host_ingest_s']:.3f} s, store sync {out['sync_s']:.3f}"
          " s", flush=True)
    if not (same_rows and d_counts == h_counts and len(d_counts) == len(songs)
            and hst.get("fallbacks", 0) == 1 and not hst["overflowed"]
            and hst2["ingested"] == 1):
        raise AssertionError("device store differs from the host ingest")

    # 32 clips: 16 of the new songs (not the dense one), 16 of phase 4's
    clip_len = int(BIG_CLIP_S * FS)
    max_frame = (int(30.0 * FS) - clip_len) // HOP
    jobs = []
    for i in [i for i in new_ids if i != new_ids[5]][: RESIDENT_CLIPS // 2]:
        frame = int(rng.integers(0, max_frame + 1))
        jobs.append((i, frame, songs[i][frame * HOP: frame * HOP + clip_len]))
    jobs += list(big_clips[: RESIDENT_CLIPS - len(jobs)])
    res.recognize_clip(jobs[0][2])     # warm-up
    lat = {"resident": [], "host": []}
    answers = {}
    for name, s_ in (("resident", res), ("host", sia)):
        answers[name] = []
        for sid, frame, c in jobs:
            t = time.perf_counter()
            r = s_.recognize_clip(c)
            lat[name].append(time.perf_counter() - t)
            if not _right(r, sid, frame * HOP / FS):
                raise AssertionError(f"{name} SIA: clip of {sid} wrong: "
                                     f"{r['results'][:1]}")
            answers[name].append(_answer(r))
    solo = answers["host"]
    exact = {}
    bad = [(j, solo[j], a) for j, a in enumerate(answers["resident"])
           if not _held_to_solo(sia, [jobs[j][2]], solo, exact, j, a)]
    batch = [c for _s, _f, c in jobs[: RESIDENT_BATCH_CLIPS]]
    b_host = [_answer(r) for r in sia.recognize_batch(batch)]
    exact_b = {}
    bad += [(j, b_host[j], _answer(r)) for j, r
            in enumerate(res.recognize_batch(batch))
            if not _held_to_solo(sia, [batch[j]], b_host, exact_b, j,
                                 _answer(r))]
    identical = sum(a == b for a, b in zip(answers["resident"], solo))
    p50 = {k: 1e3 * float(np.median(v)) for k, v in lat.items()}
    print(f"recognize_clip: {len(jobs)} clips of {BIG_CLIP_S} s, p50 "
          f"resident {p50['resident']:.3f} ms, host-backed "
          f"{p50['host']:.3f} ms; {identical} answers identical, "
          f"{len(jobs) - identical} equal by phase 5's rule (exact counts "
          f"taken {len(exact)}); recognize_batch of "
          f"{RESIDENT_BATCH_CLIPS} equal; differences {len(bad)}",
          flush=True)
    if bad:
        raise AssertionError(f"resident answers differ: {bad[:3]}")
    out.update(songs=len(songs), batch_ms=batch_ms,
               songs_per_s=n_songs / (sum(batch_ms) / 1e3),
               fallbacks=fallbacks, clip_p50_ms=p50, identical=identical)

    # mutate: a host addition merged into the store, a delete, a save
    extra = first_id + len(batches) * RESIDENT_BATCH
    t = time.perf_counter()
    st = res.ingest_channels(f"song{extra:05d}", [_song(extra)])
    merged_ok = res._dev_store is not None and res._host_stale
    gone = new_ids[1]
    removed = res.delete_songs(
        [d["song_id"] for d in res.catalog.get_songs()
         if d["song_name"] == f"song{gone:05d}"])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "resident.npz")
        res.save_index(path)
        out["mutate_s"] = time.perf_counter() - t
        fresh = SIA(device=sia.device)
        res.catalog.conn.backup(fresh.catalog.conn)
        fresh.load_index(path)
        report = check_integrity(fresh, deep=True)
    checked = [(c, s_, f) for s_, f, c in jobs if s_ != gone][:3]
    frame = 100
    checked.append((_song(extra)[frame * HOP: frame * HOP + clip_len],
                    extra, frame))
    def top1(s_, c):
        a = _answer(s_.recognize_samples([c]))
        return a["song_id"], a["offset"]

    same = all(top1(fresh, c) == top1(res, c)
               and _right(fresh.recognize_samples([c]), s_, f * HOP / FS)
               for c, s_, f in checked)
    print(f"mutation: ingest_channels merged into the store "
          f"({st['hashes']} rows, store kept {merged_ok}); delete of song "
          f"{gone}: {removed} rows; save_index; a fresh SIA from the file: "
          f"fsck {'ok' if report['ok'] else report['errors']}, 4 clips "
          f"{'alike' if same else 'DIFFER'}; {out['mutate_s']:.3f} s",
          flush=True)
    if not (merged_ok and st["ingested"] == 1 and removed > 0
            and report["ok"] and same):
        raise AssertionError("resident mutation round failed")
    del fresh

    before = [_answer(res.recognize_clip(c)) for _s, _f, c in big_clips[:8]]
    # the probe's peak is the store's own: drop the host-backed SIA's
    # uploaded index and the allocator's cached blocks first
    sia._device_index = None
    if sia.device.type == "cuda":
        torch.cuda.empty_cache()
    out["scale_probe"] = _scale_probe(res, seed)
    after, lat = [], []
    for sid, frame, c in big_clips[:8]:
        t = time.perf_counter()
        r = res.recognize_clip(c)
        lat.append(1e3 * (time.perf_counter() - t))
        if not _right(r, sid, frame * HOP / FS):
            raise AssertionError(f"clip of {sid} wrong at {PROBE_AT[-1]} "
                                 f"rows: {r['results'][:1]}")
        after.append(_answer(r))
    if not all(_same_answer(a, b) for a, b in zip(before, after)):
        raise AssertionError(f"answers changed at {PROBE_AT[-1]} rows: "
                             f"{before[:2]} {after[:2]}")
    out["probe_clips"] = {"answers": after, "ms": lat,
                          "p50_ms": float(np.median(lat))}
    print(f"8 catalog clips at {PROBE_AT[-1]} rows: answers right and "
          f"unchanged, recognize_clip p50 {np.median(lat):.3f} ms, max "
          f"{max(lat):.3f} ms", flush=True)
    res._dev_store = None
    del res, store
    if sia.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def spans(sia, big_clips, first_id: int) -> dict:
    """Phase 8 on phase 7's catalog: ``SIA(device_span_rows=SPAN_ROWS)``
    from the same index and a copy of the catalog ingests one device batch
    of SPAN_SONGS new songs, ``save_index`` writes the span-wise file, and
    fresh SIAs load it spanned (straight onto the store), spanned with
    ``stacked=True`` and plain (flattened on the host): each must hold the
    spanned SIA's rows and give its answers, identical, to SPAN_CLIPS
    clips (half of the new songs, half of phase 4's). Save and load
    seconds are recorded."""
    import tempfile

    import torch

    from shazam_tpu_torch.api import SIA

    out = {}
    dev = sia.device
    ids = list(range(first_id, first_id + SPAN_SONGS))
    with mp.get_context("spawn").Pool(os.cpu_count() or 1) as pool:
        songs = dict(zip(ids, pool.map(_song, ids)))
        pool.close()
        pool.join()

    t = time.perf_counter()
    sp = SIA(index=sia.index, device_span_rows=SPAN_ROWS, device=dev)
    sia.catalog.conn.backup(sp.catalog.conn)
    sp._ensure_dev_store()
    _sync(dev)
    out["from_host_s"] = time.perf_counter() - t
    mat = np.zeros((SPAN_SONGS, 6 << 18), np.int16)
    for r, i in enumerate(ids):
        mat[r, : len(songs[i])] = songs[i]
    x = torch.from_numpy(mat).to(dev).to(torch.float32)
    _sync(dev)
    t = time.perf_counter()
    st = sp.ingest_device_batch([f"song{i:05d}" for i in ids], x,
                                [len(songs[i]) for i in ids])
    _sync(dev)
    out["ingest_ms"] = 1e3 * (time.perf_counter() - t)
    if st["ingested"] != SPAN_SONGS or st["overflowed"]:
        raise AssertionError(f"spanned ingest_device_batch: {st}")
    rows = sp.index

    clip_len = int(BIG_CLIP_S * FS)
    max_frame = (int(30.0 * FS) - clip_len) // HOP
    jobs = [(i, f, songs[i][f * HOP: f * HOP + clip_len]) for i, f in
            zip(ids, np.random.default_rng(first_id).integers(
                0, max_frame + 1, SPAN_CLIPS // 2).tolist())]
    jobs += list(big_clips[: SPAN_CLIPS - len(jobs)])
    sias = {"spanned": sp}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "spanned.npz")
        t = time.perf_counter()
        sp.save_index(path)
        out["save_s"] = time.perf_counter() - t
        out["file_mb"] = os.path.getsize(path) / 1e6
        with np.load(path) as z:
            n_spans = sum(k.endswith("_hi") for k in z.files)
            meta = z["spanned_meta"].tolist()
        if n_spans != -(-rows.n_hashes // SPAN_ROWS) or meta[0] != SPAN_ROWS:
            raise AssertionError(f"span-wise file: {n_spans} spans, {meta}")
        out["load_s"] = {}
        for label, span_rows, kw in (("loaded", SPAN_ROWS, {}),
                                     ("stacked", SPAN_ROWS, {"stacked": True}),
                                     ("plain", 0, {})):
            s2 = SIA(device_span_rows=span_rows, device=dev)
            sp.catalog.conn.backup(s2.catalog.conn)
            t = time.perf_counter()
            s2.load_index(path, **kw)
            if span_rows and not (s2._dev_store is not None
                                  and s2._host_stale):
                raise AssertionError(f"{label}: not loaded onto the store")
            s2._ensure_device_index()
            _sync(dev)
            out["load_s"][label] = time.perf_counter() - t
            sias[label] = s2
    same_rows = {k: _rows_equal(s_.index, rows) for k, s_ in sias.items()}
    answers, p50 = {}, {}
    for label, s_ in sias.items():
        lat = []
        answers[label] = []
        for sid, frame, c in jobs:
            t = time.perf_counter()
            r = s_.recognize_clip(c)
            lat.append(1e3 * (time.perf_counter() - t))
            if not _right(r, sid, frame * HOP / FS):
                raise AssertionError(f"{label} SIA: clip of {sid} wrong: "
                                     f"{r['results'][:1]}")
            answers[label].append(_answer(r))
        p50[label] = float(np.median(lat))
    identical = {k: v == answers["spanned"] for k, v in answers.items()}
    print(f"spans: {rows.n_hashes} rows in {n_spans} spans of {SPAN_ROWS}; "
          f"from_host {out['from_host_s']:.3f} s, ingest_device_batch of "
          f"{SPAN_SONGS} songs {out['ingest_ms']:.3f} ms; save_index "
          f"{out['save_s']:.3f} s ({out['file_mb']:.1f} MB); load_index "
          + ", ".join(f"{k} {v:.3f} s" for k, v in out["load_s"].items())
          + f"; rows equal {same_rows}; {len(jobs)} clips right, answers "
          f"identical {identical}; recognize_clip p50 ms "
          + ", ".join(f"{k} {v:.3f}" for k, v in p50.items()), flush=True)
    if not (all(same_rows.values()) and all(identical.values())):
        raise AssertionError("spanned round trip differs")
    out.update(rows=rows.n_hashes, spans=n_spans, clip_p50_ms=p50)
    for s_ in sias.values():
        s_._dev_store = None
        s_._device_index = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _phase_ms(fn, on_card: bool, calls: int = 10) -> float:
    """Milliseconds per call: CUDA events on the card, the host clock on
    the CPU (a rehearsal's number, never a device time)."""
    fn()
    if on_card:
        return _event_ms(fn, calls)
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    return 1e3 * (time.perf_counter() - t) / calls


def parallel(sia, big_clips, first_id: int) -> dict:
    """Phase 9 on phase 7's host-backed SIA: the sharded path
    (``shazam_tpu_torch/parallel``) at one rank per card, in the order of
    the JAX package's ``dryrun_multichip``. ``make_mesh`` starts a
    one-rank group (NCCL on the card); then (1) ``sharded_ingest_step`` of
    PARALLEL_INGEST_ROWS 30 s songs equals ``fingerprint_batch_fused`` row
    for row; (2) ``ShardedCatalog`` in both regimes (by-song by default
    here, key-range with ``dense_limit_bytes=2^30``) answers
    PARALLEL_CLIPS of phase 4's 15 s clips through ``ShardedRecognizer``,
    each right and equal to ``SIA.recognize_samples`` by phase 5's rule,
    and one dense-histogram all-reduce and one candidate gather are timed;
    (3) early exit on the key-range regime keeps the full match's top-1;
    (4) an HTTP daemon over the recognizer answers as the recognizer
    does and refuses a mutation, and a stream session over it is right;
    (5) ``sequence_parallel_fingerprint`` of a 30 s song equals
    ``fingerprint_samples``; (6) ``distributed_ingest_arrays`` of
    PARALLEL_NEW_SONGS new songs answers PARALLEL_NEW_CLIPS clips alike
    before and after ``save_local_shards`` / ``load_local_shards``."""
    import tempfile

    import torch
    import torch.distributed as dist

    from shazam_tpu_torch.client import SIAClient, SIAServerError
    from shazam_tpu_torch.match.prepare import prepare_query
    from shazam_tpu_torch.ops.fingerprint import (fingerprint_batch,
                                                  fingerprint_batch_fused,
                                                  fingerprint_samples)
    from shazam_tpu_torch.parallel.mesh import make_mesh
    from shazam_tpu_torch.parallel.multihost import (SpannedCatalog,
                                                     distributed_ingest_arrays)
    from shazam_tpu_torch.parallel.sequence import \
        sequence_parallel_fingerprint
    from shazam_tpu_torch.parallel.serving import (ShardedCatalog,
                                                   ShardedRecognizer)
    from shazam_tpu_torch.parallel.sharded import (all_gather_cat, all_sum,
                                                   sharded_ingest_step,
                                                   sharded_match_apriori)
    from shazam_tpu_torch.serve import RecognitionServer
    from shazam_tpu_torch.stream import CHUNK, StreamRecognizer

    dev = sia.device
    on_card = dev.type == "cuda"
    out, secs = {}, {}
    t = time.perf_counter()
    mesh = make_mesh(device=dev)
    out.update(backend=mesh.backend, world_size=mesh.size)
    print(f"parallel: {mesh.backend} group of {mesh.size} rank(s) on {dev}",
          flush=True)
    row_ids = list(range(PARALLEL_INGEST_ROWS))
    new_ids = list(range(first_id, first_id + PARALLEL_NEW_SONGS))
    with mp.get_context("spawn").Pool(os.cpu_count() or 1) as pool:
        songs = dict(zip(row_ids + new_ids, pool.map(_song, row_ids + new_ids)))
        pool.close()
        pool.join()
    secs["setup"] = time.perf_counter() - t
    try:
        # (1) data-parallel ingest at phase 3's ingest shape
        t = time.perf_counter()
        rows = np.zeros((len(row_ids), 6 << 18), np.int16)
        n_valid = np.array([len(songs[i]) for i in row_ids], np.int32)
        for r, i in enumerate(row_ids):
            rows[r, : n_valid[r]] = songs[i]
        fp = sharded_ingest_step(mesh, rows, n_valid, peak_capacity=16384)
        ref = (fingerprint_batch_fused if on_card else fingerprint_batch)(
            torch.from_numpy(rows).to(dev).to(torch.float32),
            torch.from_numpy(n_valid).to(dev), peak_capacity=16384)
        same = [all(torch.equal(a[r], b[r]) for a, b in zip(fp, ref))
                for r in range(len(row_ids))]
        if not all(same):
            raise AssertionError(f"sharded_ingest_step rows differ: {same}")
        out["ingest_step"] = {"rows": len(row_ids), "shape": list(rows.shape),
                              "hashes": int(fp.valid.sum())}
        secs["ingest_step"] = time.perf_counter() - t

        # (2) both regimes against the SIA
        t = time.perf_counter()
        clips = big_clips[:PARALLEL_CLIPS]
        solo, solo_lat = [], []
        for sid, frame, c in clips:
            t1 = time.perf_counter()
            r = sia.recognize_samples([c])
            solo_lat.append(1e3 * (time.perf_counter() - t1))
            solo.append(_answer(r))
        recs, regimes = {}, {}
        for label, kw in (("by_song", {}),
                          ("key_range", {"dense_limit_bytes": 1 << 30})):
            t1 = time.perf_counter()
            cat = ShardedCatalog(sia.index, mesh=mesh, config=sia.config,
                                 catalog=sia.catalog, **kw)
            _sync(dev)
            build_s = time.perf_counter() - t1
            if cat.regime != label:
                raise AssertionError(f"regime {cat.regime}, want {label}")
            rec = recs[label] = ShardedRecognizer(cat)
            answers, lat = [], []
            for sid, frame, c in clips:
                t1 = time.perf_counter()
                r = rec.recognize_samples([c])
                lat.append(1e3 * (time.perf_counter() - t1))
                if not _right(r, sid, frame * HOP / FS):
                    raise AssertionError(f"{label}: clip of {sid} wrong: "
                                         f"{r['results'][:1]}")
                answers.append(_answer(r))
            regimes[label] = {"answers": answers, "build_s": build_s,
                              "clip_p50_ms": float(np.median(lat)),
                              "stats": cat.stats()}
        # the by-song regime never accepts a clamp, so its counts are the
        # exact ones two decided runs are held to (phase 5's rule)
        exact = regimes["by_song"]["answers"]
        for label, reg in regimes.items():
            bad = [(clips[j][:2], solo[j], a) for j, a in
                   enumerate(reg.pop("answers"))
                   if not _same_answer(solo[j], a, exact[j])]
            if bad:
                raise AssertionError(f"{label} differs from the SIA: "
                                     f"{bad[:3]}")
        cat = recs["key_range"].cat
        hist = torch.zeros(max(cat.n_songs, 1) * cat._delta_range_for(1024),
                           dtype=torch.int32, device=dev)
        cand = torch.zeros((max(sia.config.topn, 2), 4), dtype=torch.int64,
                           device=dev)
        out["regimes"] = regimes
        out["sia_clip_p50_ms"] = float(np.median(solo_lat))
        out["allreduce_mb"] = hist.numel() * 4 / 1e6
        out["allreduce_ms"] = _phase_ms(lambda: all_sum(mesh, hist), on_card)
        out["gather_ms"] = _phase_ms(lambda: all_gather_cat(mesh, cand),
                                     on_card)
        print(f"parallel: {len(clips)} clips right in both regimes and equal "
              f"to the SIA; clip p50 ms: SIA {out['sia_clip_p50_ms']:.3f}, "
              + ", ".join(f"{k} {v['clip_p50_ms']:.3f} (built in "
                          f"{v['build_s']:.3f} s)" for k, v in regimes.items())
              + f"; dense-histogram all-reduce of {out['allreduce_mb']:.1f} "
              f"MB {out['allreduce_ms']:.4f} ms, candidate gather "
              f"{out['gather_ms']:.4f} ms", flush=True)
        secs["regimes"] = time.perf_counter() - t

        # (3) early exit on the key-range regime
        t = time.perf_counter()
        rec = recs["key_range"]
        cat = rec.cat
        lat, rounds = [], []
        for sid, frame, c in clips[:PARALLEL_EARLY_CLIPS]:
            full = _answer(rec.recognize_samples([c]))
            t1 = time.perf_counter()
            part = _answer(rec.recognize_samples([c], early_exit=True))
            lat.append(1e3 * (time.perf_counter() - t1))
            if (part["song_id"], part["offset"]) != (full["song_id"],
                                                     full["offset"]):
                raise AssertionError(f"early exit on the clip of {sid}: "
                                     f"{part} against {full}")
            # the rounds behind it: [used, of, a round past its cap (then
            # match_apriori runs the full match)]
            q = prepare_query([rec._fp._fingerprint_channel(c)])
            qf = cat._q_frames_for(q)
            _raw, used, clamped = sharded_match_apriori(
                mesh, cat._shards, q, n_songs=max(cat.n_songs, 1),
                delta_min=-qf, delta_range=cat._delta_range_for(qf),
                match_capacity=sia.config.match_capacity,
                topn=sia.config.topn)
            rounds.append([used, -(-q.n_pairs // 1024), clamped])
        out["early_exit"] = {
            "clips": len(lat), "p50_ms": float(np.median(lat)),
            "rounds": rounds,
            "stopped_early": sum(u < n and not c for u, n, c in rounds),
            "full_match_fallbacks": sum(c for _u, _n, c in rounds)}
        secs["early_exit"] = time.perf_counter() - t

        # (4) the daemon and a stream session over the recognizer
        t = time.perf_counter()
        rec = recs["by_song"]
        srv = RecognitionServer(rec, port=0, max_batch=16, max_wait_ms=10)
        srv.start_background()
        try:
            client = SIAClient(f"http://127.0.0.1:{srv.port}")
            daemon = clips[:PARALLEL_DAEMON_CLIPS]
            got = [client.recognize(c, fs=FS) for _, _, c in daemon]
            want = [rec.recognize_samples([c]) for _, _, c in daemon]
            bad = [(sid, _answer(a), _answer(b)) for (sid, frame, _), a, b
                   in zip(daemon, got, want)
                   if _answer(a) != _answer(b)
                   or not _right(a, sid, frame * HOP / FS)]
            if bad:
                raise AssertionError(f"daemon over the recognizer: {bad[:3]}")
            try:
                client.ingest("refused", daemon[0][2], fs=FS)
                refused = None
            except SIAServerError as e:
                refused = e.message
            if not refused or "online catalog mutation" not in refused:
                raise AssertionError(f"mutation not refused: {refused}")
        finally:
            srv.close()
        sid, frame, c = clips[0]
        sr = StreamRecognizer(rec, channels=1, window_seconds=STREAM_WINDOW_S)
        for a in range(0, len(c) - CHUNK + 1, CHUNK):
            sr.feed(c[a: a + CHUNK])
        res = sr.recognize()
        start = frame * HOP + sr._fps[0].window_sample_range()[0]
        if not _right(res, sid, start / FS) or sr.fallbacks:
            raise AssertionError(f"stream over the recognizer: "
                                 f"{res['results'][:1]}, fallbacks "
                                 f"{sr.fallbacks}")
        out["daemon"] = {"requests": len(got), "refused": refused}
        secs["daemon_stream"] = time.perf_counter() - t

        # (5) sequence parallel: one 30 s song
        t = time.perf_counter()
        song = songs[row_ids[0]].astype(np.float32)
        pad = np.zeros(-(-len(song) // (mesh.size * HOP)) * mesh.size * HOP,
                       np.float32)
        pad[: len(song)] = song
        seq = sequence_parallel_fingerprint(mesh, pad, len(song),
                                            peak_capacity=16384)
        one = fingerprint_samples(torch.from_numpy(pad).to(dev), len(song),
                                  peak_capacity=16384)
        if not all(torch.equal(a, b) for a, b in zip(seq, one)):
            raise AssertionError("sequence_parallel_fingerprint differs from "
                                 "fingerprint_samples")
        out["sequence"] = {"samples": len(song), "n_peaks": int(seq.n_peaks),
                           "hashes": int(seq.valid.sum())}
        secs["sequence"] = time.perf_counter() - t

        # (6) distributed ingest, save, load
        t = time.perf_counter()
        names = [f"song{i:05d}" for i in new_ids]
        spanned, local = distributed_ingest_arrays(
            names, lambda s: songs[new_ids[s]], config=sia.config, mesh=mesh)
        rng = np.random.default_rng(first_id)
        clip_len = int(BIG_CLIP_S * FS)
        max_frame = (int(30.0 * FS) - clip_len) // HOP
        picks = [(s, int(rng.integers(0, max_frame + 1))) for s in
                 rng.choice(len(new_ids), PARALLEL_NEW_CLIPS, replace=False)]
        queries = [prepare_query([local._fingerprint_channel(
            songs[new_ids[s]][f * HOP: f * HOP + clip_len])])
            for s, f in picks]

        def answers(cat):
            res = [cat.match(q, topn=2, config=sia.config) for q in queries]
            return [[(r["song_id"], r["offset"], r["hashes_matched_in_input"])
                     for r in m.results] + [m.total_matches] for m in res]

        before = answers(spanned)
        wrong = [(s, f, a[:1]) for (s, f), a in zip(picks, before)
                 if a[0][:2] != (s, f)]
        if wrong:
            raise AssertionError(f"distributed ingest answers: {wrong[:3]}")
        with tempfile.TemporaryDirectory() as tmp:
            path = spanned.save_local_shards(tmp)
            file_mb = os.path.getsize(path) / 1e6
            after = answers(SpannedCatalog.load_local_shards(tmp, mesh=mesh))
        if after != before:
            raise AssertionError("shard files answer differently")
        out["distributed_ingest"] = {
            "songs": len(new_ids), "rows": int(spanned._shard.n_rows),
            "clips": len(picks), "file_mb": file_mb}
        secs["distributed_ingest"] = time.perf_counter() - t
        print(f"parallel: ingest step {out['ingest_step']}, early exit "
              f"{out['early_exit']}, daemon {out['daemon']['requests']} "
              f"answers and a refused mutation, stream right, sequence "
              f"{out['sequence']}, distributed ingest "
              f"{out['distributed_ingest']}", flush=True)
    finally:
        recs = None
        dist.destroy_process_group()
        if on_card:
            torch.cuda.empty_cache()
    out["seconds"] = secs
    print(f"phase 9 seconds: { {k: round(v, 3) for k, v in secs.items()} }",
          flush=True)
    return out


def delta_votes(clip_fp, song_fp) -> dict:
    """Votes per offset, counted apart from the match path: for each delta
    d (frames), how many of the clip's distinct (hash, frame) pairs the
    song holds at frame + d. numpy over two fingerprint sets; the
    recognizer's top offset is where this count peaks."""
    def pairs(fp):
        keep = fp.valid.cpu().numpy()
        return np.unique(np.stack([getattr(fp, c).cpu().numpy()[keep]
                                   for c in ("hi", "lo", "ex", "t1")], 1),
                         axis=0)

    q, s = pairs(clip_fp), pairs(song_fp)
    _, key = np.unique(np.concatenate([q[:, :3], s[:, :3]]), axis=0,
                       return_inverse=True)
    key = key.reshape(-1)
    qk, sk = key[: len(q)], key[len(q):]
    order = np.argsort(sk, kind="stable")
    first = np.searchsorted(sk[order], qk, "left")
    n = np.searchsorted(sk[order], qk, "right") - first
    within = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    song_rows = order[np.repeat(first, n) + within]
    deltas, votes = np.unique(
        s[song_rows, 3] - np.repeat(q[:, 3], n), return_counts=True)
    return dict(zip(deltas.tolist(), votes.tolist()))


def recognition_sweep(device, seed: int) -> dict:
    """Phase 10 on a fresh device-resident SIA: the reference's 100-record
    accuracy sweep. ``make_music_gen`` renders SWEEP_SONGS music-like
    songs of SWEEP_SONG_S on the card in batches of SWEEP_BATCH, and
    ``ingest_device_batch`` takes each batch straight from the card (no
    row may overflow). Each song is written as a mono int16 WAV, beside a
    seeded SWEEP_NOISE_S noise WAV, into a temporary directory deleted at
    the end. ``bench.harness.run_recognition_sweep`` then runs four sweeps
    of SWEEP_CLIP_S clips over the files: clean, AWGN at 0 dB, the noise
    file at 0 dB and the acoustic channel at ``CALIBRATED_SEVERITY``.
    Limits: clean accuracy at least SWEEP_MIN_CLEAN; SWEEP_RECHECK clean
    clips, re-cut from the results CSV's start times, give the sweep's
    song and offset through ``recognize_samples``; at least
    SWEEP_MIN_AT_START of the right answers are at their start within
    0.1 s, and every right answer's offset is where ``delta_votes``
    peaks; every checkpoint wrote its five files; the final CSV has a
    row per song, and its mean ``correct``
    equals the summary's accuracy and the ``ASSK_`` file's. The noisy and
    channel sweeps have no accuracy limit. Last, ``plot_constellation``
    renders the first SWEEP_PLOT_S of song 0 where matplotlib is
    installed, and ``utils.profiling.device_trace`` traces one clean clip
    into a Chrome trace that must hold CUDA kernel events on the card."""
    import csv
    import importlib.util
    import tempfile

    import torch

    from shazam_tpu_torch.api import SIA
    from shazam_tpu_torch.audio.channel import CALIBRATED_SEVERITY
    from shazam_tpu_torch.audio.io import read, write_wav
    from shazam_tpu_torch.audio.synth_device import make_music_gen
    from shazam_tpu_torch.bench.harness import (BenchConfig,
                                                run_recognition_sweep)
    from shazam_tpu_torch.utils.profiling import device_trace

    on_card = device.type == "cuda"
    out, secs = {}, {}
    t_phase = time.perf_counter()
    sia = SIA(device_resident=True, device=device)
    gen = make_music_gen(SWEEP_SONG_S, seed=77, device=device)
    render_s = ingest_s = write_s = 0.0
    with tempfile.TemporaryDirectory() as tmp:
        songs_dir = os.path.join(tmp, "songs")
        os.makedirs(songs_dir)
        files = []
        for first in range(0, SWEEP_SONGS, SWEEP_BATCH):
            ids = list(range(first, min(first + SWEEP_BATCH, SWEEP_SONGS)))
            t = time.perf_counter()
            x = gen(ids)
            _sync(device)
            render_s += time.perf_counter() - t
            names = [f"track{i:06d}" for i in ids]
            t = time.perf_counter()
            st = sia.ingest_device_batch(names, x, [gen.n_samp] * len(ids))
            _sync(device)
            ingest_s += time.perf_counter() - t
            if st["ingested"] != len(ids) or st["overflowed"]:
                raise AssertionError(f"sweep ingest of {ids[0]}-{ids[-1]}: "
                                     f"{st}")
            out["retried_rows"] = (out.get("retried_rows", 0)
                                   + st.get("fallbacks", 0))
            t = time.perf_counter()
            pcm = x[:, : gen.n_samp].to(torch.int16).cpu().numpy()
            for name, row in zip(names, pcm):
                files.append(os.path.join(songs_dir, name + ".wav"))
                write_wav(files[-1], row, FS)
            write_s += time.perf_counter() - t
            del x
        rows = sia._live_n_hashes()
        counts = sia.catalog.counts()
        if counts["n_songs"] != SWEEP_SONGS or counts["n_hashes"] != rows:
            raise AssertionError(f"catalog {counts}, want {SWEEP_SONGS} "
                                 f"songs and the store's {rows} rows")
        noise_path = os.path.join(tmp, "noise.wav")
        noise = np.random.default_rng(seed + 10).normal(
            0.0, 0.3, int(SWEEP_NOISE_S * FS)) * 32767.0
        write_wav(noise_path, np.clip(noise, -32768, 32767).astype(np.int16),
                  FS)
        secs.update(render=render_s, ingest=ingest_s, write=write_s)
        out.update(songs=SWEEP_SONGS, song_s=SWEEP_SONG_S, rows=rows,
                   render_songs_per_s=SWEEP_SONGS / render_s,
                   ingest_songs_per_s=SWEEP_SONGS / ingest_s,
                   files_gb=sum(os.path.getsize(f) for f in files) / 1e9)
        print(f"sweep: rendered {SWEEP_SONGS} x {SWEEP_SONG_S:g} s songs on "
              f"{device} in {render_s:.3f} s ({out['render_songs_per_s']:.2f} "
              f"songs/s), ingest_device_batch {ingest_s:.3f} s, {rows} rows "
              f"({rows / SWEEP_SONGS:.1f} a song), {out['retried_rows']} rows "
              f"retried at 2x capacity, none overflowed; WAVs "
              f"{out['files_gb']:.3f} GB in {write_s:.3f} s", flush=True)

        q = SWEEP_SONGS // 4
        marks = len({q, 2 * q, 3 * q, SWEEP_SONGS - 1})   # the harness's
        sweeps = {}
        for k, (label, kw) in enumerate((
                ("clean", {}),
                ("awgn_0db", dict(add_noise=True, snr_db=0.0,
                                  noise_kind="awgn")),
                ("file_0db", dict(add_noise=True, snr_db=0.0,
                                  noise_kind="file", noise_file=noise_path)),
                ("channel", dict(channel=True,
                                 channel_severity=CALIBRATED_SEVERITY)))):
            t = time.perf_counter()
            cfg = BenchConfig(record_seconds=SWEEP_CLIP_S, seed=seed + k,
                              out_dir=os.path.join(tmp, label), **kw)
            summary = run_recognition_sweep(sia, files, cfg)
            secs[label] = time.perf_counter() - t
            arts = summary["artifacts"]
            missing = [p for a in arts for kind, p in a.items()
                       if kind != "accuracy" and not os.path.exists(p)]
            if len(arts) != marks or missing:
                raise AssertionError(f"{label}: {len(arts)} checkpoints, "
                                     f"missing {missing}")
            with open(arts[-1]["results"], newline="") as fh:
                table = list(csv.DictReader(fh))
            with open(arts[-1]["assk"]) as fh:
                assk = float(fh.read().splitlines()[1].split(",")[1])
            mean_correct = float(np.mean([int(r["correct"]) for r in table]))
            if (len(table) != SWEEP_SONGS
                    or not mean_correct == summary["accuracy"] == assk):
                raise AssertionError(
                    f"{label}: {len(table)} rows, mean correct "
                    f"{mean_correct}, accuracy {summary['accuracy']}, "
                    f"ASSK {assk}")

            def p50(col):
                return float(np.median([float(r[col]) for r in table]))

            ref_note = SWEEP_REFERENCE_NOTE.get(label)
            sweeps[label] = {
                "accuracy": summary["accuracy"],
                "reference": SWEEP_REFERENCE.get(label),
                "reference_note": ref_note,
                "total_p50_s": summary["p50_total_time"],
                "total_mean_s": summary["mean_total_time"],
                "fingerprint_p50_s": p50("fingerprint_times"),
                "query_p50_s": p50("query_time"),
                "align_p50_s": p50("align_time"),
                "checkpoints": len(arts), "seconds": secs[label]}
            print(f"sweep {label}: accuracy {summary['accuracy']} "
                  f"(reference {SWEEP_REFERENCE.get(label) or 'none'}"
                  f"{', ' + ref_note if ref_note else ''}); "
                  f"total_time p50 {1e3 * summary['p50_total_time']:.3f} ms, "
                  f"mean {1e3 * summary['mean_total_time']:.3f} ms; p50 "
                  f"fingerprint {1e3 * p50('fingerprint_times'):.3f}, query "
                  f"{1e3 * p50('query_time'):.3f}, align "
                  f"{1e3 * p50('align_time'):.3f} ms; {secs[label]:.3f} s",
                  flush=True)
            if label == "clean":
                clean = table
        out["sweeps"] = sweeps
        if sweeps["clean"]["accuracy"] < SWEEP_MIN_CLEAN:
            raise AssertionError(f"clean accuracy {sweeps['clean']} under "
                                 f"{SWEEP_MIN_CLEAN}")

        # the sweep's answers, re-asked of recognize_samples alone: the
        # same song and offset. Then the offset of every right answer: at
        # the clip's start within 0.1 s for at least SWEEP_MIN_AT_START of
        # them, and for each where delta_votes, counted from the clip's
        # and the whole song's fingerprints, peaks (ties allowed). A clip
        # answered elsewhere is where the song matches it best: there its
        # votes are at least its start's.
        clip_len = int(SWEEP_CLIP_S * FS)
        t = time.perf_counter()

        def said(row, key):
            got = re.search(rf"'{key}': ([-0-9.e]+)", row["final_results"])
            return float(got.group(1)) if got else None

        def cut(row):
            ch, _, _ = read(row["file_name_played"])
            start = int(row["song_start_time"])
            return ch[0], ch[0][start * FS: start * FS + clip_len], start

        for r in clean[:SWEEP_RECHECK]:
            _, clip, start = cut(r)
            res = sia.recognize_samples([clip])["results"]
            got = (res[0]["song_name"], res[0]["offset_seconds"]) if res \
                else ("No results", None)
            if got != (r["file_name_result"], said(r, "offset_seconds")):
                raise AssertionError(
                    f"{r['file_name_played']} at {start} s: {got}, the sweep "
                    f"said {r['file_name_result']} "
                    f"({r['final_results'][:200]})")
        right = [r for r in clean if r["correct"] == "1"]
        at_start, elsewhere = 0, []
        for r in right:
            song, clip, start = cut(r)
            off = int(said(r, "offset"))
            votes = delta_votes(sia._fingerprint_channel(clip),
                                sia._fingerprint_channel(song))
            start_votes = max(votes.get(int(start * FS // HOP) + k, 0)
                              for k in (0, 1))
            if votes.get(off, 0) != max(votes.values()):
                raise AssertionError(
                    f"{r['file_name_played']} at {start} s: offset {off} "
                    f"frames has {votes.get(off, 0)} votes, the song's "
                    f"most are {max(votes.values())}")
            if abs(said(r, "offset_seconds") - start) < 0.1:
                at_start += 1
            else:
                elsewhere.append({"start_s": start,
                                  "offset_s": said(r, "offset_seconds"),
                                  "votes": votes[off],
                                  "start_votes": start_votes})
        secs["recheck"] = time.perf_counter() - t
        out["rechecked"] = {"clips": min(SWEEP_RECHECK, len(clean)),
                            "sweep_right": len(right), "at_start": at_start,
                            "elsewhere": elsewhere}
        if at_start < SWEEP_MIN_AT_START * len(right):
            raise AssertionError(f"{at_start} of {len(right)} right answers "
                                 f"at their start, under "
                                 f"{SWEEP_MIN_AT_START}")

        # plot and trace
        if importlib.util.find_spec("matplotlib") is not None:
            from shazam_tpu_torch.tools.plot import plot_constellation

            png = plot_constellation(
                read(files[0], limit=SWEEP_PLOT_S)[0][0],
                os.path.join(tmp, "constellation.png"), device=device)
            out["plot"] = {"rendered": True, "bytes": os.path.getsize(png)}
            if out["plot"]["bytes"] <= 10_000:
                raise AssertionError(f"constellation PNG: {out['plot']}")
        else:
            out["plot"] = {"rendered": False,
                           "reason": "matplotlib is not installed"}
        trace_dir = os.path.join(tmp, "trace")
        ch, _, _ = read(files[0], limit=SWEEP_CLIP_S)
        with device_trace(trace_dir):
            sia.recognize_samples(ch)
        traces = os.listdir(trace_dir)
        with open(os.path.join(trace_dir, traces[0])) as fh:
            events = json.load(fh)["traceEvents"]
        kernels = sum(e.get("cat") == "kernel" for e in events)
        out["trace"] = {"files": len(traces), "events": len(events),
                        "kernel_events": kernels}
        if len(traces) != 1 or (on_card and not kernels):
            raise AssertionError(f"device_trace: {out['trace']}")
        print(f"sweep: {out['rechecked']['clips']} clean clips re-asked "
              f"alone give the sweep's song and offset; of the clean "
              f"sweep's {len(right)} right answers {at_start} are at their "
              f"start within 0.1 s and every offset is where the song's "
              f"votes peak; the others {elsewhere}; plot {out['plot']}; "
              f"device_trace {out['trace']}", flush=True)
    sia._dev_store = None
    sia._device_index = None
    if on_card:
        torch.cuda.empty_cache()
    secs["phase"] = time.perf_counter() - t_phase
    out["seconds"] = secs
    print(f"phase 10 seconds: { {k: round(v, 3) for k, v in secs.items()} }",
          flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--songs", type=int, default=2035)
    ap.add_argument("--clips", type=int, default=32)
    ap.add_argument("--big-songs", type=int, default=BIG_SONGS)
    ap.add_argument("--big-clips", type=int, default=32)
    ap.add_argument("--file-songs", type=int, default=FILE_SONGS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 2 (build and kernel checks)")
    ap.add_argument("--k1-baseline", metavar="PATH",
                    help="an earlier csrc/spectrogram.cu, timed in turns "
                         "with the current K1 in phase 2")
    ap.add_argument("--k2-baseline", metavar="PATH",
                    help="an earlier csrc/peaks.cu, timed in turns with "
                         "the current K2 in phase 2")
    ap.add_argument("--k3-baseline", metavar="PATH",
                    help="the one-block-per-song csrc/compact.cu (commit "
                         "11ffc6f, K3_SONG_BLOCK_ARGTYPES), timed in turns "
                         "with the current K3 in phase 2")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from shazam_tpu_torch import _build
    from shazam_tpu_torch.device import resolve_device

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    device = resolve_device("cuda")

    t0 = time.perf_counter()
    compiled = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.3f} s (nvcc {compiled:.3f} s)",
          flush=True)

    paths = {"spectrogram_power": args.k1_baseline,
             "peak_mask": args.k2_baseline, "compact": args.k3_baseline}
    measured = check_kernels(
        device, _baselines({k: v for k, v in paths.items() if v}))
    if args.kernels_only:
        print(json.dumps(measured), flush=True)
        return 0

    wrappers = _wrappers()
    workers = os.cpu_count() or 1

    def launched(label, phase):
        for k in wrappers.values():
            k.launches = 0
        t = time.perf_counter()
        out = phase()
        counts = {name: k.launches for name, k in wrappers.items()}
        print(f"launches ({label}): {counts}; phase "
              f"{time.perf_counter() - t:.3f} s", flush=True)
        idle = [name for name, n in counts.items() if n == 0]
        if idle:
            raise AssertionError(f"kernels not launched by {label}: {idle}")
        return out, counts

    (sia, e2e_clips, e2e), launches = launched("main path", lambda: end_to_end(
        device, args.songs, args.clips, args.seed, workers))
    early, launches_early = launched("early exit", lambda: early_exit(
        sia, e2e_clips))
    (big_clips, big), launches_big = launched("big catalog", lambda: big_catalog(
        sia, args.songs, args.big_songs, args.big_clips, CHECKED_CLIPS,
        args.seed, workers))
    files, launches_files = launched("files and batches", lambda: files_and_batches(
        sia, args.big_songs, args.file_songs, big_clips, args.seed, workers))
    served, launches_serve = launched("serve and stream", lambda: serve_and_stream(
        sia, big_clips, args.big_songs + args.file_songs, args.big_songs,
        args.file_songs, args.seed, workers))

    def resident():
        with ShapeAudit(sia.config) as audit:
            out = device_resident(sia, big_clips,
                                  args.big_songs + args.file_songs + 2,
                                  args.seed)
        out["twin_audit"] = audit.check()
        print("phase 7's first launch at each shape equal to its plain twin "
              "(K1 in dB): " + "; ".join(
                  f"{name} at {[k for k, _ in v]}, max err "
                  f"{max((e for _, e in v), default=0)}"
                  for name, v in out["twin_audit"].items()), flush=True)
        return out

    resident_out, launches_resident = launched("device resident", resident)

    def spanned():
        with ShapeAudit(sia.config) as audit:
            out = spans(sia, big_clips, args.big_songs + args.file_songs + 2
                        + RESIDENT_BATCHES * RESIDENT_BATCH + 1)
        out["twin_audit"] = audit.check()
        print("phase 8's first launch at each shape equal to its plain twin "
              "(K1 in dB): " + "; ".join(
                  f"{name} at {[k for k, _ in v]}, max err "
                  f"{max((e for _, e in v), default=0)}"
                  for name, v in out["twin_audit"].items()), flush=True)
        return out

    spans_out, launches_spans = launched("spans", spanned)

    def sharded():
        with ShapeAudit(sia.config) as audit:
            out = parallel(sia, big_clips, args.big_songs + args.file_songs
                           + 2 + RESIDENT_BATCHES * RESIDENT_BATCH + 1
                           + SPAN_SONGS)
        out["twin_audit"] = audit.check()
        print("phase 9's first launch at each shape equal to its plain twin "
              "(K1 in dB): " + "; ".join(
                  f"{name} at {[k for k, _ in v]}, max err "
                  f"{max((e for _, e in v), default=0)}"
                  for name, v in out["twin_audit"].items()), flush=True)
        return out

    parallel_out, launches_parallel = launched("parallel", sharded)

    def sweep():
        with ShapeAudit(sia.config) as audit:
            out = recognition_sweep(device, args.seed)
        out["twin_audit"] = audit.check()
        print("phase 10's first launch at each shape equal to its plain twin "
              "(K1 in dB): " + "; ".join(
                  f"{name} at {[k for k, _ in v]}, max err "
                  f"{max((e for _, e in v), default=0)}"
                  for name, v in out["twin_audit"].items()), flush=True)
        return out

    sweep_out, launches_sweep = launched("recognition sweep", sweep)

    report = []
    for name, source, replaces in KERNELS:
        m = measured[name]
        # the top-level numbers are the ingest shape's, the largest
        report.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "launches_early_exit": launches_early[name],
            "launches_big_catalog": launches_big[name],
            "launches_files_batches": launches_files[name],
            "launches_serve_stream": launches_serve[name],
            "launches_device_resident": launches_resident[name],
            "launches_spans": launches_spans[name],
            "launches_parallel": launches_parallel[name],
            "launches_sweep": launches_sweep[name],
            "max_abs_err": max(r["err"] for r in m.values()),
            **{k: m["ingest"][k] for k in (
                "ms", "plain_ms", "device_ms", "bound_ms", "bound_by",
                "library_ms")},
            "shapes": m,
        })
    print(f"whole run {time.perf_counter() - t0:.3f} s", flush=True)
    print(json.dumps({"kernels": report, "end_to_end": e2e,
                      "early_exit": early,
                      "big_catalog": big, "files_and_batches": files,
                      "serve_and_stream": served,
                      "device_resident": resident_out, "spans": spans_out,
                      "parallel": parallel_out, "sweep": sweep_out},
                     default=str),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
