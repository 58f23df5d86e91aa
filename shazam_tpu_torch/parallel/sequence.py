"""Sequence-parallel fingerprinting: ONE song sharded across a group.

The port of ``shazam_tpu/parallel/sequence.py``: a blockwise STFT with
halo exchange.

- the sample axis is split into contiguous chunks, one per rank;
- each rank sends halos to its neighbours (``dist.batch_isend_irecv``,
  the JAX package's ``ppermute`` ring): ``radius`` frames of samples on
  the left and the same plus the window tail on the right, so its local
  spectrogram frames equal the monolithic STFT's and its peak windows
  (21x21: a 10-frame halo) see their true neighbours; the first rank's
  left halo and the last rank's right halo are zeros, as the ring's
  edges are zero-filled;
- per-rank constellation peaks are gathered (``dist.all_gather``) and
  kept in global (t, f) order, and the overflow flags are summed;
- hash pairing needs up to ``max_dt`` frames of lookahead, so it runs on
  the gathered peak set on every rank (the cheap stage).

The local pipeline is the plain dB one (``spectrogram_db`` /
``peak_mask_db`` + compaction / ``generate_hashes``), the counterpart of
the JAX package's XLA stages there, so the result equals
``ops.fingerprint.fingerprint_samples`` of the whole song on one device.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.fingerprint import Fingerprints
from ..ops.hashes import generate_hashes
from ..ops.peaks import compact_plain, pack_mask_bits, peak_mask_db
from ..ops.spectrogram import spectrogram_db
from .mesh import Mesh
from .sharded import all_gather_cat, all_sum


def _exchange_halos(mesh: Mesh, x: torch.Tensor, halo: int, halo_r: int):
    """(left halo, right halo) of this rank's chunk ``x``: the previous
    rank's last ``halo`` samples and the next rank's first ``halo_r``,
    zeros at the ends. No rank sends to itself (a world size of 1 makes
    no point-to-point call at all)."""
    left = x.new_zeros(halo)
    right = x.new_zeros(halo_r)
    r, n = mesh.rank, mesh.size
    ops = []

    def peer(i):
        return dist.get_global_rank(mesh.group, i)

    if r > 0:
        ops += [dist.P2POp(dist.isend, x[:halo_r].contiguous(), peer(r - 1),
                           mesh.group),
                dist.P2POp(dist.irecv, left, peer(r - 1), mesh.group)]
    if r < n - 1:
        ops += [dist.P2POp(dist.isend, x[-halo:].contiguous(), peer(r + 1),
                           mesh.group),
                dist.P2POp(dist.irecv, right, peer(r + 1), mesh.group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return left, right


def sequence_parallel_fingerprint(
    mesh: Mesh,
    samples,
    n_valid_samples,
    *,
    fs: int = 44100,
    wsize: int = 4096,
    hop: int = 2048,
    amp_min: float = 10.0,
    radius: int = 10,
    fan_value: int = 5,
    min_dt: int = 0,
    max_dt: int = 200,
    peak_capacity: int = 8192,
) -> Fingerprints:
    """Fingerprint one channel with its sample axis split over the mesh.

    Every rank passes the whole padded channel and keeps its own chunk;
    the length must divide by n_ranks * hop. Every rank returns the same
    Fingerprints, equal to ``fingerprint_samples`` of the channel on one
    device. ``n_peaks`` is the exact global count, forced above
    ``peak_capacity`` when any rank had to cut its own peaks.
    """
    n = int(samples.shape[0])
    n_dev = mesh.size
    if n % (n_dev * hop):
        raise ValueError("padded length must divide n_devices * hop")
    chunk = n // n_dev
    halo = radius * hop                     # left halo samples
    halo_r = radius * hop + (wsize - hop)   # right halo incl window tail
    if chunk < halo_r:
        # a shorter chunk would truncate the exchanged halos and break the
        # equality at shard boundaries
        raise ValueError(
            f"per-device chunk {chunk} < halo {halo_r} samples: input too "
            f"short for {n_dev}-way sequence parallelism (needs >= "
            f"{n_dev * halo_r} padded samples); use fingerprint_samples"
        )
    frames_per_dev = chunk // hop
    cap_shard = -(-peak_capacity // n_dev)
    d = mesh.rank
    dev = mesh.device

    x = torch.as_tensor(samples[d * chunk:(d + 1) * chunk]).to(
        device=dev, dtype=torch.float32)
    left, right = _exchange_halos(mesh, x, halo, halo_r)
    ext = torch.cat([left, x, right])

    # local frames [t0 - radius, t0 + Tc + radius): frame i of `ext` starts
    # at global sample (t0 - radius + i) * hop, the monolithic STFT's frame
    spec = spectrogram_db(ext, fs=fs, wsize=wsize, hop=hop).T   # (T, F)
    t0 = d * frames_per_dev
    t_glob = torch.arange(spec.shape[0], device=dev) + (t0 - radius)
    n_valid_frames = max((int(n_valid_samples) - wsize) // hop + 1, 0)
    live = (t_glob >= 0) & (t_glob < n_valid_frames)
    spec = torch.where(live[:, None], spec, 0.0)

    # peaks of the rank's own frames (the halos give them true context)
    local_cap = cap_shard * 4
    times_l, freqs_l, n_peaks_l = (a[0] for a in compact_plain(
        pack_mask_bits(peak_mask_db(spec[None], amp_min, radius)),
        local_cap, n_bins=spec.shape[1]))
    kept = torch.arange(local_cap, device=dev) < torch.clamp(n_peaks_l,
                                                             max=local_cap)
    own = kept & (times_l >= radius) & (times_l < radius + frames_per_dev)
    # the true own-peak count and both capacity signals: a dense shard
    # must not drop peaks silently
    cnt_raw = own.sum()
    over_l = (n_peaks_l > local_cap).long() + (cnt_raw > cap_shard).long()
    # own peaks are in (t, f) order; keep the first cap_shard of them
    t_own = torch.zeros(cap_shard, dtype=torch.int64, device=dev)
    f_own = torch.zeros(cap_shard, dtype=torch.int64, device=dev)
    idx = torch.nonzero(own).reshape(-1)[:cap_shard]
    t_own[: len(idx)] = times_l[idx].long() + t0 - radius
    f_own[: len(idx)] = freqs_l[idx].long()
    cnt_own = torch.clamp(cnt_raw, max=cap_shard)

    # ranks are time-ordered and each list is (t, f) ordered: the gathered
    # lists, each cut at its count, are in global order
    gathered = all_gather_cat(mesh, torch.stack([t_own, f_own])[None])
    counts = all_gather_cat(mesh, cnt_own.reshape(1)).tolist()
    keep = torch.cat([torch.arange(cap_shard, device=dev) < c for c in counts])
    all_t = gathered[:, 0].reshape(-1)[keep][:peak_capacity]
    all_f = gathered[:, 1].reshape(-1)[keep][:peak_capacity]
    times = torch.zeros(peak_capacity, dtype=torch.int64, device=dev)
    freqs = torch.zeros(peak_capacity, dtype=torch.int64, device=dev)
    times[: len(all_t)] = all_t
    freqs[: len(all_f)] = all_f

    # the unclamped global count, forced past peak_capacity when any rank
    # cut its list, as the single-device count reports an overflow
    n_true, any_over = all_sum(mesh, torch.stack([cnt_raw, over_l]))
    n_peaks = torch.where(any_over > 0,
                          torch.clamp(n_true, min=peak_capacity + 1), n_true)
    hi, lo, ex, t1, valid = generate_hashes(
        times, freqs, torch.clamp(n_peaks, max=peak_capacity),
        fan_value=fan_value, min_dt=min_dt, max_dt=max_dt)
    return Fingerprints(hi, lo, ex, t1, valid, n_peaks.to(torch.int32))
