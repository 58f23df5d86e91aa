"""The benchmark's own music generator: a frozen copy of the program's
``shazam_tpu_torch/audio/synth_device.py`` (``make_music_gen``), so that a
later change to the program cannot move the yardstick.

Music-like songs rendered on the card from ``(seed, song id)``: sustained
harmonic voices over a chord progression, a melody walk, section dynamics,
a percussion bed and a noise floor, int16-valued float32 samples.
``gen(sids) -> (B, blen)``; a song depends only on (seed, sid,
duration_s), never on the other ids of its batch. Takes a
``torch.device`` (the program's version resolves a name).

One change from the program's version: each voice's phase at the start
of a block is summed on the host in float64 per song. The program sums
it on the device with a float32 ``cumsum`` over the (B, blocks) batch,
whose order of additions depends on the batch's shape, so a song
rendered alone differed from the same song in a batch of 32 by up to
2,769 (PERF.md). Every other step is elementwise, or adds each
percussion hit to samples that no other hit of the same call touches.
"""

from __future__ import annotations

import numpy as np

FS = 44100
BLOCK = 8192
_MAJOR = np.array([0, 2, 4, 5, 7, 9, 11], np.float64)
_MINOR = np.array([0, 2, 3, 5, 7, 8, 10], np.float64)
_DEG = np.arange(24)
# scale tables: degree -> semitone, 3+ octaves of walk headroom
_TABLES = (_MAJOR[_DEG % 7] + 12 * (_DEG // 7),
           _MINOR[_DEG % 7] + 12 * (_DEG // 7))
_PROG_LEN = 8
_NOTE_BLOCKS = np.array([2, 2, 3, 3, 4, 6])
_STEPS = np.array([-2, -1, -1, 1, 1, 2, 3])
_HARMONICS_BASS = (1.0, 0.5, 0.2, 0.0)
_HARMONICS = (1.0, 0.45, 0.22, 0.10)


def _song_params(sid: int, seed: int, n_blocks: int, fs: int,
                 quiet: float) -> dict:
    """One song's draws (host, numpy): per-block arrays of its five
    voices, its scalars, its drum noise and the seed of its noise floor."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, sid]))
    floor_seed = int(rng.integers(0, 1 << 62))
    a4 = 440.0 * 2.0 ** (rng.uniform(-0.5, 0.5) / 12.0)
    key_off = int(rng.integers(0, 12))
    tab = _TABLES[0] if rng.random() < 0.5 else _TABLES[1]

    def degree_hz(deg, octave):
        semis = key_off + tab[np.clip(deg, 0, 23)]
        return a4 * 2.0 ** ((semis - 57.0 + 12.0 * octave) / 12.0)

    bar_blocks = int(rng.integers(8, 17))                # ~1.5-3.2 s
    half_blocks = max(bar_blocks // 2, 1)
    max_bars = n_blocks // 8 + 2                         # bar >= 8 blocks
    blk = np.arange(n_blocks)
    bar_of = blk // bar_blocks
    prog = np.concatenate([[0], rng.integers(1, 6, _PROG_LEN - 1)])
    chord = prog[bar_of % _PROG_LEN]
    # section dynamics: alternate 8-bar quiet/loud contours
    sect_bar = np.where((np.arange(max_bars) // 8) % 2 == 0, quiet, 1.0)
    sect_bar = sect_bar * rng.uniform(0.9, 1.1, max_bars)
    sect = sect_bar[np.clip(bar_of, 0, max_bars - 1)]
    block_s = BLOCK / fs
    ones = np.ones(n_blocks)

    voices = [dict(   # bass: chord root per half-bar, no vibrato
        f=degree_hz(chord, 2), amp=0.9 * sect,
        age=(blk % half_blocks) * block_s, atk=60.0, dec=0.8 * ones,
        vhz=1.0, beta=0.0 * ones, ph0=0.0, h=_HARMONICS_BASS)]
    for off in (0, 2, 4):   # pad: 3 chord tones, per-bar envelope
        f = degree_hz(chord + off, 4)
        vhz = rng.uniform(4.0, 6.0)
        vcents = rng.uniform(4.0, 10.0)
        voices.append(dict(
            f=f, amp=0.35 * sect, age=(blk % bar_blocks) * block_s,
            atk=6.0, dec=0.25 * ones, vhz=vhz,
            beta=f * (2.0 ** (vcents / 1200.0) - 1.0) / vhz,
            ph0=rng.uniform(0.0, 2 * np.pi), h=_HARMONICS))

    # melody: a walk over blocks (sequential: the degree is clipped);
    # notes of 2-6 blocks around octave 5, ~15% rests
    nlen = rng.choice(_NOTE_BLOCKS, n_blocks)
    step = rng.choice(_STEPS, n_blocks)
    ngate = (rng.random(n_blocks) < 0.85).astype(np.float64)
    ndec = rng.uniform(0.8, 2.0, n_blocks)
    deg_b = np.empty(n_blocks, np.int64)
    new_b = np.empty(n_blocks, bool)
    gate_b = np.empty(n_blocks)
    dec_b = np.empty(n_blocks)
    deg, left, gate, dec = 10, 0, 1.0, 1.0
    for b in range(n_blocks):
        new = left <= 0
        if new:
            deg = min(max(deg + int(step[b]), 4), 20)
            gate, dec, left = ngate[b], ndec[b], int(nlen[b])
        deg_b[b], new_b[b], gate_b[b], dec_b[b] = deg, new, gate, dec
        left -= 1
    last_new = np.maximum.accumulate(np.where(new_b, blk, 0))
    vhz = rng.uniform(4.5, 6.5)
    vcents = rng.uniform(8.0, 25.0)
    f_mel = degree_hz(deg_b, 4)
    voices.append(dict(
        f=f_mel, amp=0.75 * sect * gate_b, age=(blk - last_new) * block_s,
        atk=30.0, dec=dec_b, vhz=vhz,
        beta=f_mel * (2.0 ** (vcents / 1200.0) - 1.0) / vhz,
        ph0=rng.uniform(0.0, 2 * np.pi), h=_HARMONICS))

    slen, hlen = int(0.07 * fs), int(0.02 * fs)
    snoise = rng.normal(0.0, 1.0, slen)
    snare = (snoise - 0.5 * np.concatenate([[0.0], snoise[:-1]])) * np.exp(
        -np.arange(slen) / (0.012 * fs))
    hnoise = rng.normal(0.0, 1.0, hlen)
    hat = np.diff(hnoise, prepend=0.0) * np.exp(-np.arange(hlen) / (0.004 * fs))
    return dict(voices=voices, bar_samp=bar_blocks * BLOCK, sect_bar=sect_bar,
                snare=snare, hat=hat, floor_seed=floor_seed)


def block_phase(f_hz, fs: int) -> np.ndarray:
    """A voice's phase (mod 2 pi) at the start of each block: the running
    sum of its per-block phase steps, in float64 on the host, one song
    at a time."""
    step = 2.0 * np.pi * np.asarray(f_hz, np.float64) / fs * BLOCK
    return np.remainder(np.concatenate([[0.0], np.cumsum(step)[:-1]]),
                        2.0 * np.pi)


def make_music_gen(duration_s: float, fs: int = FS, seed: int = 77,
                   level: float = 0.15, quiet: float = 0.72, *,
                   device="cuda"):
    """Build the generator: a sequence of B song ids -> (B, blen) float32
    on ``device``, int16-valued, zeros past ``gen.n_samp``."""
    import torch

    dev = torch.device(device)
    n_samp = int(duration_s * fs)
    n_blocks = n_samp // BLOCK + 1
    n_gen = n_blocks * BLOCK
    blen = -(-n_gen // (1 << 18)) * (1 << 18)
    max_bars = n_blocks // 8 + 2
    two_pi = np.float32(2.0 * np.pi)
    inv_fs = np.float32(1.0 / fs)
    klen = int(0.09 * fs)
    total = n_gen + klen + 16       # dump zone for hits past the song end

    ramp = torch.arange(BLOCK, dtype=torch.float32, device=dev)
    t_abs = (torch.arange(n_blocks, dtype=torch.float32, device=dev)[:, None]
             * BLOCK + ramp) * inv_fs                        # (nb, BLOCK)
    kt = np.arange(klen) / fs
    kick = torch.tensor(
        np.sin(2 * np.pi * (90.0 * np.exp(-kt * 18.0) + 45.0) * kt)
        * np.exp(-kt * 35.0), dtype=torch.float32, device=dev)

    def f32(rows):
        return torch.tensor(np.asarray(rows, np.float64), dtype=torch.float32,
                            device=dev)

    def render_voice(out, vs):
        """Add one voice of every song to ``out`` (B, nb, BLOCK).

        Envelope per sample: amp * min(1, t*atk) * exp(-dec*t) with
        t = age[block] + in-block time (exact note age, no block
        quantization -> no onset clicks)."""
        steps = two_pi * f32([v["f"] for v in vs]) * inv_fs     # (B, nb)
        starts = f32([block_phase(v["f"], fs) for v in vs])
        vhz = f32([v["vhz"] for v in vs])[:, None, None]
        ph0 = f32([v["ph0"] for v in vs])[:, None, None]
        phase = torch.sin(two_pi * vhz * t_abs + ph0)
        phase.mul_(f32([v["beta"] for v in vs])[:, :, None])
        phase.addcmul_(steps[:, :, None], ramp).add_(starts[:, :, None])
        s = torch.sin(phase)
        c = torch.cos(phase, out=phase)
        s2 = 2.0 * s * c                    # Chebyshev harmonics
        c2 = 1.0 - 2.0 * s * s
        h = vs[0]["h"]
        wave = h[0] * s
        wave.add_(s2, alpha=h[1])
        s.mul_(c2).addcmul_(s2, c)          # s3 = s2 c + c2 s
        wave.add_(s, alpha=h[2])
        if h[3]:
            wave.add_(s2.mul_(c2), alpha=2.0 * h[3])   # s4 = 2 s2 c2
        del phase, s, c, s2, c2
        t_note = f32([v["age"] for v in vs])[:, :, None] + ramp * inv_fs
        env = torch.exp(t_note * -f32([v["dec"] for v in vs])[:, :, None])
        env.mul_(t_note.mul_(vs[0]["atk"]).clamp_(max=1.0))
        env.mul_(f32([v["amp"] for v in vs])[:, :, None])
        out.addcmul_(wave, env)

    def add_hits(flat, rows, positions, waves, amps):
        """``flat`` (B * total,) += amps * wave at each position; a hit
        that would pass the song's end goes to the dump zone."""
        length = waves.shape[1]
        pos = torch.where(positions + length < n_gen, positions,
                          total - length - 1)
        idx = (pos + rows * total)[:, :, None] + torch.arange(length,
                                                              device=dev)
        flat.index_add_(0, idx.reshape(-1),
                        (amps[:, :, None] * waves[:, None, :]).reshape(-1))

    def gen(sids):
        sids = [int(s) for s in (sids.tolist() if hasattr(sids, "tolist")
                                 else sids)]
        ps = [_song_params(s, seed, n_blocks, fs, quiet) for s in sids]
        bsz = len(ps)
        audio = torch.zeros((bsz, total), dtype=torch.float32, device=dev)
        body = audio[:, :n_gen].view(bsz, n_blocks, BLOCK)
        for j in range(len(ps[0]["voices"])):
            render_voice(body, [p["voices"][j] for p in ps])

        # percussion bed: kick beats 0/2, snare 1/3, hats on 8ths
        rows = torch.arange(bsz, device=dev)[:, None]
        bar_samp = torch.tensor([p["bar_samp"] for p in ps], device=dev)
        beat_samp = bar_samp // 4
        starts = torch.arange(max_bars, device=dev)[None, :] * bar_samp[:, None]
        amp_bar = f32([p["sect_bar"] for p in ps])
        flat = audio.view(-1)
        kicks = kick.expand(bsz, -1)
        snares = f32([p["snare"] for p in ps])
        hats = f32([p["hat"] for p in ps])
        for bt, waves, g in ((0, kicks, 0.5), (2, kicks, 0.5),
                             (1, snares, 0.18), (3, snares, 0.18)):
            add_hits(flat, rows, starts + (bt * beat_samp)[:, None], waves,
                     g * amp_bar)
        for half in range(8):
            add_hits(flat, rows, starts + (half * (beat_samp // 2))[:, None],
                     hats, 0.05 * amp_bar)

        body = audio[:, :n_gen]
        noise = torch.empty(n_gen, dtype=torch.float32, device=dev)
        for r, p in enumerate(ps):      # the room floor, a stream per song
            g = torch.Generator(device=dev)
            g.manual_seed(p["floor_seed"])
            body[r].add_(noise.normal_(generator=g), alpha=0.004)
        peak = body.abs().amax(dim=1, keepdim=True)
        out = torch.zeros((bsz, blen), dtype=torch.float32, device=dev)
        out[:, :n_samp] = torch.round(
            body[:, :n_samp] / torch.clamp(peak, min=1e-6) * level * 32767.0)
        return out

    gen.n_samp = n_samp
    gen.blen = blen
    return gen
