"""Each traffic generator is a function of its seed."""

import numpy as np
import torch

from benchmark_torch.lib import clips, music
from benchmark_torch.lib.drivers import ingest, serve


def test_music_is_a_function_of_seed_and_id():
    a = music.make_music_gen(3.0, seed=2**31 + 7, device="cpu")
    b = music.make_music_gen(3.0, seed=2**31 + 7, device="cpu")
    x, y = a([1, 2]), b([2])
    assert torch.equal(x[1], y[0])          # independent of its batch
    assert not torch.equal(x[0], x[1])
    other = music.make_music_gen(3.0, seed=2**31 + 8, device="cpu")([2])
    assert not torch.equal(other[0], y[0])
    assert x.shape[1] % (1 << 18) == 0 and a.n_samp == 3 * 44100
    assert float(x.abs().max()) <= 32767 and torch.equal(x, x.round())


def test_clip_plan_is_seeded_with_equal_conditions(tiny):
    _, mixes = tiny
    mix = dict(mixes["listen15"], pool=30)
    p1 = clips.plan(mix, 100, 44100 * 20, 44100, 2**33 + 1)
    p2 = clips.plan(mix, 100, 44100 * 20, 44100, 2**33 + 1)
    p3 = clips.plan(mix, 100, 44100 * 20, 44100, 2**33 + 2)
    for f in ("songs", "starts", "conditions"):
        assert np.array_equal(getattr(p1, f), getattr(p2, f))
    assert not np.array_equal(p1.songs, p3.songs)
    assert np.bincount(p1.conditions).tolist() == [10, 10, 10]
    assert np.bincount(p3.conditions).tolist() == [10, 10, 10]
    assert (p1.starts + p1.length <= 44100 * 20).all()


def test_degraded_clips_are_seeded(tiny):
    _, mixes = tiny
    clip = (np.random.default_rng(0).normal(0, 3000, 44100 * 2)
            .astype(np.int16))
    for cond in mixes["listen15"]["conditions"]:
        a = clips.degrade(clip, cond, 44100, 9, 3)
        b = clips.degrade(clip, cond, 44100, 9, 3)
        assert a.dtype == np.int16 and np.array_equal(a, b)
        if cond["name"] != "clean":
            assert not np.array_equal(a, clips.degrade(clip, cond, 44100,
                                                       9, 4))


def test_ingest_mixes_are_seeded():
    pool = music.make_music_gen(2.0, seed=3, device="cpu")(range(4))
    n = 2 * 44100
    m1, m2 = ingest.Mixer(pool, n, 3, 11), ingest.Mixer(pool, n, 3, 11)
    names, a = m1(5)
    assert names == ["mix0000015", "mix0000016", "mix0000017"]
    assert torch.equal(a, m2(5)[1])
    assert not torch.equal(a, ingest.Mixer(pool, n, 3, 12)(5)[1])
    assert torch.equal(a[1], m1.song(5, 1))
    assert float(a[:, n:].abs().max()) == 0.0


def test_wav_bytes_round_trip():
    import io
    import wave

    clip = np.arange(-500, 500, dtype=np.int16)
    with wave.open(io.BytesIO(serve.wav_bytes(clip, 44100))) as w:
        assert (w.getnchannels(), w.getframerate()) == (1, 44100)
        got = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    assert np.array_equal(got, clip)


def test_block_phase_is_the_running_sum_of_steps():
    f = np.array([440.0, 440.0, 220.0, 880.0])
    ph = music.block_phase(f, 44100)
    step = 2 * np.pi * f / 44100 * music.BLOCK
    assert ph[0] == 0.0
    assert np.allclose(np.exp(1j * ph[1:]), np.exp(1j * np.cumsum(step)[:-1]))
    assert ((0 <= ph) & (ph < 2 * np.pi)).all()
