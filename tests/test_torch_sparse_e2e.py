"""Port parity, big catalogs end to end: ``SIA`` of both packages with
``sparse_vote_threshold=0``.

A 6-song x 12 s seeded corpus goes into both packages' SIA under each
sparse variant config (sort, scan with blocked expansion, the
decided-first policy, a blocked run budget small enough to force the
row-by-row fallback). Every clip (one per song, silence, a song not in
the catalog) must give the same result dict from the port's
``recognize_clip`` and ``recognize_samples`` as from the JAX package's,
and as from the dense path. Where the JAX package runs a path the port
does not have (its pruned rank with 2 and 256 candidates, bounds-first
escalation), the port runs its own in place (the sort rank; decide-first
with no clamp accepted) and gives the same dict. An index saved by the
JAX SIA loads into the port with the same answers.
"""

import numpy as np
import pytest
import torch

from shazam_tpu_torch.api import SIA
from shazam_tpu_torch.audio import synth_song
from shazam_tpu_torch.config import FingerprintConfig

N_SONGS, DUR, FS = 6, 12.0, 44100
TIMING = ("fingerprint_time", "query_time", "align_time", "total_time")
SPARSE = dict(sparse_vote_threshold=0)
VARIANTS = {
    "sort": dict(SPARSE, vote_rank="sort"),
    "scan_blocked": dict(SPARSE, vote_rank="scan", expand_block=512,
                         expand_block_min_capacity=0),
    "pruned_c2": dict(SPARSE, vote_rank="pruned", rank_candidates=2),
    "pruned_c256": dict(SPARSE, vote_rank="pruned", rank_candidates=256),
    "decide": dict(SPARSE, bounds_probe_min_rows=1,
                   escalation_policy="decide"),
    "bounds": dict(SPARSE, bounds_probe_min_rows=1,
                   escalation_policy="bounds"),
    "run_budget": dict(SPARSE, vote_rank="scan", expand_block=512,
                       expand_block_runs=2, expand_block_min_capacity=0),
}
# the port's config in place of a JAX path it does not have
IN_PLACE = {
    "pruned_c2": dict(SPARSE, vote_rank="sort"),
    "pruned_c256": dict(SPARSE, vote_rank="sort"),
    "bounds": dict(SPARSE, bounds_probe_min_rows=1,
                   decision_escalation=False),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs files in parallel worker processes: torch's CPU ops
    here use one thread so that the workers do not oversubscribe cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def songs():
    return [(f"track{i:06d}", synth_song(i, DUR, seed=7))
            for i in range(N_SONGS)]


@pytest.fixture(scope="module")
def clips(songs):
    out = [s[int((2.0 + i) * FS): int((7.0 + i) * FS)]
           for i, (_, s) in enumerate(songs)]
    out.append(np.zeros(3 * FS, np.float32))        # silence: no match
    out.append(synth_song(999, 5.0, seed=123))      # not in the catalog
    return out


def _answers(sia, clips):
    def strip(res):
        return {k: v for k, v in res.items() if k not in TIMING}

    return {"samples": [strip(sia.recognize_samples([c])) for c in clips],
            "clip": [strip(sia.recognize_clip(c)) for c in clips]}


def _jax_answers(cfg, songs, clips, **sia_kw):
    from shazam_tpu.api import SIA as JaxSIA
    from shazam_tpu.config import FingerprintConfig as JaxConfig

    ref = JaxSIA(config=JaxConfig(**cfg), **sia_kw)
    ref.ingest_arrays(songs)
    return ref, _answers(ref, clips)


@pytest.fixture(scope="module")
def dense(songs, clips):
    port = SIA(device="cpu")
    port.ingest_arrays(songs)
    want = _answers(port, clips)
    names = [r["results"][0]["song_name"] if r["results"] else None
             for r in want["clip"]]
    assert names == [n for n, _ in songs] + [None, names[-1]]
    return want


def test_dense_path_matches_jax(dense, songs, clips):
    _ref, want = _jax_answers({}, songs, clips)
    assert dense == want


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sparse_variant_matches_jax_and_dense(dense, songs, clips, variant):
    cfg = VARIANTS[variant]
    port = SIA(config=FingerprintConfig(**IN_PLACE.get(variant, cfg)),
               device="cpu")
    port.ingest_arrays(songs)
    got = _answers(port, clips)
    _ref, want = _jax_answers(cfg, songs, clips)
    for key in ("samples", "clip"):
        for i, (g, w, d) in enumerate(zip(got[key], want[key], dense[key])):
            assert g == w, (variant, key, i, g, w)
            assert g == d, (variant, key, i, g, d)


def test_jax_saved_index_answers_alike_in_the_port(songs, clips, tmp_path):
    db = str(tmp_path / "catalog.sqlite")
    ref, want = _jax_answers(SPARSE, songs, clips, catalog_path=db)
    ref.save_index(str(tmp_path / "index.npz"))
    port = SIA(config=FingerprintConfig(**SPARSE), catalog_path=db,
               device="cpu")
    port.load_index(str(tmp_path / "index.npz"))
    assert port.index.n_hashes == ref.index.n_hashes
    assert _answers(port, clips) == want
