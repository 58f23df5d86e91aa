"""Maintenance tools behind the CLI's ``fsck``, ``stats`` and ``sanity``
(``plot``'s tool is ``tools.plot``, which needs matplotlib)."""

from .fsck import check_integrity
from .sanity import check_corpus_sanity
from .stats import dump_song_hash_stats

__all__ = ["check_corpus_sanity", "check_integrity", "dump_song_hash_stats"]
