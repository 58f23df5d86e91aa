from .mesh import make_mesh, shard_index_arrays
from .sharded import sharded_match_query, sharded_ingest_step

__all__ = [
    "make_mesh",
    "shard_index_arrays",
    "sharded_match_query",
    "sharded_ingest_step",
]
