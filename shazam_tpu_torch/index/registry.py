"""Index backend registry.

The port of ``shazam_tpu/index/registry.py``, after the reference's
dynamic backend selection (``DATABASES`` dict + ``get_database`` importlib
loader, reference ``__init__.py:24-27,54-67``). A backend is a (catalog,
index) pairing, built by a factory ``f(db_prefix, config=None, *,
device="cuda")``; third parties can register their own.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, Tuple

# name -> (module path, factory attr)
BACKENDS: Dict[str, Tuple[str, str]] = {
    # sqlite catalog + npz index on disk (the default)
    "local": ("shazam_tpu_torch.index.registry", "_local_backend"),
    # everything in process memory (tests, ephemeral serving)
    "memory": ("shazam_tpu_torch.index.registry", "_memory_backend"),
}


def register_backend(name: str, module: str, attr: str) -> None:
    BACKENDS[name] = (module, attr)


def get_backend(name: str = "local") -> Callable:
    """Resolve a backend factory by name (TypeError on unknown, like the
    reference's ``get_database``)."""
    try:
        module, attr = BACKENDS[name]
        return getattr(importlib.import_module(module), attr)
    except (ImportError, KeyError, AttributeError) as exc:
        raise TypeError(f"Unsupported backend type supplied: {name!r}") from exc


def _local_backend(db_prefix: str, config=None, *, device="cuda"):
    import os

    from ..api import SIA
    from ..config import DEFAULT_CONFIG

    sia = SIA(config=config or DEFAULT_CONFIG,
              catalog_path=db_prefix + ".sqlite", device=device)
    index_path = db_prefix + ".npz"
    if os.path.exists(index_path):
        sia.load_index(index_path)
    return sia


def _memory_backend(db_prefix: str = "", config=None, *, device="cuda"):
    from ..api import SIA
    from ..config import DEFAULT_CONFIG

    return SIA(config=config or DEFAULT_CONFIG, catalog_path=":memory:",
               device=device)
