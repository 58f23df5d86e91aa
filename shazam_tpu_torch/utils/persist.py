"""Crash-safe snapshot writes (``shazam_tpu/utils/persist.py``, copied).

``np.savez*`` writes straight into the destination path, so a process
killed mid-write (OOM, power loss, the serve daemon's SIGKILL) leaves a
truncated zip — and with ``serve --persist`` that file is the ONLY
snapshot, rewritten after every catalog mutation. The reference leaned
on MySQL/ES for durability (``mysql_database.py`` transactions); the
npz snapshots here need the filesystem equivalent: write to a temp file
in the same directory, fsync, then atomically ``os.replace`` over the
destination. Readers always see either the old snapshot or the new one,
never a torn write.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np


def atomic_savez(path: str, compress: bool = True, **arrays) -> None:
    """``np.savez(_compressed)`` with atomic-replace semantics.

    Matches numpy's string-path behavior of appending ``.npz`` when the
    name has no extension, so callers that relied on it keep working.
    """
    if not path.endswith(".npz"):
        path = path + ".npz"
    dest_dir = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=dest_dir, suffix=".npz.tmp")
    try:
        # mkstemp creates 0600; snapshots should get the same umask-based
        # mode a plain np.savez would have
        umask = os.umask(0)
        os.umask(umask)
        os.chmod(tmp, 0o666 & ~umask)
        with os.fdopen(fd, "wb") as fh:
            (np.savez_compressed if compress else np.savez)(fh, **arrays)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
