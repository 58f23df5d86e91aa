"""``python -m shazam_tpu_torch``: the command-line interface (``cli.py``)."""

from .cli import main

main()
