"""Command line: `python -m gorder_tpu_torch CONFIG.yaml [options]`, the
same as the `gorder-tpu-torch` script (`cli.py`)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
