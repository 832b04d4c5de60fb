"""Command line: `python -m gorder_tpu_torch CONFIG.yaml [--device cpu]`.

Runs the configuration on the GPU (or the CPU, with `--device cpu`) and
writes its output files, like `gorder-tpu CONFIG.yaml`. Exit code 0 on
success, 1 on an analysis error.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m gorder_tpu_torch",
        description="Calculate lipid order parameters from GROMACS "
                    "trajectories with PyTorch on an NVIDIA GPU.")
    parser.add_argument("config", help="path to the YAML configuration file")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    args = parser.parse_args(argv)

    from . import Analysis, GorderError, run
    from .utils.logcolor import install_cli_logging

    try:
        analysis = Analysis.from_file(args.config)
        install_cli_logging(analysis.silent)
        run(analysis, device=args.device).write()
    except GorderError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
