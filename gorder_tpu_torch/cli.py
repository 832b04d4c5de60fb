"""Command-line application (port of `gorder_tpu/cli.py`).

Behavioral reference: src/application/mod.rs:25-211 — `gorder-tpu-torch
CONFIG.yaml [--silent] [--overwrite] [--export-config FILE] [--device
DEVICE]`, YAML output required in CLI mode, banner + ✔/✖ footer, exit code
0/1. It prints the lines `gorder-tpu` prints and exits with its codes; the
analysis runs on the GPU, or on `--device`. `--frame-shard I/N --partial
FILE` runs one contiguous frame shard and writes its partial state, and
`--merge FILE…` merges such states (of either package) into the
configured outputs: one process per GPU, then a merge.
"""

from __future__ import annotations

import argparse
import logging
import sys

from .errors import GorderError
from .input.config import Analysis
from .version import __version__


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="gorder-tpu-torch",
        description=(
            "Calculate lipid order parameters from GROMACS trajectories "
            "(PyTorch port of gorder-tpu, on an NVIDIA GPU)."
        ),
    )
    parser.add_argument("config", help="path to the YAML configuration file")
    parser.add_argument(
        "-s", "--silent", action="store_true",
        help="suppress standard output during the analysis")
    parser.add_argument(
        "-o", "--overwrite", action="store_true",
        help="overwrite output files without backups")
    parser.add_argument(
        "--export-config", metavar="FILE", default=None,
        help="export the analysis options (with defaults) to a YAML file")
    parser.add_argument(
        "--frame-shard", metavar="I/N", default=None,
        help="process only frame shard I of N (contiguous block); "
             "requires --partial (one process per GPU, then --merge)")
    parser.add_argument(
        "--partial", metavar="FILE.npz", default=None,
        help="write the shard's raw partial state instead of results")
    parser.add_argument(
        "--merge", metavar="FILE.npz", nargs="+", default=None,
        help="merge partial states (paths or globs) into the configured "
             "outputs — byte-identical to a single-process run")
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to run on (default: cuda)")
    parser.add_argument(
        "--version", action="version",
        version=f"gorder-tpu-torch {__version__}")
    return parser


def export_config(analysis: Analysis, path: str) -> None:
    """Export the fully-defaulted analysis options
    (application/mod.rs:171-211: backup-unless-overwrite, version header,
    CouldNotCreateFile on an unwritable path), as `gorder-tpu` writes
    them."""
    from .errors import WriteError
    from .input.export import analysis_to_yaml
    from .present.common import prepare_output_path

    logging.getLogger("gorder").info(
        "Exporting all analysis options into file '%s'...", path)
    prepare_output_path(path, analysis.overwrite)
    try:
        with open(path, "w") as fh:
            fh.write(f"# Analysis options generated by "
                     f"'gorder-tpu v{__version__}'.\n")
            fh.write(analysis_to_yaml(analysis))
    except OSError:
        raise WriteError(f"could not create file '{path}'") from None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    try:
        analysis = Analysis.from_file(args.config)
    except GorderError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    if args.silent:
        analysis.silent = True
    if args.overwrite:
        analysis.overwrite = True

    from .utils.logcolor import install_cli_logging

    install_cli_logging(analysis.silent)

    if not analysis.silent:
        print(f">>> GORDER-TPU v{__version__} <<<\n")

    if args.frame_shard is not None:
        if args.partial is None:
            print("error: --frame-shard requires --partial",
                  file=sys.stderr)
            return 1
        try:
            shard_index, shard_count = (int(v) for v in
                                        args.frame_shard.split("/"))
        except ValueError:
            print(f"error: invalid --frame-shard '{args.frame_shard}' "
                  f"(expected I/N)", file=sys.stderr)
            return 1
        from .parallel.shard import save_partial

        try:
            state = analysis.run_partial(shard_index, shard_count,
                                         device=args.device)
            save_partial(args.partial, state)
        except GorderError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        if not analysis.silent:
            print(f"\n✔ shard {shard_index}/{shard_count} state written "
                  f"to '{args.partial}'")
        return 0

    if analysis.output_yaml is None:
        # wording: src/errors.rs:297-298 (ConfigError::NoYamlOutput)
        print(
            f"error: no yaml output file specified in the configuration "
            f"file '{args.config}' (hint: add 'output: output.yaml' to "
            f"your configuration file)", file=sys.stderr)
        return 1
    if analysis.map is not None and analysis.map.output_directory is None:
        # wording: src/errors.rs:301-302 (ConfigError::NoOrdermapsOutput)
        print(
            f"error: no output directory for ordermaps specified in the "
            f"configuration file '{args.config}'", file=sys.stderr)
        return 1

    if args.merge is not None:
        from .parallel.shard import expand_partial_paths

        try:
            results = analysis.merge(expand_partial_paths(args.merge))
            results.write()
        except GorderError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        if not analysis.silent:
            print("\n✔ merged partial states; results written")
        return 0

    try:
        results = analysis.run(device=args.device)
        results.write()
    except GorderError as e:
        if not analysis.silent:
            print(f"\n✖ error: {e}", file=sys.stderr)
        else:
            print(f"error: {e}", file=sys.stderr)
        return 1

    if args.export_config:
        try:
            export_config(analysis, args.export_config)
        except GorderError as e:
            # the analysis itself succeeded — report the export failure
            # without failing the run (application/mod.rs:128-136)
            print("Analysis completed successfully, but exporting the "
                  f"analysis options failed!\n    error: {e}",
                  file=sys.stderr)

    if not analysis.silent:
        print("\n✔ analysis completed successfully")
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
