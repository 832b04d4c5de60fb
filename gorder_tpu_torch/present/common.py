"""Shared presentation helpers: float formatting, file backup, headers.

Behavioral reference: src/presentation/mod.rs:285-446 (4-dp rounding,
`#name.N#` backups unless --overwrite, per-file write-status logging via
the `backitup` crate)."""

from __future__ import annotations

import logging
import math
import os
import shutil

from ..version import __version__

log = logging.getLogger("gorder")


def fmt4(value: float) -> str:
    """Round to 4 decimals, minimal representation; NaN → '.nan'
    (matches the reference's serde_yaml float output)."""
    if value is None or (isinstance(value, float) and math.isnan(value)):
        return ".nan"
    rounded = round(float(value) + 0.0, 4)
    if rounded == int(rounded):
        return f"{rounded:.1f}"  # serde_yaml prints 1.0, 0.0
    return repr(rounded)


def results_header(results, what: str = "") -> str:
    traj = " ".join(results.trajectory_paths)
    return (
        f"# Order parameters calculated with 'gorder-tpu v{__version__}' "
        f"using structure file '{results.structure_path}' and trajectory "
        f"file '{traj}'."
    )


def backup_file(path: str) -> None:
    """Back up an existing file as '#name.N#' next to it
    (reference behavior via the backitup crate)."""
    if not os.path.exists(path):
        return
    directory = os.path.dirname(path) or "."
    base = os.path.basename(path)
    n = 1
    while True:
        candidate = os.path.join(directory, f"#{base}.{n}#")
        if not os.path.exists(candidate):
            break
        n += 1
    try:
        shutil.move(path, candidate)
    except OSError:
        # wording: src/errors.rs:240-242 (WriteError::CouldNotBackupFile)
        from ..errors import WriteError

        raise WriteError(
            f"could not create a backup for file '{path}'") from None
    log.info("backed up '%s' as '%s'", path, candidate)


def prepare_output_path(path: str, overwrite: bool) -> None:
    directory = os.path.dirname(path)
    if directory and not os.path.isdir(directory):
        # the reference does not create missing parent directories for
        # output files (errors.rs CouldNotCreateFile)
        from ..errors import WriteError

        raise WriteError(f"could not create file '{path}'")
    if not overwrite:
        backup_file(path)


def prepare_output_dir(path: str, overwrite: bool) -> None:
    from ..errors import OrderMapError

    if os.path.isdir(path) and not overwrite:
        # back up the whole directory
        parent = os.path.dirname(os.path.abspath(path)) or "."
        base = os.path.basename(os.path.normpath(path))
        n = 1
        while True:
            candidate = os.path.join(parent, f"#{base}.{n}#")
            if not os.path.exists(candidate):
                break
            n += 1
        try:
            shutil.move(path, candidate)
        except OSError:
            # wording: src/errors.rs:271-273
            # (OrderMapWriteError::CouldNotBackupDirectory)
            raise OrderMapError(
                f"could not create a backup for directory '{path}'"
            ) from None
        log.info("backed up directory '%s' as '%s'", path, candidate)
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        # wording: src/errors.rs:268-269
        # (OrderMapWriteError::CouldNotCreateDirectory)
        raise OrderMapError(
            f"could not create directory '{path}'") from None
