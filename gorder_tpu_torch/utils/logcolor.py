"""colog-style colored logging for the CLI.

The reference logs through the `colog` crate with custom macros that
colorize the MESSAGE ARGUMENTS — cyan for info, yellow for warnings
(src/lib.rs:392-413 `colog_info!`/`colog_warn!`) — on top of colog's
colored level markers. This module reproduces that look for the CLI's
stderr handler while keeping library logging plain:

    [*] wire format: `b7` — `19456` bond vectors ...   (args in cyan)
    [!] wire fallback: batch `7` exceeds ...           (args in yellow)

Coloring is tty-gated and respects NO_COLOR; GORDER_TPU_COLOR=1/0
forces it on/off (tests use 1).
"""

from __future__ import annotations

import logging
import os
import re
import sys

RESET = "\x1b[0m"
CYAN = "\x1b[36m"
YELLOW = "\x1b[33m"
RED = "\x1b[31m"
GREEN = "\x1b[32m"
BOLD = "\x1b[1m"

# a printf-style conversion directive (%-formatting, the logging default);
# named-argument and mapping forms are left uncolored
_DIRECTIVE = re.compile(
    r"%[#0\- +]*(?:\d+)?(?:\.\d+)?[hlL]?([diouxXeEfFgGcrsa%])")

_LEVEL_MARK = {
    logging.DEBUG: ("[d]", ""),
    logging.INFO: ("[*]", GREEN),
    logging.WARNING: ("[!]", YELLOW),
    logging.ERROR: ("[E]", RED),
    logging.CRITICAL: ("[E]", RED),
}

_ARG_COLOR = {
    logging.INFO: CYAN,
    logging.WARNING: YELLOW,
}


def colors_enabled(stream) -> bool:
    forced = os.environ.get("GORDER_TPU_COLOR", "")
    if forced == "1":
        return True
    if forced == "0" or os.environ.get("NO_COLOR"):
        return False
    return bool(getattr(stream, "isatty", lambda: False)())


class CologFormatter(logging.Formatter):
    """`[*] message` with colog's colored level marker and the reference
    macros' argument highlighting. Falls back to plain formatting on any
    argument/directive mismatch (never raises out of logging)."""

    def __init__(self, color: bool):
        super().__init__("%(message)s")
        self.color = color

    def _colorize_args(self, record: logging.LogRecord) -> str:
        msg = str(record.msg)
        tint = _ARG_COLOR.get(record.levelno)
        args = record.args
        if not (self.color and tint and args):
            return record.getMessage()
        if not isinstance(args, tuple):
            args = (args,)
        out = []
        pos = 0
        i = 0
        try:
            for m in _DIRECTIVE.finditer(msg):
                conv = m.group(1)
                out.append(msg[pos:m.start()])
                pos = m.end()
                if conv == "%":
                    out.append("%")
                    continue
                if i >= len(args):
                    raise ValueError("more directives than args")
                out.append(f"{tint}{m.group(0) % (args[i],)}{RESET}")
                i += 1
            if i != len(args):
                raise ValueError("more args than directives")
        except (ValueError, TypeError):
            try:
                return record.getMessage()
            except (ValueError, TypeError):
                return f"{record.msg} {record.args!r}"
        out.append(msg[pos:])
        return "".join(out)

    def format(self, record: logging.LogRecord) -> str:
        mark, mark_color = _LEVEL_MARK.get(record.levelno,
                                           ("[?]", ""))
        text = self._colorize_args(record)
        if record.exc_info or record.stack_info:
            # delegate the (rare) traceback path to the base class
            plain = logging.LogRecord(
                record.name, record.levelno, record.pathname, record.lineno,
                text, None, record.exc_info, record.funcName,
                record.stack_info)
            text = super().format(plain)
        if self.color and mark_color:
            mark = f"{mark_color}{BOLD}{mark}{RESET}"
        return f"{mark} {text}"


def install_cli_logging(silent: bool, stream=None) -> None:
    """Configure the root logger the way the reference's CLI does
    (colog + --silent raising the level to Error,
    src/application/mod.rs:103-104)."""
    stream = stream if stream is not None else sys.stderr
    handler = logging.StreamHandler(stream)
    handler.setFormatter(CologFormatter(colors_enabled(stream)))
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(logging.ERROR if silent else logging.INFO)
