"""Colorized logging for whisperjav_tpu_torch.

The port's copy of ``whisperjav_tpu/utils/logger.py``. It keeps the
logger's name, ``whisperjav_tpu``, so both packages log through one
``logging.Logger``: the default handler is attached once, by whichever
package is imported first.

Role parity with the reference's ``whisperjav/utils/logger.py`` (colorama
console logger + optional file log), built fresh on stdlib logging.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import Optional

_LOGGER_NAME = "whisperjav_tpu"

_LEVEL_COLORS = {
    logging.DEBUG: "\033[36m",     # cyan
    logging.INFO: "\033[32m",      # green
    logging.WARNING: "\033[33m",   # yellow
    logging.ERROR: "\033[31m",     # red
    logging.CRITICAL: "\033[35m",  # magenta
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def __init__(self, use_color: bool = True):
        super().__init__("%(asctime)s | %(levelname)-8s | %(message)s", "%H:%M:%S")
        self.use_color = use_color

    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        if self.use_color:
            color = _LEVEL_COLORS.get(record.levelno, "")
            if color:
                msg = f"{color}{msg}{_RESET}"
        return msg


def setup_logger(
    verbosity: str = "info",
    log_file: Optional[Path] = None,
    use_color: Optional[bool] = None,
) -> logging.Logger:
    """Configure and return the package logger.

    verbosity: one of quiet/normal/info/verbose/debug (reference CLI wording).
    """
    level_map = {
        "quiet": logging.WARNING,
        "normal": logging.INFO,
        "info": logging.INFO,
        "verbose": logging.DEBUG,
        "debug": logging.DEBUG,
    }
    level = level_map.get(verbosity, logging.INFO)
    log = logging.getLogger(_LOGGER_NAME)
    log.setLevel(logging.DEBUG)
    log.handlers.clear()

    if use_color is None:
        use_color = sys.stderr.isatty()

    console = logging.StreamHandler(sys.stderr)
    console.setLevel(level)
    console.setFormatter(_ColorFormatter(use_color))
    log.addHandler(console)

    if log_file is not None:
        log_file = Path(log_file)
        log_file.parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(log_file, encoding="utf-8")
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter(
            "%(asctime)s | %(levelname)-8s | %(name)s | %(message)s"))
        log.addHandler(fh)

    log.propagate = False
    return log


logger = logging.getLogger(_LOGGER_NAME)
if not logger.handlers:  # default config until setup_logger() is called
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(_ColorFormatter(sys.stderr.isatty()))
    _h.setLevel(logging.INFO)
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)
    logger.propagate = False
