"""Logging/observability: rotating file logs with the reference's custom
level-21 "main" channel (scripts/hichap:453-484) plus a global excepthook
that records tracebacks in the log file."""

from __future__ import annotations

import logging
import logging.handlers
import sys

MAIN = 21
logging.addLevelName(MAIN, "main")


def get_logger(name: str = "hichap_master_tpu_torch") -> logging.Logger:
    return logging.getLogger(name)


def setup_logging(logfile: str | None = None, console: bool = True) -> logging.Logger:
    root = logging.getLogger()
    root.setLevel(MAIN)
    fmt = logging.Formatter(
        fmt="%(asctime)s %(name)-22s %(levelname)-6s %(message)s",
        datefmt="%m-%d %H:%M:%S",
    )
    if logfile:
        fh = logging.handlers.RotatingFileHandler(
            logfile, maxBytes=10 * 1024 * 1024, backupCount=5
        )
        fh.setFormatter(fmt)
        fh.setLevel(MAIN)
        root.addHandler(fh)

        def excepthook(tp, value, tb):
            logging.getLogger("hichap_master_tpu_torch").error(
                "Unhandled exception", exc_info=(tp, value, tb)
            )
            sys.__excepthook__(tp, value, tb)

        sys.excepthook = excepthook
    if console:
        ch = logging.StreamHandler()
        ch.setFormatter(fmt)
        ch.setLevel(MAIN)
        root.addHandler(ch)
    return get_logger()
