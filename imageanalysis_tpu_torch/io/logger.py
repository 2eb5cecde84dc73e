"""Timestamped run log: ``<analysis_dir>/messages-<hostname>`` + stdout.

Reference scripts/lib/logger.py:10-47 (``log`` = file+stdout, ``qlog`` =
file-only), reproduced without the module-global file handle.
"""

from __future__ import annotations

import datetime
import socket
import os

_logfile = None


def init(analysis_dir: str):
    global _logfile
    if analysis_dir and os.path.isdir(analysis_dir):
        host = socket.gethostname()
        _logfile = os.path.join(analysis_dir, f"messages-{host}")


def _write(*args):
    global _logfile
    if _logfile is None:
        return
    msg = " ".join(str(a) for a in args)
    try:
        with open(_logfile, "a") as f:
            f.write(f"{datetime.datetime.now()}: {msg}\n")
    except OSError:
        # best-effort log: the analysis dir vanished (e.g. a temp project
        # was deleted); stop writing rather than poisoning later callers
        _logfile = None


def log(*args):
    print(*args)
    _write(*args)


def qlog(*args):
    _write(*args)
