"""Leveled logger with an alarm plane.

Reference behavior: `CommonLibs/Logger.{h,cpp}`: 8 levels
FORCE…DEEPDEBUG (Logger.h:56-66), a compile-away `LOG()` macro, and
ALARM-level messages additionally sent to a UDP collector and kept in a
bounded recent-alarms ring readable by the CLI (Logger.h:89-106).

Built on the stdlib logging module (the idiomatic host-side choice),
with the alarm UDP target and ring preserved.
"""

from __future__ import annotations

import collections
import logging
import socket
import threading
from typing import Deque, List, Optional

# Reference levels (Logger.h:56-66) → stdlib levels
FORCE = logging.CRITICAL + 10
ERROR = logging.ERROR
ALARM = logging.ERROR + 5
WARN = logging.WARNING
NOTICE = logging.INFO + 5
INFO = logging.INFO
DEBUG = logging.DEBUG
DEEPDEBUG = logging.DEBUG - 5

logging.addLevelName(FORCE, "FORCE")
logging.addLevelName(ALARM, "ALARM")
logging.addLevelName(NOTICE, "NOTICE")
logging.addLevelName(DEEPDEBUG, "DEEPDEBUG")

_LEVEL_BY_NAME = {
    "FORCE": FORCE, "ERROR": ERROR, "ALARM": ALARM, "WARN": WARN,
    "NOTICE": NOTICE, "INFO": INFO, "DEBUG": DEBUG, "DEEPDEBUG": DEEPDEBUG,
}

MAX_ALARMS = 10  # recent-alarm ring size (Logger.cpp)


class AlarmManager:
    """Recent-alarm ring + optional UDP alarm target
    (Logger.h:89-106)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ring: Deque[str] = collections.deque(maxlen=MAX_ALARMS)
        self._target: Optional[tuple[str, int]] = None
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def set_target(self, host: str, port: int) -> None:
        self._target = (host, port)

    def report(self, message: str) -> None:
        with self._lock:
            self._ring.append(message)
            if self._target:
                try:
                    self._sock.sendto(message.encode(), self._target)
                except OSError:
                    pass

    def recent(self) -> List[str]:
        with self._lock:
            return list(self._ring)


gAlarms = AlarmManager()


class _AlarmHandler(logging.Handler):
    def emit(self, record: logging.LogRecord) -> None:
        if record.levelno == ALARM:
            gAlarms.report(self.format(record))


_root = logging.getLogger("openbts_tpu")
_root.addHandler(_AlarmHandler())


def get_logger(name: str = "openbts_tpu") -> logging.Logger:
    return logging.getLogger(name)


def set_level(name: str) -> None:
    """Set the global threshold by reference level name
    (CLI `loglevel`)."""
    _root.setLevel(_LEVEL_BY_NAME[name.upper()])


_file_handler: logging.Handler | None = None


def set_logfile(path: str) -> None:
    """Route the log stream to a file (CLI `setlogfile`,
    CLI.cpp `setLogFile`)."""
    global _file_handler
    if _file_handler is not None:
        _root.removeHandler(_file_handler)
        _file_handler.close()
    _file_handler = logging.FileHandler(path)
    _file_handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s"))
    _root.addHandler(_file_handler)


def log(level_name: str, msg: str, *args) -> None:
    """LOG(LEVEL) equivalent."""
    _root.log(_LEVEL_BY_NAME[level_name.upper()], msg, *args)
