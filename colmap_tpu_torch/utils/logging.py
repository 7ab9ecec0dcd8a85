"""Logging + timing utilities mirroring the reference's glog conventions.

reference behavior: src/colmap/util/logging.{h,cc} (glog wrappers,
LOG_HEADING1/2 banners in util/misc.h:48-54, verbosity via VLOG levels) and
src/colmap/util/timer.{h,cc} (Timer with Start/Restart/Pause/Resume and
PrintSeconds/Minutes/Hours in the exact "Elapsed time: ..." format).

Built on the stdlib logging module — pipelines log through one shared
"colmap_tpu_torch" logger so library users can silence/redirect everything; the
default handler prints bare messages (like glog's INFO lines without the
prefix clutter). Verbosity (`--log_level`, VLOG analog) gates the detail
messages the reference emits at VLOG(1)/VLOG(2).
"""

from __future__ import annotations

import logging as _pylogging
import sys
import time
from typing import Optional

_logger = _pylogging.getLogger("colmap_tpu_torch")
if not _logger.handlers:
    _h = _pylogging.StreamHandler(sys.stdout)
    _h.setFormatter(_pylogging.Formatter("%(message)s"))
    _logger.addHandler(_h)
    _logger.setLevel(_pylogging.INFO)
    _logger.propagate = False

_verbosity = 0


def set_verbosity(level: int) -> None:
    """VLOG verbosity: 0 = info only, 1/2 = increasing detail
    (reference: glog --v flag consumed by VLOG(1)/VLOG(2) sites)."""
    global _verbosity
    _verbosity = int(level)


def get_verbosity() -> int:
    return _verbosity


def info(msg: str, *args) -> None:
    _logger.info(msg, *args)


def warning(msg: str, *args) -> None:
    _logger.warning(msg, *args)


def error(msg: str, *args) -> None:
    _logger.error(msg, *args)


def vlog(level: int, msg: str, *args) -> None:
    """reference: VLOG(level) — emitted only when verbosity >= level."""
    if _verbosity >= level:
        _logger.info(msg, *args)


def log_heading(message: str, level: int = 1) -> None:
    """Section banner (reference: LOG_HEADING1 '=== msg ===' and
    LOG_HEADING2 '== msg', util/misc.h:48-54)."""
    if level <= 1:
        _logger.info("=== %s ===", message)
    else:
        _logger.info("== %s", message)


class Timer:
    """Wall-clock timer (reference: util/timer.{h,cc})."""

    def __init__(self):
        self._started = False
        self._paused = False
        self._start = 0.0
        self._pause = 0.0

    def start(self) -> None:
        self._started = True
        self._paused = False
        self._start = time.perf_counter()

    def restart(self) -> None:
        self._started = False
        self.start()

    def pause(self) -> None:
        self._paused = True
        self._pause = time.perf_counter()

    def resume(self) -> None:
        if self._paused:
            self._start += time.perf_counter() - self._pause
            self._paused = False

    def reset(self) -> None:
        self._started = False
        self._paused = False

    def elapsed_seconds(self) -> float:
        if not self._started:
            return 0.0
        end = self._pause if self._paused else time.perf_counter()
        return end - self._start

    def elapsed_minutes(self) -> float:
        return self.elapsed_seconds() / 60.0

    def elapsed_hours(self) -> float:
        return self.elapsed_minutes() / 60.0

    def print_seconds(self) -> None:
        info("Elapsed time: %.5f [seconds]", self.elapsed_seconds())

    def print_minutes(self) -> None:
        info("Elapsed time: %.3f [minutes]", self.elapsed_minutes())

    def print_hours(self) -> None:
        info("Elapsed time: %.3f [hours]", self.elapsed_hours())


class ScopedTimer:
    """Context manager printing '<name>: ... [seconds]' on exit — the
    per-phase timing the reference logs around every pipeline stage
    (e.g. sfm/global_mapper.cc:529-533)."""

    def __init__(self, name: str, verbosity_level: int = 0):
        self.name = name
        self.level = verbosity_level
        self.timer = Timer()

    def __enter__(self):
        self.timer.start()
        return self.timer

    def __exit__(self, *exc):
        vlog_args = (self.level, "%s: %.3f [seconds]",
                     self.name, self.timer.elapsed_seconds())
        if self.level <= 0:
            info(vlog_args[1], *vlog_args[2:])
        else:
            vlog(*vlog_args)
        return False
