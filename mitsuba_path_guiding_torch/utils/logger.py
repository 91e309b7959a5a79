"""Leveled logger, appenders, and render progress listeners (a copy of
the JAX package's utils/logger.py, which imports nothing of JAX).

The counterpart of Mitsuba's logging stack (core/logger.h: a Logger with
a log level, a list of appenders and logProgress; core/appender.h;
render/renderqueue.h: RenderListener callbacks).

Host-side only: records, progress and render events are emitted between
progressions, after the device work they report on has been queued; a
listener receives host numpy images, never a device tensor.  One
process-global default logger stands for Mitsuba's Thread::getLogger().

Levels follow logger.h: ETrace < EDebug < EInfo < EWarn < EError.
``Logger.error`` raises after logging.
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, TextIO

# log levels (reference logger.h ELogLevel)
ETrace = 0
EDebug = 100
EInfo = 200
EWarn = 300
EError = 400

_LEVEL_NAMES = {ETrace: "TRACE", EDebug: "DEBUG", EInfo: "INFO",
                EWarn: "WARN", EError: "ERROR"}


def level_name(level: int) -> str:
    """Closest named level at or below ``level``."""
    best = "TRACE"
    for v, n in sorted(_LEVEL_NAMES.items()):
        if level >= v:
            best = n
    return best


class Appender:
    """Sink for formatted log records (reference appender.h Appender)."""

    def append(self, level: int, text: str) -> None:
        raise NotImplementedError

    def log_progress(self, progress: float, name: str, formatted: str,
                     eta: str) -> None:
        """Progress messages are transient by default (ignored)."""


class StreamAppender(Appender):
    """Writes records to a text stream; progress lines are rewritten
    in place with \\r when the stream is a TTY (reference appender.cpp
    StreamAppender behavior)."""

    def __init__(self, stream: TextIO = sys.stderr):
        self.stream = stream
        self._progress_open = False

    def _close_progress(self) -> None:
        if self._progress_open:
            self.stream.write("\n")
            self._progress_open = False

    def append(self, level: int, text: str) -> None:
        self._close_progress()
        self.stream.write(text + "\n")
        self.stream.flush()

    def log_progress(self, progress: float, name: str, formatted: str,
                     eta: str) -> None:
        if self.stream.isatty():
            self.stream.write("\r" + formatted + " " + eta + "   ")
            self.stream.flush()
            self._progress_open = True
        # non-tty: stay quiet (the reference only redraws on terminals)


class FileAppender(Appender):
    """Appends records to a log file (reference appender.h
    UnbufferedAppender — crash-safe flush per record)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")

    def append(self, level: int, text: str) -> None:
        self._f.write(text + "\n")
        self._f.flush()


class MemoryAppender(Appender):
    """Buffers records in memory — test/inspection sink."""

    def __init__(self):
        self.records: List[tuple] = []
        self.progress: List[tuple] = []

    def append(self, level: int, text: str) -> None:
        self.records.append((level, text))

    def log_progress(self, progress: float, name: str, formatted: str,
                     eta: str) -> None:
        self.progress.append((progress, name))


class Logger:
    """Leveled logger with an appender list (reference logger.h)."""

    def __init__(self, level: int = EInfo):
        self.level = level
        self.error_level = EError
        self.appenders: List[Appender] = []
        self._warn_once: set = set()
        self._progress_t0: Optional[float] = None

    # -- configuration -----------------------------------------------------
    def set_log_level(self, level: int) -> None:
        self.level = level

    def add_appender(self, app: Appender) -> None:
        self.appenders.append(app)

    def remove_appender(self, app: Appender) -> None:
        self.appenders.remove(app)

    def clear_appenders(self) -> None:
        self.appenders = []

    # -- emission ----------------------------------------------------------
    def log(self, level: int, fmt: str, *args) -> None:
        if level < self.level and level < self.error_level:
            return
        text = (fmt % args) if args else fmt
        stamp = time.strftime("%Y-%m-%d %H:%M:%S")
        line = f"{stamp} {level_name(level):5s}  {text}"
        for app in self.appenders:
            app.append(level, line)
        if level >= self.error_level:
            raise RuntimeError(text)

    def trace(self, fmt: str, *args) -> None:
        self.log(ETrace, fmt, *args)

    def debug(self, fmt: str, *args) -> None:
        self.log(EDebug, fmt, *args)

    def info(self, fmt: str, *args) -> None:
        self.log(EInfo, fmt, *args)

    def warn(self, fmt: str, *args) -> None:
        self.log(EWarn, fmt, *args)

    def warn_once(self, fmt: str, *args) -> None:
        """De-duplicated warning (reference SLog-once idiom for per-scene
        plugin warnings)."""
        key = (fmt, args)
        if key in self._warn_once:
            return
        self._warn_once.add(key)
        self.log(EWarn, fmt, *args)

    def error(self, fmt: str, *args) -> None:
        self.log(EError, fmt, *args)

    def log_progress(self, progress: float, name: str) -> None:
        """progress in [0, 1]; renders a bar + ETA like logger.cpp
        logProgress/ProgressReporter."""
        if self._progress_t0 is None or progress <= 0:
            self._progress_t0 = time.time()
        progress = min(max(progress, 0.0), 1.0)
        elapsed = time.time() - (self._progress_t0 or time.time())
        if progress > 1e-6:
            eta_s = elapsed * (1.0 - progress) / progress
            eta = f"(ETA: {eta_s:5.1f}s)"
        else:
            eta = "(ETA: ?)"
        nfill = int(progress * 30 + 0.5)
        bar = "[" + "=" * nfill + " " * (30 - nfill) + "]"
        formatted = f"{name}: {bar} {progress * 100:5.1f}%"
        for app in self.appenders:
            app.log_progress(progress, name, formatted, eta)
        if progress >= 1.0:
            self._progress_t0 = None
            for app in self.appenders:
                if isinstance(app, StreamAppender):
                    app._close_progress()


# process-global default logger (reference Thread::getLogger())
_default = Logger(EInfo)
_default.add_appender(StreamAppender(sys.stderr))


def get_logger() -> Logger:
    return _default


def set_log_level(level: int) -> None:
    _default.set_log_level(level)


# module-level convenience (reference SLog macro)
def slog(level: int, fmt: str, *args) -> None:
    _default.log(level, fmt, *args)


# ---------------------------------------------------------------------------
# render listeners (reference renderqueue.h:33-60 RenderListener:
# workBegin/workEnd/workCanceled/refresh/finish)
# ---------------------------------------------------------------------------

@dataclass
class RenderEvent:
    kind: str                 # "begin" | "progression" | "refresh" | "finish"
    progression: int = 0
    n_progressions: int = 0
    spp_done: int = 0
    elapsed_s: float = 0.0
    image: object = None      # developed (H, W, 3) numpy image, if available


class RenderListener:
    """Subclass and override; attach via RenderQueue.register."""

    def on_begin(self, ev: RenderEvent) -> None: ...

    def on_progression(self, ev: RenderEvent) -> None: ...

    def on_refresh(self, ev: RenderEvent) -> None: ...

    def on_finish(self, ev: RenderEvent) -> None: ...

    def control_state(self) -> dict | None:
        """Optional render-control channel (the interactive-GUI leg of
        the reference's mtsgui job control): return
        {"pause": bool, "stop": bool} to steer the progressive loop
        between progressions; None = no controls."""
        return None


@dataclass
class RenderQueue:
    """Dispatches render lifecycle events to listeners and the logger
    (reference renderqueue.cpp signal fan-out, minus the job tracking —
    jobs are synchronous progressions here)."""

    listeners: List[RenderListener] = field(default_factory=list)
    logger: Logger = field(default_factory=get_logger)
    _t0: float = 0.0

    def register(self, listener: RenderListener) -> None:
        self.listeners.append(listener)

    def unregister(self, listener: RenderListener) -> None:
        self.listeners.remove(listener)

    def begin(self, n_progressions: int) -> None:
        self._t0 = time.time()
        ev = RenderEvent("begin", n_progressions=n_progressions)
        for l in self.listeners:
            l.on_begin(ev)

    def progression(self, i: int, n: int, spp_done: int, image=None) -> None:
        ev = RenderEvent("progression", progression=i, n_progressions=n,
                         spp_done=spp_done, elapsed_s=time.time() - self._t0,
                         image=image)
        self.logger.log_progress((i + 1) / max(n, 1), "Rendering")
        for l in self.listeners:
            l.on_progression(ev)
            if image is not None:
                l.on_refresh(ev)

    def poll_controls(self) -> dict:
        """Merged listener control state ({"pause", "stop"}, ORed)."""
        out = {"pause": False, "stop": False}
        for l in self.listeners:
            c = l.control_state()
            if c:
                out["pause"] = out["pause"] or bool(c.get("pause"))
                out["stop"] = out["stop"] or bool(c.get("stop"))
        return out

    def finish(self, spp_done: int, image=None) -> None:
        ev = RenderEvent("finish", spp_done=spp_done,
                         elapsed_s=time.time() - self._t0, image=image)
        for l in self.listeners:
            l.on_finish(ev)
        self.logger.info("Render finished: %d spp in %.1f s", spp_done,
                         ev.elapsed_s)
