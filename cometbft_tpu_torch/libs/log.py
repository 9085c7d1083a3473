"""Structured key-value logging (libs/log: TMLogger, NewTMLogger,
NewFilter), the port's copy of ``cometbft_tpu/libs/log.py``.

Levels debug < info < error; a logger carries bound context keys (With),
renders either CometBFT's terminal format
(`I[2006-01-02|15:04:05.000] message            module=consensus h=5`)
or JSON lines, and supports per-module level filtering
(log.AllowLevelWith 'module' overrides, log.go NewFilter)."""

from __future__ import annotations

import json
import sys
import threading
import time

DEBUG, INFO, ERROR, NONE = 0, 1, 2, 3
_LEVEL_NAMES = {DEBUG: "D", INFO: "I", ERROR: "E"}
_NAME_TO_LEVEL = {"debug": DEBUG, "info": INFO, "error": ERROR, "none": NONE}


def parse_level(name: str) -> int:
    try:
        return _NAME_TO_LEVEL[name.lower()]
    except KeyError:
        raise ValueError(f"unknown log level {name!r}") from None


class Logger:
    """libs/log.Logger with bound context (With)."""

    def __init__(self, sink, context: tuple = ()):
        self._sink = sink
        self._context = context

    def with_(self, **kv) -> "Logger":
        return Logger(self._sink, self._context + tuple(kv.items()))

    def debug(self, msg: str, **kv) -> None:
        self._sink.log(DEBUG, msg, self._context + tuple(kv.items()))

    def info(self, msg: str, **kv) -> None:
        self._sink.log(INFO, msg, self._context + tuple(kv.items()))

    def error(self, msg: str, **kv) -> None:
        self._sink.log(ERROR, msg, self._context + tuple(kv.items()))


class _Sink:
    """Shared formatter/filter/output (one lock per destination)."""

    def __init__(self, stream=None, fmt: str = "plain", level: int = INFO,
                 module_levels: dict | None = None):
        self.stream = stream or sys.stderr
        self.fmt = fmt
        self.level = level
        self.module_levels = {k: parse_level(v) for k, v in (module_levels or {}).items()}
        self._mtx = threading.Lock()

    def _allowed(self, level: int, kv: tuple) -> bool:
        module = next((v for k, v in kv if k == "module"), None)
        threshold = self.module_levels.get(module, self.level)
        return level >= threshold

    def log(self, level: int, msg: str, kv: tuple) -> None:
        if not self._allowed(level, kv):
            return
        now = time.time()
        if self.fmt == "json":
            rec = {"level": _LEVEL_NAMES.get(level, "?"), "ts": now, "msg": msg}
            rec.update({str(k): _jsonable(v) for k, v in kv})
            line = json.dumps(rec)
        else:
            ts = time.strftime("%Y-%m-%d|%H:%M:%S", time.localtime(now))
            ms = int((now % 1) * 1000)
            pairs = " ".join(f"{k}={_render(v)}" for k, v in kv)
            line = f"{_LEVEL_NAMES.get(level, '?')}[{ts}.{ms:03d}] {msg:<44}{(' ' + pairs) if pairs else ''}"
        with self._mtx:
            print(line, file=self.stream, flush=True)


def _render(v) -> str:
    if isinstance(v, bytes):
        return v.hex().upper()[:16]
    return str(v)


def _jsonable(v):
    if isinstance(v, bytes):
        return v.hex()
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def new_logger(
    stream=None,
    fmt: str = "plain",
    level: str = "info",
    module_levels: dict | None = None,
) -> Logger:
    """NewTMLogger + NewFilter in one: `module_levels` maps a module name
    (the `module=...` context key) to its own minimum level."""
    return Logger(_Sink(stream, fmt, parse_level(level), module_levels))


class NopLogger(Logger):
    def __init__(self):
        super().__init__(None)

    def with_(self, **kv):
        return self

    def debug(self, *a, **k):
        pass

    def info(self, *a, **k):
        pass

    def error(self, *a, **k):
        pass
