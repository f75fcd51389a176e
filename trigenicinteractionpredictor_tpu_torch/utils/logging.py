"""Structured JSONL event logging (SURVEY.md §6 "Metrics / logging").

The reference's observability is ``print`` of the likelihood every ``freq``
iterations plus text output files.  Here every work unit (fold x K x restart)
appends structured events — sweep index, log-likelihood, delta, throughput,
wall-clock — to a JSONL file, while stdout stays human-readable.

The port's own copy of the reference's ``utils/logging.py``.
"""

from __future__ import annotations

import io
import json
import os
import sys
import time
from typing import Any, Optional


class JsonlLogger:
    """Append-only JSONL event log with optional human-readable echo."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._fh: Optional[io.TextIOBase] = None
        if path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def log(self, event: str, **fields: Any) -> None:
        if self._fh is None and not self.echo:
            return
        rec = {"event": event, "t": time.time(), **fields}
        line = json.dumps(rec, sort_keys=True, default=_json_default)
        if self._fh is not None:
            self._fh.write(line + "\n")
        if self.echo:
            human = " ".join(
                f"{k}={_fmt(v)}" for k, v in fields.items() if not k.startswith("_")
            )
            print(f"[{event}] {human}", file=sys.stderr)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "JsonlLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def _json_default(v: Any):
    # numpy / jax scalars
    for attr in ("item", "tolist"):
        fn = getattr(v, attr, None)
        if callable(fn):
            try:
                return fn()
            except Exception:
                pass
    return str(v)


_default: Optional[JsonlLogger] = None


def get_logger() -> JsonlLogger:
    """Process-wide echo-only logger for code paths without a run directory."""
    global _default
    if _default is None:
        _default = JsonlLogger(path=None, echo=True)
    return _default
