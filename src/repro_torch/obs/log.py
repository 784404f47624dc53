"""Structured logging emitter for CLI-facing progress lines.

The port's copy of ``repro/obs/log.py``. The emitter routes a launcher's
``[<tag>] ...`` progress lines through :mod:`logging`:

- under the CLIs, :func:`enable_cli_output` attaches a plain
  ``[<tag>] message`` handler to the *current* ``sys.stdout`` (resolved at
  call time, so pytest's ``capsys`` still captures it), preserving the old
  stdout behavior byte-for-byte;
- under pytest / library use no handler is attached, so INFO records
  propagate nowhere and the harness is silent.

Structured fields ride on the record as ``record.fields`` for any future
JSON handler; the human formatter ignores them.
"""

from __future__ import annotations

import logging
import sys
from typing import IO, Optional

__all__ = ["Emitter", "enable_cli_output", "get_emitter"]

_CLI_HANDLER_FLAG = "_repro_torch_cli_handler"


class Emitter:
    """Thin wrapper: ``emit("admitted 3/5", admitted=3, total=5)``."""

    def __init__(self, logger: logging.Logger):
        self.logger = logger

    def emit(self, message: str, **fields) -> None:
        self.logger.info(message, extra={"fields": fields})

    def warn(self, message: str, **fields) -> None:
        self.logger.warning(message, extra={"fields": fields})


def get_emitter(name: str) -> Emitter:
    """Emitter over ``logging.getLogger(name)`` (e.g. ``"repro_torch.planner"``)."""
    return Emitter(logging.getLogger(name))


def enable_cli_output(
    name: str, tag: Optional[str] = None, stream: Optional[IO[str]] = None
) -> logging.Handler:
    """Attach the CLI stdout handler to logger ``name`` (idempotent).

    ``tag`` defaults to the last dotted component of ``name``; lines render
    as ``[<tag>] message`` exactly like the old prints. The stream default is
    resolved *here*, not at import, so test harnesses that swap
    ``sys.stdout`` see the output.
    """
    logger = logging.getLogger(name)
    resolved = stream if stream is not None else sys.stdout
    for h in logger.handlers:
        if getattr(h, _CLI_HANDLER_FLAG, False):
            # Rebind to the current stdout: successive CLI runs under a test
            # harness each get a fresh replaced stream.
            if getattr(h, "stream", None) is not resolved:
                try:
                    h.setStream(resolved)  # type: ignore[attr-defined]
                except ValueError:
                    # setStream flushes the old stream first; a test harness
                    # may have closed it (capsys teardown) — rebind directly
                    h.stream = resolved  # type: ignore[attr-defined]
            return h
    handler = logging.StreamHandler(resolved)
    setattr(handler, _CLI_HANDLER_FLAG, True)
    tag = tag if tag is not None else name.rsplit(".", 1)[-1]
    handler.setFormatter(logging.Formatter(f"[{tag}] %(message)s"))
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    return handler


def disable_cli_output(name: str) -> None:
    """Detach any CLI handler previously attached by :func:`enable_cli_output`."""
    logger = logging.getLogger(name)
    for h in list(logger.handlers):
        if getattr(h, _CLI_HANDLER_FLAG, False):
            logger.removeHandler(h)
