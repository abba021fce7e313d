"""Namespaced logging (the Spark ``Logging`` trait analogue).

Copy of ``sparkucx_tpu/utils/logging.py``.

The reference logs through Spark's Logging trait everywhere, with a dedicated
named logger for the writer ("LEO", NvkvShuffleMapOutputWriter.scala:71-73) and a
compile-gated debug wrapper (``nvkvLogDebug``, NvkvHandler.scala:42-48).  Here:
one namespace root, per-module child loggers, and an env-tunable level
(``SPARKUCX_TPU_LOG=debug`` — the UCX_LOG_LEVEL analogue, test.sh:126-127).
"""

from __future__ import annotations

import logging
import os

ROOT = "sparkucx_tpu"

_configured = False


def _configure() -> None:
    global _configured
    if _configured:
        return
    _configured = True
    root = logging.getLogger(ROOT)
    level_name = os.environ.get("SPARKUCX_TPU_LOG", "warning").upper()
    root.setLevel(getattr(logging, level_name, logging.WARNING))
    if not root.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
        root.addHandler(handler)
    root.propagate = False


def get_logger(name: str) -> logging.Logger:
    _configure()
    return logging.getLogger(f"{ROOT}.{name}")
