"""Shared logger (role of dlrover/python/common/log.py).

Copy of ``dlrover_tpu/common/log.py`` (the port imports nothing of the JAX
package).
"""

import logging
import os
import sys

_FORMAT = (
    "[%(asctime)s] [%(levelname)s] "
    "[%(filename)s:%(lineno)d:%(funcName)s] %(message)s"
)


def _build_logger() -> logging.Logger:
    logger = logging.getLogger("dlrover_tpu")
    if logger.handlers:
        return logger
    level = os.getenv("DLROVER_LOG_LEVEL", "INFO").upper()
    logger.setLevel(getattr(logging, level, logging.INFO))
    handler = logging.StreamHandler(stream=sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(handler)
    logger.propagate = False
    return logger


default_logger = _build_logger()
