"""Logger surface matching the reference's setup (`optical_flow.py:15-22`),
a copy of `optical_flow_tpu.utils.logging`: INFO level,
'%(asctime)s - %(name)s - %(levelname)s - %(message)s' on a StreamHandler,
propagate=False so messages do not appear twice.
"""

from __future__ import annotations

import logging

_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger
