"""Logging utilities — analog of the reference's ``OCP_LOG``/``OCP_INFO``/
``OCP_WARN``/``OCP_ERROR``/``OCP_DEBUG`` printf macros
(``/root/reference/include/optimal_control_problem/OCP_config/OCPConfig.h:10-20``).

The reference gates everything behind a compile-time ``DEBUG_OCP`` flag; here
we use a standard :mod:`logging` logger gated at runtime, which composes with
user applications instead of spamming stdout.
"""

from __future__ import annotations

import logging
import os

_LOGGER = logging.getLogger("ocp_tpu")
if not _LOGGER.handlers:
    _handler = logging.StreamHandler()
    _handler.setFormatter(logging.Formatter("[OCP %(levelname)s] %(message)s"))
    _LOGGER.addHandler(_handler)
    _LOGGER.setLevel(
        logging.DEBUG if os.environ.get("OCP_TPU_DEBUG") else logging.WARNING
    )


def get_logger() -> logging.Logger:
    return _LOGGER


def set_verbose(verbose: bool) -> None:
    _LOGGER.setLevel(logging.INFO if verbose else logging.WARNING)


def ocp_info(msg: str) -> None:
    _LOGGER.info(msg)


def ocp_warn(msg: str) -> None:
    _LOGGER.warning(msg)


def ocp_error(msg: str) -> None:
    _LOGGER.error(msg)


def ocp_debug(msg: str) -> None:
    _LOGGER.debug(msg)
