from .logging import get_logger, set_verbose, ocp_info, ocp_warn, ocp_error, ocp_debug

__all__ = [
    "get_logger",
    "set_verbose",
    "ocp_info",
    "ocp_warn",
    "ocp_error",
    "ocp_debug",
]
