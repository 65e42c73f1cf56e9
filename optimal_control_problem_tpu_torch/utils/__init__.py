from .logging import get_logger, set_verbose, ocp_info, ocp_warn, ocp_error, ocp_debug
from .timing import Timer, profile_solver
from .diagnostics import constraint_report, dump_constraints_csv, kkt_residuals
from .serialization import (
    enable_compilation_cache,
    export_solver,
    import_solver,
    load_solver_state,
    load_state,
    save_solver_state,
    save_state,
)

__all__ = [
    "get_logger",
    "set_verbose",
    "ocp_info",
    "ocp_warn",
    "ocp_error",
    "ocp_debug",
    "Timer",
    "profile_solver",
    "constraint_report",
    "dump_constraints_csv",
    "kkt_residuals",
    "enable_compilation_cache",
    "export_solver",
    "import_solver",
    "load_solver_state",
    "save_solver_state",
    "load_state",
    "save_state",
]
