"""Problem configuration and variable layout — port of
``optimal_control_problem_tpu/config.py`` (the reference's ``OCPConfig`` +
``Frame``, ``OCPConfig.h:31-85`` / ``OCPConfig.cpp``).

A copy of the framework-neutral JAX-package module: YAML schema parity
(``discretization_settings{dt, horizon}``, ``OCP_variables`` with
``.inf``/``-.inf`` parsing), the ``Frame`` field layout, the flat decision
vector ``X`` of size ``horizon * frame_size`` (a :class:`..sym.Sym` leaf),
one-frame bounds replicated across the horizon, and the initial-guess
store.  Bounds are numpy arrays; the solvers move them to their device.

``yaml`` is imported only when a config is given as a YAML string or file:
a dict config (what ``models.*.make_config`` returns) needs no ``pyyaml``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from .sym import Sym, sym
from .utils.logging import ocp_info, ocp_warn

__all__ = ["Frame", "OCPConfig", "load_config"]


def load_config(source: Any) -> Dict[str, Any]:
    """Load a config mapping from a dict, a YAML string, or a file path.

    Accepts either the full document or the subtree under the conventional
    top-level ``optimal_control_problem`` key (``readme.md:44-62``).
    """
    if isinstance(source, dict):
        node = source
    elif isinstance(source, str):
        import yaml

        if "\n" not in source and (
            source.endswith((".yaml", ".yml")) or "/" in source
        ):
            with open(source) as f:
                node = yaml.safe_load(f)
        else:
            node = yaml.safe_load(source)
    else:
        raise TypeError(f"cannot load config from {type(source)!r}")
    if not isinstance(node, dict):
        raise ValueError("config must be a mapping")
    if "optimal_control_problem" in node and "OCP_variables" not in node:
        node = node["optimal_control_problem"]
    return node


def _parse_bound_value(v: Any) -> float:
    """Parse a bound entry with CasADi-style infinity strings.

    Mirrors ``OCPConfig.cpp:154-169``: accepts ``.inf``/``.Inf``/``.INF`` and
    the negated forms; PyYAML already parses bare ``.inf`` to ``float`` which
    we accept directly.
    """
    if isinstance(v, str):
        s = v.strip()
        if s in (".inf", ".Inf", ".INF", "inf", "Inf", "INF"):
            return float("inf")
        if s in ("-.inf", "-.Inf", "-.INF", "-inf", "-Inf", "-INF"):
            return float("-inf")
        return float(s)
    return float(v)


@dataclass
class Frame:
    """Named variable fields within one discretization step.

    Analog of ``struct Frame`` (``OCPConfig.h:31-35``).
    """

    total_size: int = 0
    fields: List[Tuple[str, int]] = field(default_factory=list)
    field_offsets: Dict[str, int] = field(default_factory=dict)

    @classmethod
    def from_config(cls, entries: Sequence[Dict[str, Any]]) -> "Frame":
        """Build a frame from ``[{name, size}, ...]`` (``OCPConfig.cpp:56-81``)."""
        frame = cls()
        for entry in entries:
            if "name" not in entry:
                raise ValueError("Field name not found in frame")
            name = str(entry["name"])
            if "size" not in entry:
                raise ValueError("Field size not found in frame")
            size = int(entry["size"])
            if size <= 0:
                raise ValueError(f"Field size must be positive: {name}")
            if name in frame.field_offsets:
                raise ValueError(f"Duplicate field name in frame: {name}")
            frame.fields.append((name, size))
            frame.field_offsets[name] = frame.total_size
            frame.total_size += size
        return frame

    def field_size(self, name: str) -> int:
        for fname, fsize in self.fields:
            if fname == name:
                return fsize
        raise KeyError(name)

    def slice_of(self, name: str) -> slice:
        off = self.field_offsets[name]
        return slice(off, off + self.field_size(name))


class OCPConfig:
    """Discretization, variable layout, and box bounds for one OCP.

    Mirrors the reference ``OCPConfig`` (``OCPConfig.cpp:83-104``): parses
    ``discretization_settings`` and ``OCP_variables``, creates the flat
    decision symbol ``X`` of size ``horizon * frame_size``, and replicates
    one-frame bounds across the horizon.
    """

    def __init__(self, config_node: Any):
        node = load_config(config_node)
        ocp_info("parsing OCP configuration")
        try:
            disc = node["discretization_settings"]
            self._dt = float(disc["dt"])
            self._horizon = int(disc["horizon"])
        except KeyError as e:
            raise ValueError(f"missing discretization_settings entry: {e}") from e
        if self._horizon <= 0:
            raise ValueError("horizon must be positive")
        if self._dt <= 0:
            raise ValueError("dt must be positive")
        ocp_info(f"dt: {self._dt}  horizon: {self._horizon}")

        self._verbose = bool(
            node.get("solver_settings", {}).get("verbose", False)
        )
        self._parse_bounds(node)
        # The flat decision vector, analog of
        # ``variables_ = SX::sym("X", horizon*frameSize)`` (OCPConfig.cpp:102).
        self._variables = sym("X", self._horizon * self._frame.total_size)
        self._initial_guess: np.ndarray | None = None
        ocp_info("OCPConfig initialized")

    # -- parsing ----------------------------------------------------------
    def _parse_bounds(self, node: Dict[str, Any]) -> None:
        """Parse ``OCP_variables`` (``parseOCPBounds``, OCPConfig.cpp:107-249)."""
        if "OCP_variables" not in node:
            raise ValueError("node [OCP_variables] not found in config")
        entries = node["OCP_variables"]
        if not isinstance(entries, list):
            raise ValueError("OCP_variables should be a sequence")
        self._frame = Frame.from_config(entries)
        ocp_info(f"frame size: {self._frame.total_size}")

        lower_parts, upper_parts = [], []
        for entry in entries:
            name, size = str(entry["name"]), int(entry["size"])
            for key, parts in (("lower_bound", lower_parts), ("upper_bound", upper_parts)):
                if key not in entry:
                    raise ValueError(f"Missing {key} for variable: {name}")
                raw = entry[key]
                vals = np.zeros(size, dtype=np.float64)
                if isinstance(raw, list):
                    if len(raw) != size:
                        # Reference only warns on size mismatch
                        # (OCPConfig.cpp:146-150) and fills what it can.
                        ocp_warn(
                            f"variable {name}: {key} has {len(raw)} entries, "
                            f"expected {size}"
                        )
                    for i in range(min(len(raw), size)):
                        vals[i] = _parse_bound_value(raw[i])
                else:
                    ocp_warn(f"variable {name}: {key} is not a sequence")
                parts.append(vals)

        one_lower = np.concatenate(lower_parts)
        one_upper = np.concatenate(upper_parts)
        # Replicate one-frame bounds across the horizon
        # (coverLower/UpperBounds, OCPConfig.cpp:293-328).
        self._lower_bounds = [one_lower.copy() for _ in range(self._horizon)]
        self._upper_bounds = [one_upper.copy() for _ in range(self._horizon)]

    # -- variable access --------------------------------------------------
    def get_variable(self, step_id: int, variable_name: str) -> Sym:
        """Named slice of the decision vector (``getVariable``, OCPConfig.cpp:29-46)."""
        if step_id < 0 or step_id >= self._horizon:
            raise IndexError("Frame ID out of range")
        if variable_name not in self._frame.field_offsets:
            raise KeyError("Field name not found in frame")
        start = step_id * self._frame.total_size + self._frame.field_offsets[
            variable_name
        ]
        return self._variables[start : start + self._frame.field_size(variable_name)]

    def get_frame(self, step_id: int) -> Sym:
        """All variables of one step as a single slice."""
        if step_id < 0 or step_id >= self._horizon:
            raise IndexError("Frame ID out of range")
        fs = self._frame.total_size
        return self._variables[step_id * fs : (step_id + 1) * fs]

    def get_variables(self) -> Sym:
        return self._variables

    # -- getters (parity with OCPConfig.cpp:331-421) ----------------------
    def get_horizon(self) -> int:
        return self._horizon

    def get_dt(self) -> float:
        return self._dt

    def get_frame_size(self) -> int:
        return self._frame.total_size

    @property
    def frame(self) -> Frame:
        return self._frame

    def get_lower_bounds(self) -> List[np.ndarray]:
        if not self._lower_bounds:
            ocp_warn("lower bounds requested but empty")
        return self._lower_bounds

    def get_upper_bounds(self) -> List[np.ndarray]:
        if not self._upper_bounds:
            ocp_warn("upper bounds requested but empty")
        return self._upper_bounds

    def lower_bounds_flat(self) -> np.ndarray:
        return np.concatenate(self._lower_bounds)

    def upper_bounds_flat(self) -> np.ndarray:
        return np.concatenate(self._upper_bounds)

    def set_initial_guess(self, initial_guess: np.ndarray) -> None:
        """Store a full-horizon initial guess (``setInitialGuess``, OCPConfig.cpp:403-413)."""
        ig = np.asarray(initial_guess, dtype=np.float64).reshape(-1)
        expected = self._horizon * self._frame.total_size
        if ig.shape[0] != expected:
            raise ValueError(
                f"initial guess has {ig.shape[0]} entries, expected {expected}"
            )
        self._initial_guess = ig

    def get_initial_guess(self) -> np.ndarray | None:
        return self._initial_guess

    # -- convenience ------------------------------------------------------
    @property
    def num_variables(self) -> int:
        return self._horizon * self._frame.total_size
