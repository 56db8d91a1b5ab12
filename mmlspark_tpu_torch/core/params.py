"""Parameter DSL for pipeline stages (the PyTorch port's own copy of
`mmlspark_tpu/core/params.py`, kept separate so the port never imports the
JAX package).

Every stage declares typed `Param`s with defaults, optional value domains
and validators; params are introspectable and JSON-serializable (driving
save/load), with the same names and semantics as the JAX package's stages.
"""

from __future__ import annotations

import copy as _copy
from typing import Any, Callable, Optional, Sequence

_SENTINEL = object()


class ParamError(ValueError):
    """Raised on invalid parameter values (reference Exceptions.scala:21-35)."""


class Param:
    """A typed, named parameter attached to a Params subclass.

    Acts as a descriptor: reading from an instance returns the instance's
    value (or the default); writing validates and stores.
    """

    def __init__(
        self,
        default: Any = _SENTINEL,
        doc: str = "",
        *,
        ptype: Optional[type] = None,
        domain: Optional[Sequence[Any]] = None,
        validator: Optional[Callable[[Any], bool]] = None,
        required: bool = False,
    ):
        self.name: str = ""  # filled in by __set_name__
        self.doc = doc
        self.ptype = ptype
        self.domain = tuple(domain) if domain is not None else None
        self.validator = validator
        self.required = required
        self.has_default = default is not _SENTINEL
        self.default = default if self.has_default else None

    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj.get(self.name)

    def __set__(self, obj, value):
        obj.set(self.name, value)

    def validate(self, value: Any) -> Any:
        if value is None:
            return value
        if self.ptype is not None:
            if self.ptype is float and isinstance(value, int) and not isinstance(value, bool):
                value = float(value)
            if not isinstance(value, self.ptype):
                expected = (self.ptype.__name__ if isinstance(self.ptype, type)
                            else "/".join(t.__name__ for t in self.ptype))
                raise ParamError(
                    f"param '{self.name}' expects {expected}, "
                    f"got {type(value).__name__}: {value!r}")
        if self.domain is not None and value not in self.domain:
            raise ParamError(
                f"param '{self.name}' value {value!r} not in domain {self.domain}")
        if self.validator is not None and not self.validator(value):
            raise ParamError(f"param '{self.name}' value {value!r} failed validation")
        return value

    def __repr__(self):
        return f"Param(name={self.name!r}, default={self.default!r})"


class Params:
    """Base class providing the param protocol.

    Subclasses declare class-level `Param` attributes. Instance values are
    kept in `_paramMap`; defaults live on the Param objects themselves, so
    `explain_params` / persistence can distinguish set-vs-default (the same
    distinction SparkML's ParamMap keeps).
    """

    def __init__(self, **kwargs):
        self._paramMap: dict[str, Any] = {}
        self.set_params(**kwargs)

    # -- introspection -------------------------------------------------
    @classmethod
    def params(cls) -> dict[str, Param]:
        """All declared params, including inherited ones (MRO order)."""
        cached = cls.__dict__.get("_params_cache")
        if cached is not None:
            return cached
        out: dict[str, Param] = {}
        for klass in reversed(cls.__mro__):
            for k, v in vars(klass).items():
                if isinstance(v, Param):
                    out[k] = v
        cls._params_cache = out
        return out

    @classmethod
    def has_param(cls, name: str) -> bool:
        return name in cls.params()

    def explain_params(self) -> str:
        lines = []
        for name, p in sorted(self.params().items()):
            cur = self._paramMap.get(name, _SENTINEL)
            state = f"current: {cur!r}" if cur is not _SENTINEL else (
                f"default: {p.default!r}" if p.has_default else "unset")
            lines.append(f"{name}: {p.doc} ({state})")
        return "\n".join(lines)

    # -- get/set -------------------------------------------------------
    def get(self, name: str) -> Any:
        p = self._param(name)
        if name in self._paramMap:
            return self._paramMap[name]
        if p.has_default:
            return p.default
        return None

    def is_set(self, name: str) -> bool:
        self._param(name)
        return name in self._paramMap

    def set(self, name: str, value: Any) -> "Params":
        p = self._param(name)
        self._paramMap[name] = p.validate(value)
        return self

    def set_params(self, **kwargs) -> "Params":
        for k, v in kwargs.items():
            self.set(k, v)
        return self

    def clear(self, name: str) -> "Params":
        self._paramMap.pop(name, None)
        return self

    def _param(self, name: str) -> Param:
        try:
            return self.params()[name]
        except KeyError:
            raise ParamError(
                f"{type(self).__name__} has no param '{name}'; "
                f"available: {sorted(self.params())}") from None

    def _check_required(self):
        for name, p in self.params().items():
            if p.required and name not in self._paramMap:
                raise ParamError(
                    f"{type(self).__name__}: required param '{name}' is not set")

    # -- copy ----------------------------------------------------------
    def copy(self, **overrides) -> "Params":
        new = _copy.copy(self)
        new._paramMap = dict(self._paramMap)
        new.set_params(**overrides)
        return new

    # -- persistence helpers (JSON-safe values only) -------------------
    def param_values(self, set_only: bool = True) -> dict[str, Any]:
        if set_only:
            return dict(self._paramMap)
        return {name: self.get(name) for name in self.params()}



def domain(*values) -> tuple:
    """Helper mirroring the reference's string-domain params (Params.scala:103-108)."""
    return tuple(values)
