"""Typed config base.

Counterpart of ``deepspeed_tpu/runtime/config_utils.py``, whose
``DSConfigModel`` is a pydantic model. The port depends on torch and numpy
only, so the base here is a small dataclass-driven one with the behaviour
the config system relies on: construction from keyword arguments, nested
dicts turned into their typed sub-blocks, ``None`` replaced by the field's
default, unknown keys kept as plain attributes (pydantic ``extra="allow"``),
values checked against the annotated type, ``to_dict`` round-tripping, and
``model_fields_set`` naming the keys the caller gave, and an ``_after``
hook for the checks pydantic's validators make. A field may carry an
alias (``field(..., metadata={"alias": "tp"})``): the block is populated by
the field's name or by its alias, as pydantic's ``Field(alias=...)`` with
``populate_by_name`` does, and ``to_dict`` writes the name.
"""

from __future__ import annotations

import dataclasses
import enum
import typing
from typing import Any

AUTO = "auto"


def _default_of(f: dataclasses.Field):
    if f.default is not dataclasses.MISSING:
        return f.default
    if f.default_factory is not dataclasses.MISSING:
        return f.default_factory()
    raise TypeError(f"config field {f.name!r} has no default")


def _coerce(hint, value, where: str):
    """``value`` as the annotated type ``hint``; raises ValueError (as
    pydantic's ValidationError is one) on a value the type does not take."""
    origin = typing.get_origin(hint)
    if hint is Any:
        return value
    if origin is typing.Union:
        args = typing.get_args(hint)
        if value is None and type(None) in args:
            return None
        errors = []
        for a in args:
            if a is type(None):
                continue
            try:
                return _coerce(a, value, where)
            except ValueError as e:
                errors.append(str(e))
        raise ValueError("; ".join(errors))
    if origin in (dict, list, tuple):
        want = {dict: dict, list: (list, tuple), tuple: (list, tuple)}[origin]
        if not isinstance(value, want):
            raise ValueError(f"{where}: expected {origin.__name__}, got "
                             f"{type(value).__name__}")
        args = typing.get_args(hint)
        if origin is dict and len(args) == 2:
            return {_coerce(args[0], k, where): _coerce(args[1], v,
                                                       f"{where}[{k!r}]")
                    for k, v in value.items()}
        if origin is list and len(args) == 1:
            return [_coerce(args[0], v, f"{where}[{i}]")
                    for i, v in enumerate(value)]
        return origin(value)
    if isinstance(hint, type):
        if issubclass(hint, DSConfigModel):
            if isinstance(value, hint):
                return value
            if isinstance(value, dict):
                return hint(**value)
            raise ValueError(f"{where}: expected a dict or {hint.__name__}, "
                             f"got {type(value).__name__}")
        if issubclass(hint, enum.Enum):
            return hint(value)
        if hint is bool:
            if isinstance(value, bool):
                return value
            if value in (0, 1, "true", "false", "True", "False"):
                return value in (1, "true", "True")
            raise ValueError(f"{where}: expected a bool, got {value!r}")
        if hint is int:
            if isinstance(value, bool) or not isinstance(value, (int, float,
                                                                str)):
                raise ValueError(f"{where}: expected an int, got {value!r}")
            if isinstance(value, float) and value != int(value):
                raise ValueError(f"{where}: expected an int, got {value!r}")
            try:
                return int(value)
            except ValueError:
                raise ValueError(f"{where}: expected an int, got {value!r}")
        if hint is float:
            if isinstance(value, bool) or not isinstance(value, (int, float,
                                                                str)):
                raise ValueError(f"{where}: expected a float, got {value!r}")
            try:
                return float(value)
            except ValueError:
                raise ValueError(f"{where}: expected a float, got {value!r}")
        if hint is str:
            if not isinstance(value, str):
                raise ValueError(f"{where}: expected a str, got {value!r}")
            return value
    return value


class DSConfigModel:
    """Base for all config blocks. Subclasses are ``@dataclass(init=False)``
    classes whose fields all have defaults."""

    def __init__(self, strict: bool = False, **data: Any):
        data = self._before(dict(data))
        hints = typing.get_type_hints(type(self))
        names = set()
        for f in dataclasses.fields(self):
            names.add(f.name)
            alias = f.metadata.get("alias")
            if alias is not None and alias in data:
                data[f.name] = data.pop(alias)
            if f.name in data and not (data[f.name] is None and not strict):
                value = _coerce(hints[f.name], data[f.name],
                                f"{type(self).__name__}.{f.name}")
            else:
                value = _default_of(f)
            object.__setattr__(self, f.name, value)
        extra = {k: v for k, v in data.items() if k not in names}
        for k, v in extra.items():
            object.__setattr__(self, k, v)
        object.__setattr__(self, "model_extra", extra)
        object.__setattr__(self, "model_fields_set", set(data))
        self._after()

    def _after(self) -> None:
        """Hook run on the built block (pydantic's ``field_validator`` and
        ``model_validator(mode="after")``): raise ``ValueError`` to refuse
        the block, or normalise fields in place."""

    @classmethod
    def _before(cls, data: dict) -> dict:
        """Hook run on the raw keyword dict (a ``mode="before"``
        validator)."""
        return data

    def __setattr__(self, name, value):
        # validate on assignment, as the pydantic base does
        fields = {f.name for f in dataclasses.fields(self)}
        if name in fields:
            value = _coerce(typing.get_type_hints(type(self))[name], value,
                            f"{type(self).__name__}.{name}")
        object.__setattr__(self, name, value)

    def to_dict(self) -> dict:
        def plain(v):
            if isinstance(v, DSConfigModel):
                return v.to_dict()
            if isinstance(v, enum.Enum):
                return v.value
            if isinstance(v, dict):
                return {k: plain(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [plain(x) for x in v]
            return v

        out = {f.name: plain(getattr(self, f.name))
               for f in dataclasses.fields(self)}
        out.update({k: plain(v) for k, v in self.model_extra.items()})
        return out

    model_dump = to_dict

    def __eq__(self, other):
        return type(other) is type(self) and self.to_dict() == other.to_dict()

    def __repr__(self):
        return f"{type(self).__name__}({self.to_dict()!r})"


def get_scalar_param(param_dict: dict, param_name: str, param_default_value):
    return param_dict.get(param_name, param_default_value)


def get_dict_param(param_dict: dict, param_name: str, param_default_value):
    return param_dict.get(param_name, param_default_value)


def dict_raise_error_on_duplicate_keys(ordered_pairs):
    """``json.load`` ``object_pairs_hook`` that rejects duplicate keys."""
    d = dict(ordered_pairs)
    if len(d) != len(ordered_pairs):
        counter: dict = {}
        for k, _ in ordered_pairs:
            counter[k] = counter.get(k, 0) + 1
        keys = [k for k, v in counter.items() if v > 1]
        raise ValueError(f"Duplicate keys in DeepSpeed config: {keys}")
    return d
