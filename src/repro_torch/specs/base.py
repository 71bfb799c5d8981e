"""Spec machinery: frozen, JSON-round-trippable experiment descriptions.

Every spec in `repro_torch.specs` is a frozen dataclass deriving from `Spec`,
which contributes one serialization contract:

  spec.to_dict()  -> plain dict of JSON types (tuples become lists,
                     nested specs become nested dicts)
  Spec.from_dict(d) -> the spec back, with lists re-tupled and nested
                     dicts re-hydrated from the field's annotated type;
                     unknown keys are an error (a spec written by a newer
                     version must fail loudly, not be silently truncated)
  to_json / from_json -> the same through a JSON string

Round-tripping is exact: `Spec.from_json(spec.to_json()) == spec` for any
spec built from JSON-representable field values. This is what lets the
full experiment description ride inside the BSR checkpoint manifest and
come back out as the same object (repro_torch.xmc_api.CheckpointHandle).
The serialized form is the JAX package's, field for field, so a manifest
written by either package reads back in the other.

The package is a leaf: nothing here imports torch or the rest of
`repro_torch`, so specs can be built, serialized, and validated in
processes that never touch an accelerator.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from typing import Any


def _to_jsonable(v: Any) -> Any:
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: _to_jsonable(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, (tuple, list)):
        return [_to_jsonable(x) for x in v]
    return v


def _coerce(tp: Any, v: Any) -> Any:
    """Re-hydrate a JSON value into the shape a field annotation promises."""
    origin = typing.get_origin(tp)
    if origin is typing.Union:                       # Optional[...] and friends
        if v is None:
            return None
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        return _coerce(args[0], v) if len(args) == 1 else v
    if isinstance(tp, type) and dataclasses.is_dataclass(tp):
        return tp.from_dict(v) if isinstance(v, dict) else v
    if origin is tuple:
        args = typing.get_args(tp)
        if len(args) == 2 and args[1] is Ellipsis:   # tuple[T, ...]
            return tuple(_coerce(args[0], x) for x in v)
        return tuple(_coerce(a, x) for a, x in zip(args, v))
    return v


class Spec:
    """Serialization mixin shared by every spec dataclass."""

    def to_dict(self) -> dict:
        return _to_jsonable(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Spec":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(
                f"{cls.__name__} does not know field(s) {sorted(unknown)}; "
                f"valid fields: {sorted(fields)}")
        hints = typing.get_type_hints(cls)
        return cls(**{k: _coerce(hints[k], v) for k, v in d.items()})

    def to_json(self, *, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Spec":
        return cls.from_dict(json.loads(s))

    def replace(self, **changes) -> "Spec":
        return dataclasses.replace(self, **changes)
