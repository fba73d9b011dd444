"""F15.16 saturating fixed-point (CommonLibs/F16.h:45).

The reference keeps this class for legacy signal code; it is unused by
the main path but part of the public surface. Implemented over Python
ints with the same 15.16 split and saturation semantics.
"""

from __future__ import annotations

_SHIFT = 16
_MAX = (1 << 31) - 1
_MIN = -(1 << 31)


def _sat(v: int) -> int:
    return max(_MIN, min(_MAX, v))


class F16:
    """Saturating 15.16 fixed-point number."""

    __slots__ = ("raw",)

    def __init__(self, value: float | int = 0, *, raw: int | None = None):
        self.raw = _sat(raw if raw is not None
                        else int(round(float(value) * (1 << _SHIFT))))

    def __float__(self) -> float:
        return self.raw / (1 << _SHIFT)

    def __add__(self, other: "F16") -> "F16":
        return F16(raw=_sat(self.raw + _as(other).raw))

    def __sub__(self, other: "F16") -> "F16":
        return F16(raw=_sat(self.raw - _as(other).raw))

    def __mul__(self, other: "F16") -> "F16":
        return F16(raw=_sat((self.raw * _as(other).raw) >> _SHIFT))

    def __truediv__(self, other: "F16") -> "F16":
        return F16(raw=_sat((self.raw << _SHIFT) // _as(other).raw))

    def __neg__(self) -> "F16":
        return F16(raw=_sat(-self.raw))

    def __eq__(self, other) -> bool:
        return self.raw == _as(other).raw

    def __lt__(self, other) -> bool:
        return self.raw < _as(other).raw

    def __repr__(self) -> str:
        return f"F16({float(self):.6f})"


def _as(v) -> F16:
    return v if isinstance(v, F16) else F16(v)
