"""``Value<F>`` — maybe-known witness values (halo2 `circuit::Value`).

Supports the slice of the Value API the reference uses (SURVEY.md §1.A):
``known / unknown / default / map / zip / as_ref`` plus arithmetic between
Values and with plain field elements.
"""

from __future__ import annotations


class Value:
    __slots__ = ("_v", "_known")

    def __init__(self, v=None, known=False):
        self._v = v
        self._known = known

    # -- constructors -------------------------------------------------------
    @staticmethod
    def known(v) -> "Value":
        return Value(v, True)

    @staticmethod
    def unknown() -> "Value":
        return Value()

    @staticmethod
    def default() -> "Value":
        return Value()

    @staticmethod
    def wrap(v) -> "Value":
        return v if isinstance(v, Value) else Value.known(v)

    # -- access -------------------------------------------------------------
    @property
    def is_known(self) -> bool:
        return self._known

    def value(self):
        """The inner value; None if unknown."""
        return self._v if self._known else None

    def unwrap(self):
        if not self._known:
            raise ValueError("Value is unknown")
        return self._v

    def as_ref(self) -> "Value":
        return self

    def copied(self) -> "Value":
        return self

    # -- combinators --------------------------------------------------------
    def map(self, f) -> "Value":
        return Value.known(f(self._v)) if self._known else Value.unknown()

    def zip(self, other: "Value") -> "Value":
        if self._known and other._known:
            return Value.known((self._v, other._v))
        return Value.unknown()

    def and_then(self, f) -> "Value":
        return f(self._v) if self._known else Value.unknown()

    def assert_if_known(self, pred):
        if self._known:
            assert pred(self._v)

    # -- arithmetic ---------------------------------------------------------
    def _bin(self, other, op):
        other = Value.wrap(other)
        if self._known and other._known:
            return Value.known(op(self._v, other._v))
        return Value.unknown()

    def __add__(self, o):
        return self._bin(o, lambda a, b: a + b)

    def __radd__(self, o):
        return Value.wrap(o)._bin(self, lambda a, b: a + b)

    def __sub__(self, o):
        return self._bin(o, lambda a, b: a - b)

    def __rsub__(self, o):
        return Value.wrap(o)._bin(self, lambda a, b: a - b)

    def __mul__(self, o):
        return self._bin(o, lambda a, b: a * b)

    def __rmul__(self, o):
        return Value.wrap(o)._bin(self, lambda a, b: a * b)

    def __neg__(self):
        return self.map(lambda a: -a)

    def __repr__(self):
        return f"Value::known({self._v!r})" if self._known else "Value::unknown"
