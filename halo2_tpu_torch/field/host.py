"""Host-side prime-field elements (Python ints), the `eth_types::Field` analogue.

The reference unifies halo2's ``FieldExt`` and zkevm's gadget requirements under
one trait bound, ``eth_types::Field`` (reference: README.md:316-320, used in 17
files as ``use eth_types::Field``).  Here the analogue is the :class:`PrimeField`
class family: one dynamically-created subclass per field, each carrying its
:class:`~halo2_tpu.field.params.FieldSpec`.

Host elements are used for witness synthesis, transcript/challenge handling and
constant generation; all bulk arithmetic (mock prover, NTT, MSM) happens on
device via :mod:`halo2_tpu.field.device`.
"""

from __future__ import annotations

from .params import FieldSpec, PASTA_FP, PASTA_FQ, BN254_FR, BN254_FQ


class PrimeField:
    """A field element; subclasses bind ``SPEC``.  Immutable."""

    SPEC: FieldSpec = None  # type: ignore
    __slots__ = ("v",)

    def __init__(self, v: int = 0):
        self.v = v % self.SPEC.p

    # -- constructors -------------------------------------------------------
    @classmethod
    def zero(cls):
        return cls(0)

    @classmethod
    def one(cls):
        return cls(1)

    @classmethod
    def from_u64(cls, v: int):
        return cls(v)

    from_ = from_u64  # `F::from(u64)` spelling

    @classmethod
    def from_u128(cls, v: int):
        return cls(v)

    @classmethod
    def from_repr(cls, b: bytes):
        """Little-endian canonical bytes -> element; None if >= p."""
        v = int.from_bytes(b, "little")
        if v >= cls.SPEC.p:
            return None
        return cls(v)

    @classmethod
    def from_uniform_bytes(cls, b: bytes):
        """Reduce up-to-64 little-endian bytes mod p."""
        return cls(int.from_bytes(b, "little") % cls.SPEC.p)

    @classmethod
    def random(cls, rng):
        """rng: random.Random — uniform element."""
        return cls(rng.getrandbits(cls.SPEC.num_bits + 64) % cls.SPEC.p)

    # -- arithmetic ----------------------------------------------------------
    def __add__(self, o):
        return type(self)(self.v + _val(o))

    __radd__ = __add__

    def __sub__(self, o):
        return type(self)(self.v - _val(o))

    def __rsub__(self, o):
        return type(self)(_val(o) - self.v)

    def __mul__(self, o):
        return type(self)(self.v * _val(o))

    __rmul__ = __mul__

    def __neg__(self):
        return type(self)(-self.v)

    def __pow__(self, e: int):
        return type(self)(pow(self.v, e, self.SPEC.p))

    def square(self):
        return type(self)(self.v * self.v)

    def double(self):
        return type(self)(2 * self.v)

    def invert(self):
        """Multiplicative inverse; raises ZeroDivisionError on zero."""
        return type(self)(pow(self.v, -1, self.SPEC.p))

    def invert_or_zero(self):
        return type(self)(0) if self.v == 0 else self.invert()

    def pow_vartime(self, e: int):
        return self ** e

    def sqrt(self):
        """Tonelli–Shanks square root, or None if non-residue."""
        p = self.SPEC.p
        if self.v == 0:
            return type(self)(0)
        if pow(self.v, (p - 1) // 2, p) != 1:
            return None
        spec = self.SPEC
        s, q = spec.two_adicity, (p - 1) >> spec.two_adicity
        z = pow(spec.generator, q, p)
        m, c, t, r = s, z, pow(self.v, q, p), pow(self.v, (q + 1) // 2, p)
        while t != 1:
            t2, i = t, 0
            while t2 != 1:
                t2 = t2 * t2 % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            m, c = i, b * b % p
            t, r = t * c % p, r * b % p
        return type(self)(r)

    # -- comparisons / misc --------------------------------------------------
    def __eq__(self, o):
        if isinstance(o, PrimeField):
            return type(o) is type(self) and o.v == self.v
        if isinstance(o, int):
            return self.v == o % self.SPEC.p
        return NotImplemented

    def __hash__(self):
        return hash((self.SPEC.name, self.v))

    def __lt__(self, o):  # canonical-int order (halo2curves `Ord`)
        return self.v < _val(o)

    def __int__(self):
        return self.v

    def __repr__(self):
        return f"{type(self).__name__}(0x{self.v:064x})"

    def is_zero(self) -> bool:
        return self.v == 0

    def to_repr(self) -> bytes:
        """32 little-endian canonical bytes (halo2curves `to_repr`)."""
        return self.v.to_bytes(32, "little")

    def to_mont(self) -> int:
        return (self.v * self.SPEC.r) % self.SPEC.p


def _val(o) -> int:
    if isinstance(o, PrimeField):
        return o.v
    if isinstance(o, int):
        return o
    raise TypeError(f"cannot coerce {type(o)} to field element")


_CLASSES: dict[str, type] = {}


def field_class(spec: FieldSpec) -> type[PrimeField]:
    """Get (and cache) the PrimeField subclass for a spec."""
    cls = _CLASSES.get(spec.name)
    if cls is None:
        cls = type(
            spec.name.title().replace("_", ""),
            (PrimeField,),
            {"SPEC": spec, "__slots__": ()},
        )
        _CLASSES[spec.name] = cls
    return cls


Fp = field_class(PASTA_FP)       # pasta Fp  (mock tests' field)
Fq_pasta = field_class(PASTA_FQ)
Fr = field_class(BN254_FR)       # bn254 Fr  (KZG scalar field)
Fq = field_class(BN254_FQ)       # bn254 Fq  (G1 coordinates)
