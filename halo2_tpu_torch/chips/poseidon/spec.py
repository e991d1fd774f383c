"""MySpec — the reference's custom Poseidon Spec (src/chips/poseidon/spec.rs).

P128Pow5T3 hardcodes WIDTH=3/RATE=2 (rationale at spec.rs:5-10); MySpec keeps
the same rounds (8 full :17, 56 partial :21, x^5 sbox :25-27, secure_mds=0
:29-31) for arbitrary WIDTH/RATE.  Note the reference's caveat (README.md:370)
that 56 partial rounds regardless of width is an unchecked security choice —
preserved as-is for parity.
"""

from ...poseidon.primitives import MySpec, P128Pow5T3  # noqa: F401
