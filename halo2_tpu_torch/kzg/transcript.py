"""Blake2b Fiat-Shamir transcript (halo2 `transcript::{Blake2bWrite, Blake2bRead}`).

Matches halo2's construction (reference src/circuits/utils.rs:17,39,55):
blake2b with 64-byte digest personalized "Halo2-Transcript"; domain-separation
prefixes 0/1/2 for challenge/point/scalar; challenges squeezed by finalizing a
clone of the running state and reducing 64 bytes little-endian mod r
(Challenge255 semantics).

Point wire format: 32 bytes = x in little-endian with the y-parity flag in the
top bit (BN254 Fq leaves the top two bits free); the identity encodes as all
zeros.  Self-consistent serialization, documented divergence from halo2curves'
exact flag layout.
"""

from __future__ import annotations

import hashlib

from ..ec import host as ec
from ..field.host import Fq, Fr

PREFIX_CHALLENGE = b"\x00"
PREFIX_POINT = b"\x01"
PREFIX_SCALAR = b"\x02"


def compress_g1(pt) -> bytes:
    if pt is None:
        return bytes(32)
    x, y = ec.g1_to_ints(pt)
    flag = (y & 1) << 255
    return (x | flag).to_bytes(32, "little")


def decompress_g1(b: bytes):
    v = int.from_bytes(b, "little")
    if v == 0:
        return None
    x = v & ((1 << 254) - 1)
    parity = v >> 255
    xe = Fq(x)
    y2 = xe * xe * xe + Fq(3)
    y = y2.sqrt()
    if y is None:
        raise ValueError("invalid point encoding")
    if int(y) & 1 != parity:
        y = -y
    return ec.g1_from_ints(int(xe), int(y))


class _TranscriptBase:
    def __init__(self):
        self.state = hashlib.blake2b(digest_size=64, person=b"Halo2-Transcript")

    def common_point(self, pt):
        self.state.update(PREFIX_POINT)
        x, y = ec.g1_to_ints(pt)
        self.state.update(x.to_bytes(32, "little"))
        self.state.update(y.to_bytes(32, "little"))

    def common_scalar(self, s):
        self.state.update(PREFIX_SCALAR)
        self.state.update(int(s).to_bytes(32, "little"))

    def squeeze_challenge(self) -> Fr:
        self.state.update(PREFIX_CHALLENGE)
        digest = self.state.copy().digest()
        return Fr.from_uniform_bytes(digest)


class Blake2bWrite(_TranscriptBase):
    def __init__(self):
        super().__init__()
        self.buf = bytearray()

    def write_point(self, pt):
        self.common_point(pt)
        self.buf += compress_g1(pt)

    def write_scalar(self, s):
        self.common_scalar(s)
        self.buf += int(s).to_bytes(32, "little")

    def finalize(self) -> bytes:
        return bytes(self.buf)


class Blake2bRead(_TranscriptBase):
    def __init__(self, proof: bytes):
        super().__init__()
        self.buf = proof
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("proof too short")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def read_point(self):
        pt = decompress_g1(self._take(32))
        self.common_point(pt)
        return pt

    def read_scalar(self) -> Fr:
        v = int.from_bytes(self._take(32), "little")
        if v >= Fr.SPEC.p:
            raise ValueError("scalar out of range")
        s = Fr(v)
        self.common_scalar(s)
        return s

    def assert_consumed(self):
        if self.pos != len(self.buf):
            raise ValueError("trailing proof bytes")
