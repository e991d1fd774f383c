"""The ``poseidon_hash`` kernel's launch: the batched Poseidon sponge, or
one permutation, in one launch (``csrc/poseidon.cu``), and its constant
table.

The kernel replaces the reference's three ``lax.scan``s over the rounds
(``halo2_tpu/poseidon/primitives.py:163-224``); ``poseidon/primitives.py``
holds the wrappers (``permute_device``, ``hash_device``), which launch it
for CUDA tensors and run the plain versions for CPU ones.  ``LAUNCHES``
counts its launches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..field.cuda_mul import ARITH, arith, modulus_words
from ..field.device import get_device_field
from ..field.params import NUM_LIMBS, FieldSpec

L = NUM_LIMBS
LAUNCHES = {"poseidon_hash": 0}
# the state widths the kernel is instantiated for: P128Pow5T3 (3) and
# MySpec(5, 4) / MySpec(5, 3) (5)
WIDTHS = (3, 5)


def _pack(limbs: np.ndarray) -> np.ndarray:
    """(n, 16) 16-bit limbs -> (n, 8) uint32, the kernel's register layout:
    word k is limb 2k | limb 2k + 1 << 16."""
    u = limbs.astype(np.uint32)
    return u[:, 0::2] | u[:, 1::2] << 16


def constants_words(field_spec: FieldSpec, width: int, r_f_total: int, r_p: int, secure_mds: int) -> np.ndarray:
    """The kernel's constant table, ``(R W + W W, 8)`` uint32: round r's
    constant for word i at row r W + i (R = r_f_total + r_p rounds), then
    the MDS matrix's entry (i, j) at row R W + i W + j, each in Montgomery
    form as eight little-endian words: the plain versions' tables
    (``primitives._device_constants``), their limbs packed in pairs."""
    from .primitives import _device_constants

    rcs, mds = _device_constants(field_spec, width, r_f_total, r_p, secure_mds, torch.device("cpu"))
    return _pack(torch.cat([rcs.reshape(-1, L), mds.reshape(-1, L)]).numpy())


@functools.lru_cache(maxsize=None)
def _table(field_spec: FieldSpec, width: int, r_f_total: int, r_p: int, secure_mds: int, device) -> torch.Tensor:
    """:func:`constants_words` on ``device`` as int32, made once per field,
    spec and device."""
    words = constants_words(field_spec, width, r_f_total, r_p, secure_mds)
    return torch.from_numpy(words.view(np.int32)).to(device)


@functools.lru_cache(maxsize=None)
def _capacity_words(field_spec: FieldSpec, n_msg: int) -> np.ndarray:
    """ConstantLength<n_msg>'s capacity word n_msg 2^64 in Montgomery form,
    eight words."""
    return _pack(get_device_field(field_spec).encode_np([n_msg << 64]).T)[0]


def launch(field_spec: FieldSpec, spec, inp: torch.Tensor, n_msg: int, hash_mode: bool) -> torch.Tensor:
    """One ``poseidon_hash`` launch on ``inp``'s CUDA device: with
    ``hash_mode`` the ConstantLength<n_msg> digests ``(16, B)`` of messages
    ``(n_msg, 16, B)``, else one permutation of states ``(W, 16, B)``.
    ``inp`` is contiguous int32 Montgomery limbs; the caller has checked
    the shapes."""
    from .. import _build

    width = spec.width
    if width not in WIDTHS:
        raise ValueError(f"poseidon_hash: the kernel takes widths {WIDTHS}, got {width}")
    B = inp.shape[-1]
    out = torch.empty((L, B) if hash_mode else (width, L, B), dtype=torch.int32, device=inp.device)
    if B == 0:
        return out
    table = _table(field_spec, width, spec.full_rounds(), spec.partial_rounds(), spec.secure_mds(), inp.device)
    cap = _capacity_words(field_spec, n_msg if hash_mode else 0)
    _build.launch(
        "poseidon_hash", inp.device, inp.data_ptr(), out.data_ptr(), B, n_msg if hash_mode else width,
        int(hash_mode), width, table.data_ptr(), spec.full_rounds() // 2, spec.partial_rounds(),
        modulus_words(field_spec).ctypes.data, cap.ctypes.data, ARITH[arith(field_spec)],
    )
    LAUNCHES["poseidon_hash"] += 1
    return out
