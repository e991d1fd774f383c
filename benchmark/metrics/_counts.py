"""The yardstick of the roofline metrics, frozen here so that a change to
the program cannot move it: the card's peaks (``peaks.json``), the cost of
one field product, and the field products each kernel's work needs.

A product is one 254-bit Montgomery product at ``IMAD_PER_PRODUCT`` issue
slots of the 32-bit integer multiply-add pipe: the least of the
schoolbook (CIOS) forms over any limb width that pipe takes.  With eight
32-bit limbs a*b is 64 32x32 -> 64-bit products, two slots each (low and
high halves); the reduction takes one slot for each of the eight
quotient words and 64 more wide products, less the eight low halves of
q_i p_0, which are known to cancel: 128 + 8 + 128 - 8 = 256.  (16-bit
limbs need 256 one-slot products for a*b alone.)  A square is counted as
a product.  A field element moves 32 bytes; each input byte is read once
and each output byte written once.  The bound of a launch is the larger of
its slots at the integer peak and its bytes at the memory peak.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())
IMAD_PER_S = PEAKS["sms"] * PEAKS["imad_per_sm_per_clock"] * PEAKS["boost_clock_hz"]
BYTES_PER_S = PEAKS["memory_bytes_per_s"]
IMAD_PER_PRODUCT = 256
ELEMENT_BYTES = 32

# each of the port's kernels as its symbols name it in a trace
KERNEL_SYMBOLS = {
    "mont_mul": "mont_mul_kernel",
    "mont_sqr": "mont_sqr_kernel",
    "mont_pow": "mont_pow_kernel",
    "mont_inv": "mont_inv_kernel",
    "mod_add": "mod_add_kernel",
    "mod_sub": "mod_sub_kernel",
    "ntt_small_stages": "ntt_small_stages_kernel",
    "ntt_large_stage": "ntt_large_stage_kernel",
    "jac_add": "jac_add_",
    "jac_madd": "jac_madd_",
    "jac_horner": "jac_horner_kernel",
    "jac_ladder": "jac_ladder_kernel",
    "jac_fixed_base": "jac_fixed_base_kernel",
    "msm_chunk_acc": "msm_chunk_acc_",
    "jac_suffix_scan": "jac_suffix_scan_",
    "poseidon_hash": "poseidon_kernel",
    "vm_eval": "vm_eval_kernel",
}


def bound_s(products: float, nbytes: float) -> float:
    return max(products * IMAD_PER_PRODUCT / IMAD_PER_S, nbytes / BYTES_PER_S)


def kernel_seconds(trace: dict, *kernels: str) -> float:
    """Summed device time of the launches of the named port kernels."""
    syms = [KERNEL_SYMBOLS[k] for k in kernels]
    return sum(e - s for name, s, e in trace["kernels"] if any(y in name for y in syms)) / 1e9


def poseidon_products(width: int, full_rounds: int, partial_rounds: int) -> int:
    """Products of one permutation in the sparse form: an x^5 S-box (two
    squares and a product) on every word of a full round and on word 0 of
    a partial one; a full round's dense W x W MDS product; the partial
    rounds' one dense W x W matrix, then a first row and a first column (2 W
    - 1 products) a round."""
    w, rf, rp = width, full_rounds, partial_rounds
    return 3 * (w * rf + rp) + rf * w * w + w * w + rp * (2 * w - 1)


def poseidon_hash_bound_s(lanes: int, words: int, width: int, rate: int, full_rounds: int, partial_rounds: int) -> float:
    perms = -(-words // rate)
    return bound_s(lanes * perms * poseidon_products(width, full_rounds, partial_rounds), lanes * (words + 1) * ELEMENT_BYTES)


def ntt_stage_products(n: int) -> int:
    """Radix-2 butterflies, one twiddle product each: n / 2 a stage,
    log2 n stages."""
    return n // 2 * (n.bit_length() - 1)


def ntt_stages_bound_s(columns: int, n: int) -> float:
    return bound_s(columns * ntt_stage_products(n), 2 * columns * n * ELEMENT_BYTES)

