"""The SRS setup's G tau^i as one ``jac_fixed_base`` launch (a shared
point's window table, one mixed add a window a lane), checked on the CPU,
where the wrapper runs its plain version:

- the window table (``ec/cuda_jac.py:fixed_base_table``) against the
  reference's host ``ec_mul`` (``halo2_tpu/ec/host.py``), every entry;
- ``fixed_base_mul_plain`` then ``jac_to_affine`` against the reference's
  ``ec_mul(G, s)`` on 64 lanes: 0, 1, R - 1, R (the top window's digit 3
  meets -3 2^252 G: P == -Q, the sum infinity), 2^255 - R (digit 4 meets 4
  2^252 G: P == Q, a doubling) and 2^256 - 1 among numpy-seeded scalars;
- the digits and the scalar words (``kzg.params.scalar_words``) rebuild
  the scalars at w = 4, 5 and 6;
- ``device_g1_powers`` at n = 32 against the host branch of
  ``ParamsKZG.setup``;
- the dispatch: a CPU tensor runs the plain version and counts no launch;
  another device, a bad dtype or a bad shape raises.

The kernel is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py phases 2 and 5).
"""

import numpy as np
import pytest
import torch

from halo2_tpu.ec import host as ref_host
from halo2_tpu_torch.ec import cuda_jac, host
from halo2_tpu_torch.ec import device as ecd
from halo2_tpu_torch.field.device import get_device_field
from halo2_tpu_torch.field.params import BN254_FQ
from halo2_tpu_torch.kzg.params import device_g1_powers, scalar_words
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

W = cuda_jac.FIXED_BASE_WINDOW
R = host.R
SPECIAL = [0, 1, R - 1, R, (1 << 255) - R, (1 << 256) - 1]


def _scalars(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") for _ in range(n)]
    vals[: len(SPECIAL)] = SPECIAL
    return vals


def _words(vals) -> torch.Tensor:
    return torch.from_numpy(scalar_words(vals).view(np.int32))


def _g_table() -> torch.Tensor:
    return cuda_jac.fixed_base_table_tensor(*host.g1_to_ints(host.G1), W, torch.device("cpu"))


def _entry_ints(row) -> tuple:
    q = BN254_FQ
    x = sum(int(v) << (32 * k) for k, v in enumerate(row[:8])) * q.r_inv % q.p
    y = sum(int(v) << (32 * k) for k, v in enumerate(row[8:])) * q.r_inv % q.p
    return x, y


@pytest.mark.parametrize("part", range(4))
def test_table_entries_equal_reference_ec_mul(part):
    table = cuda_jac.fixed_base_table(*host.g1_to_ints(host.G1), W)
    per, windows = (1 << W) - 1, cuda_jac.fixed_base_windows(W)
    assert table.dtype == np.uint32 and table.flags.c_contiguous
    assert table.shape == (windows * per, cuda_jac.ENTRY_WORDS)
    for j in range(part * windows // 4, (part + 1) * windows // 4):
        for d in range(1, per + 1):
            want = ref_host.ec_mul(ref_host.G1, d << (W * j))
            assert _entry_ints(table[j * per + d - 1]) == (want[0].c[0], want[1].c[0]), (j, d)


def _affine_ints(acc) -> list:
    d = get_device_field(BN254_FQ)
    ax, ay = ecd.jac_to_affine(acc)
    return [(int(x), int(y)) for x, y in zip(d.decode(ax), d.decode(ay))]


def test_fixed_base_plain_equals_reference_ec_mul():
    vals = _scalars(64, seed=64)
    calls = []
    fixup = cuda_jac._double_fixup

    def counted(out, same, p_, d_):
        calls.append(same.nonzero().flatten().tolist())
        return fixup(out, same, p_, d_)

    try:
        cuda_jac._double_fixup = counted
        acc = cuda_jac.fixed_base_mul_plain(_g_table(), _words(vals))
    finally:
        cuda_jac._double_fixup = fixup
    for i, (got, s) in enumerate(zip(_affine_ints(acc), vals)):
        want = ref_host.ec_mul(ref_host.G1, s)
        assert got == ((0, 0) if want is None else (want[0].c[0], want[1].c[0])), i
    # 2^255 - R (lane 4) doubles in the top window, and no other lane ever does;
    # R (lane 3) ends at z = 0 there
    assert calls[-1] == [4] and all(c == [] for c in calls[:-1])
    assert int(acc["z"][:, 3].abs().sum()) == 0 and int(acc["z"][:, 2].abs().sum()) != 0


@pytest.mark.parametrize("window", [4, 5, 6])
def test_digits_and_words_rebuild_the_scalars(window):
    vals = _scalars(16, seed=window)
    words = _words(vals)
    assert words.shape == (8, 16) and words.dtype == torch.int32
    digits = cuda_jac.fixed_base_digits(words, window)
    assert digits.shape == (cuda_jac.fixed_base_windows(window), 16)
    assert int(digits.max()) < 1 << window and int(digits.min()) >= 0
    for i, s in enumerate(vals):
        assert sum(int(digits[j, i]) << (window * j) for j in range(digits.shape[0])) == s


def test_device_g1_powers_fixed_base_matches_host_branch():
    n = 32
    rng = np.random.default_rng(320)
    tau = int.from_bytes(rng.bytes(32), "little") % R
    powers = [pow(tau, i, R) for i in range(n)]
    d = get_device_field(BN254_FQ)
    pts = [ref_host.ec_mul(ref_host.G1, v) for v in powers]
    g1_x, g1_y = device_g1_powers(powers, torch.device("cpu"))
    assert np.array_equal(g1_x, d.encode_np([p[0].c[0] for p in pts]))
    assert np.array_equal(g1_y, d.encode_np([p[1].c[0] for p in pts]))


def test_jac_fixed_base_dispatch_and_checks():
    table, words = _g_table(), _words(_scalars(8, seed=8))
    before = dict(cuda_jac.LAUNCHES)
    got = cuda_jac.jac_fixed_base_cuda(table, words)
    via = ecd.fixed_base_mul(host.g1_to_ints(host.G1), words)
    want = cuda_jac.fixed_base_mul_plain(table, words)
    assert all(torch.equal(got[k], want[k]) and torch.equal(via[k], want[k]) for k in want)
    assert cuda_jac.LAUNCHES == before, "a CPU tensor launched a kernel"
    with pytest.raises(ValueError, match="scalars"):
        cuda_jac.jac_fixed_base_cuda(table, words.to(torch.int64))
    with pytest.raises(ValueError, match="scalars"):
        cuda_jac.jac_fixed_base_cuda(table, words[:7].contiguous())
    with pytest.raises(ValueError, match="table"):
        cuda_jac.jac_fixed_base_cuda(table[:-1].contiguous(), words)
    with pytest.raises(ValueError, match="table"):
        cuda_jac.jac_fixed_base_cuda(table.t(), words)
    meta_t = torch.empty(table.shape, dtype=torch.int32, device="meta")
    meta_w = torch.empty(words.shape, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_jac.jac_fixed_base_cuda(meta_t, meta_w)
    with pytest.raises(ValueError, match="scalars"):
        cuda_jac.jac_fixed_base_cuda(meta_t, words)
    assert cuda_jac.LAUNCHES == before
