"""Protocol structure, keys and commitments (port of halo2_tpu/kzg/keygen.py).

``AuxLayout``, ``PlonkStructure``, ``_aux``, ``_horner``, ``_delta`` and
``VerifyingKey`` are carried over unchanged from the reference (lines
39-300): that file imports JAX, so it cannot be loaded here, and the
reference-resolved verifier and SHPLONK code import these names from this
module.  ``ProvingKey`` loads the dict that the reference's
``ProvingKey.save`` writes, re-synthesizing the structure with this
package's classes.  Commitments use the native host MSM (the reference's
default branch) or the device Pippenger, chosen by the ``backend``
argument.

Keygen (``keygen_vk``/``keygen_pk``/``keygen``) takes ``device`` and
``commit``: the fixed and sigma columns' iNTTs run on ``device`` (the CUDA
device when None: the NTT kernels and the Montgomery kernel; ``"cpu"``:
their plain versions), the reference's device branch, or with
``device=NATIVE_NTT`` on the native host NTT, the reference's default
branch.  All give the same canonical Montgomery limbs, and the key, its
digest and its saved format are the reference's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle

import numpy as np
import torch

from .. import native
from .._device import resolve_device
from ..ec import host as ec
from ..field.device import get_device_field
from ..field.params import BN254_FR
from ..plonkish.assignment import run_synthesis
from ..plonkish.column import Column, ColumnKind, Rotation
from ..plonkish.expression import Constant, Expression, Query
from ..poly.domain import EvaluationDomain, get_domain

FR = BN254_FR
# keygen's ``device`` for the native host NTT (the reference's default branch)
NATIVE_NTT = "native"


# ------------------------------------------------------------------ structure
@dataclasses.dataclass
class AuxLayout:
    """Index map for ColumnKind.AUX columns used in quotient expressions."""

    IDENTITY = 0
    L0 = 1
    L_LAST = 2
    L_BLIND = 3
    BETA = 4
    GAMMA = 5
    THETA = 6
    Y = 7
    PERM_Z_BASE = 8

    def __init__(self, num_perm_chunks: int, num_lookups: int):
        self.num_perm_chunks = num_perm_chunks
        self.num_lookups = num_lookups
        self.lookup_base = self.PERM_Z_BASE + num_perm_chunks

    def perm_z(self, c: int) -> int:
        return self.PERM_Z_BASE + c

    def lookup_permuted_input(self, i: int) -> int:
        return self.lookup_base + 3 * i

    def lookup_permuted_table(self, i: int) -> int:
        return self.lookup_base + 3 * i + 1

    def lookup_z(self, i: int) -> int:
        return self.lookup_base + 3 * i + 2

    @property
    def num_aux(self) -> int:
        return self.lookup_base + 3 * self.num_lookups


def _aux(idx: int, rot: int = 0) -> Expression:
    return Query(Column(ColumnKind.AUX, idx), Rotation(rot))


def _horner(exprs, chal: Expression) -> Expression:
    acc = exprs[0]
    for e in exprs[1:]:
        acc = acc * chal + e
    return acc


class PlonkStructure:
    """Everything derivable from (cs, k) alone."""

    def __init__(self, cs, k: int):
        self.cs = cs
        self.k = k
        self.n = 1 << k
        self.bf = cs.blinding_factors()
        self.u = self.n - (self.bf + 1)  # l_last row; active rows are 0..u-1

        # ---- queries
        adv, fix, sel, inst = {}, {}, {}, {}

        def record(col, rot):
            if isinstance(col, Column):
                d = {
                    ColumnKind.ADVICE: adv,
                    ColumnKind.FIXED: fix,
                    ColumnKind.INSTANCE: inst,
                }[col.kind]
                d.setdefault((col.index, rot.value), None)
            else:  # Selector
                sel.setdefault((col.index, rot.value), None)

        for gate in cs.gates:
            for c in gate.constraints:
                for col, rot in c.queried_columns():
                    record(col, rot)
        for lk in cs.lookups:
            for i_e, t_e in lk.pairs:
                for col, rot in i_e.queried_columns():
                    record(col, rot)
                for col, rot in t_e.queried_columns():
                    record(col, rot)
        for col in cs.permutation_columns:
            record(col, Rotation.cur())

        self.advice_queries = sorted(adv)
        self.fixed_queries = sorted(fix)
        self.selector_queries = sorted(sel)
        self.instance_queries = sorted(inst)

        # ---- permutation chunking (halo2: chunk_len = degree - 2)
        self.degree = max(cs.degree(), 3)
        chunk = max(self.degree - 2, 1)
        cols = list(cs.permutation_columns)
        self.perm_chunks = [cols[i : i + chunk] for i in range(0, len(cols), chunk)]
        self.aux = AuxLayout(len(self.perm_chunks), len(cs.lookups))

        # ---- quotient expressions
        self.quotient_exprs = self._build_quotient_exprs()
        qdeg = max((e.degree() for e in self.quotient_exprs), default=1)
        self.domain: EvaluationDomain = get_domain(FR, k, qdeg)

    # ------------------------------------------------------- quotient exprs
    def _build_quotient_exprs(self):
        aux = self.aux
        exprs: list[Expression] = []
        beta, gamma, theta = _aux(aux.BETA), _aux(aux.GAMMA), _aux(aux.THETA)
        l0, l_last, l_blind = _aux(aux.L0), _aux(aux.L_LAST), _aux(aux.L_BLIND)
        identity = _aux(aux.IDENTITY)
        active = Constant(1) - (l_last + l_blind)
        one = Constant(1)

        # gates
        for gate in self.cs.gates:
            exprs.extend(gate.constraints)

        # permutation argument
        chunks = self.perm_chunks
        if chunks:
            delta = _delta()
            exprs.append(l0 * (one - _aux(aux.perm_z(0))))
            for c in range(1, len(chunks)):
                exprs.append(
                    l0 * (_aux(aux.perm_z(c)) - _aux(aux.perm_z(c - 1), rot=self.u))
                )
            z_last = _aux(aux.perm_z(len(chunks) - 1))
            exprs.append(l_last * (z_last * z_last - z_last))
            global_idx = 0
            for c, cols in enumerate(chunks):
                z = _aux(aux.perm_z(c))
                z_next = _aux(aux.perm_z(c), rot=1)
                left = z_next
                right = z
                for col in cols:
                    v = Query(col, Rotation.cur())
                    sigma = _aux(self._sigma_aux_index(global_idx))
                    left = left * (v + beta * sigma + gamma)
                    right = right * (
                        v + beta * Constant(pow(delta, global_idx, FR.p)) * identity + gamma
                    )
                    global_idx += 1
                exprs.append(active * (left - right))

        # lookup arguments
        for i, lk in enumerate(self.cs.lookups):
            a_comp = _horner([p[0] for p in lk.pairs], theta)
            s_comp = _horner([p[1] for p in lk.pairs], theta)
            ap = _aux(aux.lookup_permuted_input(i))
            ap_prev = _aux(aux.lookup_permuted_input(i), rot=-1)
            sp = _aux(aux.lookup_permuted_table(i))
            z = _aux(aux.lookup_z(i))
            z_next = _aux(aux.lookup_z(i), rot=1)
            exprs.append(l0 * (one - z))
            exprs.append(l_last * (z * z - z))
            exprs.append(
                active
                * (z_next * (ap + beta) * (sp + gamma) - z * (a_comp + beta) * (s_comp + gamma))
            )
            exprs.append(l0 * (ap - sp))
            exprs.append(active * (ap - sp) * (ap - ap_prev))
        return exprs

    def _sigma_aux_index(self, global_col_idx: int) -> int:
        # sigma polys live after the dynamic aux block
        return self.aux.num_aux + global_col_idx

    def combined_quotient(self) -> Expression:
        """All quotient expressions Horner-folded over the Y aux challenge —
        built once per structure (deep Expression hashing costs ~1 s per
        prove otherwise; profile round 4)."""
        cached = getattr(self, "_combined_quotient", None)
        if cached is None:
            cached = _horner(self.quotient_exprs, _aux(self.aux.Y))
            self._combined_quotient = cached
        return cached

    def quotient_program(self, rot_scale: int):
        """Compiled instruction Program for the combined quotient expression
        (shared by the native expr-VM and cached per structure)."""
        cache = getattr(self, "_quotient_programs", None)
        if cache is None:
            cache = {}
            self._quotient_programs = cache
        if rot_scale not in cache:
            from ..plonkish.evaluator import Program

            cache[rot_scale] = Program([self.combined_quotient()], rot_scale=rot_scale)
        return cache[rot_scale]

    @property
    def num_aux_total(self) -> int:
        return self.aux.num_aux + len(self.cs.permutation_columns)

    # ------------------------------------------------------------ permutation
    def build_sigma_values(self, copies) -> list[list[int]]:
        """Copy pairs -> sigma column values (delta^i omega^j labels)."""
        n, p = self.n, FR.p
        cols = self.cs.permutation_columns
        index = {(c.kind, c.index): i for i, c in enumerate(cols)}
        delta = _delta()
        omega = self.domain.omega

        # next-pointer cycles (same splice as the mock prover)
        mapping = {}
        aux_uf, sizes = {}, {}

        def find(x):
            root = x
            while aux_uf.get(root, root) != root:
                root = aux_uf[root]
            while aux_uf.get(x, x) != x:
                aux_uf[x], x = root, aux_uf[x]
            return root

        for a, b in copies:
            ka = (a[0], a[1])
            kb = (b[0], b[1])
            if ka not in index or kb not in index:
                raise ValueError(f"copy involves non-equality column: {a} {b}")
            ca, cb = (index[ka], a[2]), (index[kb], b[2])
            ra, rb = find(ca), find(cb)
            if ra == rb:
                continue
            if sizes.get(ra, 1) < sizes.get(rb, 1):
                ra, rb = rb, ra
            sizes[ra] = sizes.get(ra, 1) + sizes.get(rb, 1)
            aux_uf[rb] = ra
            mapping.setdefault(ca, ca)
            mapping.setdefault(cb, cb)
            mapping[ca], mapping[cb] = mapping[cb], mapping[ca]

        deltas = [pow(delta, i, p) for i in range(len(cols))]
        omegas = [1] * n
        for j in range(1, n):
            omegas[j] = omegas[j - 1] * omega % p

        sigmas = []
        for i in range(len(cols)):
            col_vals = [deltas[i] * omegas[j] % p for j in range(n)]
            sigmas.append(col_vals)
        for (ci, ri), (cj, rj) in mapping.items():
            sigmas[ci][ri] = deltas[cj] * omegas[rj] % p
        return sigmas


def _delta() -> int:
    """halo2curves DELTA: generator of the 2^S-cosets, g^(2^S)."""
    return pow(FR.generator, 1 << FR.two_adicity, FR.p)


# -------------------------------------------------------------------- keygen
@dataclasses.dataclass
class VerifyingKey:
    k: int
    structure: PlonkStructure
    fixed_commitments: list      # order: fixed columns, then selectors
    sigma_commitments: list
    digest: int                  # transcript seed

    @property
    def cs(self):
        return self.structure.cs



@dataclasses.dataclass
class ProvingKey:
    vk: VerifyingKey
    fixed_values: list  # host ints per fixed column (incl. selectors)
    sigma_values: list
    fixed_coeffs: np.ndarray  # (F, 16, n) uint32 Montgomery coefficients, host
    sigma_coeffs: np.ndarray

    def to_saved(self) -> dict:
        """The dict ``save`` pickles: the reference's ``ProvingKey.save`` format."""
        return {
            "k": self.vk.k,
            "digest": self.vk.digest,
            "fixed_commitments": [ec.g1_to_ints(p) for p in self.vk.fixed_commitments],
            "sigma_commitments": [ec.g1_to_ints(p) for p in self.vk.sigma_commitments],
            "fixed_values": self.fixed_values,
            "sigma_values": self.sigma_values,
            "fixed_coeffs": np.asarray(self.fixed_coeffs),
            "sigma_coeffs": np.asarray(self.sigma_coeffs),
        }

    def save(self, path: str):
        with open(path, "wb") as f:
            pickle.dump(self.to_saved(), f)

    @classmethod
    def from_saved(cls, data: dict, circuit, k: int, F) -> "ProvingKey":
        """A pk from the dict the reference's ``ProvingKey.save`` writes;
        the structure is re-synthesized from ``circuit`` (built from this
        package's classes), as the reference's ``ProvingKey.load`` does."""
        if data["k"] != k:
            raise ValueError(f"pk cache k={data['k']} != requested k={k}")
        circuit_no_wit = circuit.without_witnesses()
        cs, _cfg, _asn = run_synthesis(circuit_no_wit, k, [], witness=False, field=F)
        structure = PlonkStructure(cs, k)
        vk = VerifyingKey(
            k,
            structure,
            [ec.g1_from_ints(x, y) for x, y in data["fixed_commitments"]],
            [ec.g1_from_ints(x, y) for x, y in data["sigma_commitments"]],
            data["digest"],
        )
        return cls(
            vk,
            data["fixed_values"],
            data["sigma_values"],
            np.asarray(data["fixed_coeffs"], np.uint32),
            np.asarray(data["sigma_coeffs"], np.uint32),
        )

    @classmethod
    def load(cls, path: str, circuit, k: int, F) -> "ProvingKey":
        # pickles are only read from the repo's own caches (written by
        # ``save`` here or in the reference)
        with open(path, "rb") as f:
            data = pickle.load(f)
        return cls.from_saved(data, circuit, k, F)


def commit_coeffs(params, coeffs) -> object:
    """coeffs: one (16, m) Montgomery array -> host G1 point."""
    return commit_coeffs_batch(params, [coeffs])[0]


def commit_coeffs_batch(params, coeffs_list, backend: str = "native") -> list:
    """Commit many (16, m) Montgomery coefficient arrays over the shared SRS.

    ``backend="native"`` (the reference's default): numpy uint32 or int32
    tensors on any device, fetched in one copy, go to the native C++
    Pippenger.  ``backend="device"`` (the reference's
    ``HALO2_TPU_COMMIT_BACKEND=device``): int32 tensors on one device go to
    the device Pippenger there (:func:`_commit_device`: the columns of each
    length as one batch), over the SRS uploaded once per (params, device).

    Without the native engine, ``"native"`` takes the reference's fallbacks,
    on the inputs' own device: host arrays (numpy, CPU tensors) go to the
    Python-int ``ec.msm_host`` over ``params.g1_host()``, CUDA tensors to the
    device Pippenger."""
    if backend == "device":
        return _commit_device(params, coeffs_list)
    if backend != "native":
        raise ValueError(f"commit backend must be 'native' or 'device', got {backend!r}")
    if not native.available():
        return _commit_without_native(params, coeffs_list)
    m = coeffs_list[0].shape[-1]
    cached = getattr(params, "_native_srs", None)
    if cached is None:
        cached = (native.pack_device(params.g1_x), native.pack_device(params.g1_y))
        params._native_srs = cached
    px, py = cached[0][:m], cached[1][:m]
    stacked = to_host_limbs(coeffs_list)
    packed = native.pack_device(np.moveaxis(stacked, 1, 0).reshape(16, -1))
    canon = native.from_mont(packed, "fr").reshape(len(coeffs_list), m, 4)
    return [ec.g1_from_ints(x, y) for x, y in native.msm_g1_mont_batch(px, py, canon)]


def _commit_without_native(params, coeffs_list) -> list:
    """The reference's no-native branches of ``commit_coeffs_batch``: the host
    MSM for host arrays, the device MSM for CUDA tensors; raises otherwise."""
    kinds = {c.device.type if isinstance(c, torch.Tensor) else "cpu" for c in coeffs_list}
    if kinds == {"cuda"}:
        return _commit_device(params, coeffs_list)
    if kinds != {"cpu"}:
        raise RuntimeError(
            f"commitments without the native host engine take host arrays or CUDA tensors, got {sorted(kinds)}"
        )
    dfr = get_device_field(FR)
    pts = params.g1_host()[: coeffs_list[0].shape[-1]]
    out = []
    for coeffs in coeffs_list:
        if isinstance(coeffs, np.ndarray):
            coeffs = torch.from_numpy(np.ascontiguousarray(coeffs, np.uint32).view(np.int32))
        out.append(ec.msm_host(pts, [int(v) for v in dfr.decode(coeffs)]))
    return out


def _device_srs(params, device: torch.device):
    """``params.g1_x``/``g1_y`` as int32 tensors on ``device``, uploaded once
    per (params, device) and cached on the params."""
    cache = getattr(params, "_device_srs", None)
    if cache is None:
        cache = {}
        params._device_srs = cache
    if device not in cache:
        cache[device] = tuple(
            torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32)).to(device)
            for a in (params.g1_x, params.g1_y)
        )
    return cache[device]


def _commit_by_length(params, device, coeffs_list, msm) -> list:
    """Commit Montgomery Fr columns on ``device`` through a batched device
    MSM: the columns of each length as one batch of scalar sets over the
    SRS uploaded once per (params, device), ``msm(g1_x, g1_y, canon)`` with
    ``canon`` ``(B, 16, m)`` returning a jac point ``(16, B)``, the batch's
    points decoded to affine in one device -> host copy, in the callers'
    order."""
    from ..ec.device import _wsums_host_affine
    from ..field.device import get_device_field

    dfr = get_device_field(FR)
    g1_x, g1_y = _device_srs(params, device)
    out = [None] * len(coeffs_list)
    for m in dict.fromkeys(c.shape[-1] for c in coeffs_list):
        idx = [i for i, c in enumerate(coeffs_list) if c.shape[-1] == m]
        batch = torch.stack([coeffs_list[i] for i in idx], dim=1)  # (16, B, m)
        canon = dfr.from_mont_arr(batch).movedim(1, 0)  # (B, 16, m)
        pt = msm(g1_x[:, :m], g1_y[:, :m], canon)
        xs, ys = _wsums_host_affine(torch.stack([pt["x"], pt["y"], pt["z"]]))
        for i, x, y in zip(idx, xs, ys):
            out[i] = ec.g1_from_ints(x, y)
    return out


def _commit_device(params, coeffs_list) -> list:
    """The device Pippenger over the SRS for each length's columns at once:
    one :func:`..ec.device._msm_raw` a length (one window-sum pass, one
    device Horner at the batch's width)."""
    from ..ec.device import _msm_raw

    if not all(isinstance(c, torch.Tensor) for c in coeffs_list):
        raise TypeError("the device commit backend takes int32 tensors")
    if not coeffs_list:
        return []
    return _commit_by_length(params, coeffs_list[0].device, coeffs_list, _msm_raw)


def to_host_limbs(arrays) -> np.ndarray:
    """Stack (16, m) limb arrays (numpy or int32 tensors, in one device ->
    host copy) into a (B, 16, m) uint32 numpy array.  Raises if a limb is
    not below 2^16: ``native.pack_device`` would silently truncate it."""
    if all(isinstance(a, np.ndarray) for a in arrays):
        out = np.stack(arrays).astype(np.uint32, copy=False)
    else:
        out = torch.stack(list(arrays)).cpu().numpy().view(np.uint32)
    if (out >> 16).any():
        raise ValueError("field array holds a limb >= 2^16")
    return out


def commit_lagrange(params, domain: EvaluationDomain, values_host: list, device=None, commit="native"):
    """Commit a column given in Lagrange form: iNTT on ``device`` (the CUDA
    device when None), then the MSM on ``commit``'s backend."""
    evals = get_device_field(FR).encode(values_host, device=resolve_device(device))
    return commit_coeffs_batch(params, [domain.lagrange_to_coeff(evals)], backend=commit)[0]


def _keygen_device(device):
    """Keygen's ``device``: NATIVE_NTT as given, else a torch device (the
    CUDA device when None)."""
    return NATIVE_NTT if device == NATIVE_NTT else resolve_device(device)


def _intt_columns(domain, values_lists, device=None):
    """Column value lists -> stacked (F, 16, n) Montgomery coefficient limbs.

    With ``device=NATIVE_NTT``, the native C++ NTT (host numpy uint32, the
    reference's default branch); with a torch device, an int32 tensor on
    that device: the columns are uploaded in one copy and go through one
    batched ``domain.lagrange_to_coeff``."""
    device = _keygen_device(device)
    n = domain.n
    if device == NATIVE_NTT:
        if not native.available():
            raise RuntimeError("device='native' needs the native host engine (no C++ compiler)")
        if not values_lists:
            return np.zeros((0, 16, n), np.uint32)
        cols = []
        for vals in values_lists:
            c = native.ntt_fr(native.pack_ints([int(v) % FR.p for v in vals]), inverse=True)
            cols.append(native.unpack_device(native.to_mont(c, "fr")))
        return np.stack(cols)
    if not values_lists:
        return torch.zeros((0, 16, n), dtype=torch.int32, device=device)
    flat = get_device_field(FR).encode([v for vals in values_lists for v in vals], device=device)
    evals = flat.reshape(16, len(values_lists), n).transpose(0, 1).contiguous()  # (F, 16, n)
    return domain.lagrange_to_coeff(evals)


def _synthesize_columns(circuit, k: int, F, device):
    """Witness-free synthesis -> (structure, fixed/sigma value lists, coeffs).

    The shared body of keygen_vk / keygen_pk (halo2 runs this synthesis once
    per entry point too)."""
    circuit_no_wit = circuit.without_witnesses()
    cs, _config, assignment = run_synthesis(circuit_no_wit, k, [], witness=False, field=F)
    fin = assignment.finalize()
    structure = PlonkStructure(cs, k)

    fixed_values = [list(col) for col in fin.fixed] + [list(s) for s in fin.selectors]
    sigma_values = structure.build_sigma_values(fin.copies)

    fixed_coeffs = _intt_columns(structure.domain, fixed_values, device)
    sigma_coeffs = _intt_columns(structure.domain, sigma_values, device)
    return structure, fixed_values, sigma_values, fixed_coeffs, sigma_coeffs


def _check_commit(device, commit: str) -> None:
    if commit not in ("native", "device"):
        raise ValueError(f"commit must be 'native' or 'device', got {commit!r}")
    if commit == "device" and device == NATIVE_NTT:
        raise ValueError("commit='device' needs a torch device for the coefficients")


def _vk_from_coeffs(params, k, structure, nfixed, fixed_coeffs, sigma_coeffs, commit="native"):
    all_coeffs = [fixed_coeffs[i] for i in range(nfixed)] + [
        sigma_coeffs[i] for i in range(sigma_coeffs.shape[0])
    ]
    all_commitments = commit_coeffs_batch(params, all_coeffs, backend=commit) if all_coeffs else []
    fixed_commitments = all_commitments[:nfixed]
    sigma_commitments = all_commitments[nfixed:]

    h = hashlib.blake2b(digest_size=32)
    h.update(f"halo2_tpu-vk-k{k}".encode())
    for pt in fixed_commitments + sigma_commitments:
        x, y = ec.g1_to_ints(pt)
        h.update(x.to_bytes(32, "little") + y.to_bytes(32, "little"))
    digest = int.from_bytes(h.digest(), "little") % FR.p
    return VerifyingKey(k, structure, fixed_commitments, sigma_commitments, digest)


def _proving_key(vk, fixed_values, sigma_values, fixed_coeffs, sigma_coeffs, device) -> ProvingKey:
    """A pk with host uint32 coefficients.  Tensors computed on ``device``
    are copied to the host once each and also seed the pk's per-device cache
    (``TorchEngine.pk_coeff``), so a prove there does not upload them again."""
    if isinstance(fixed_coeffs, np.ndarray):
        return ProvingKey(vk, fixed_values, sigma_values, fixed_coeffs, sigma_coeffs)
    host = [t.cpu().numpy().view(np.uint32) for t in (fixed_coeffs, sigma_coeffs)]
    pk = ProvingKey(vk, fixed_values, sigma_values, *host)
    pk._torch_coeffs = {("fixed", device): fixed_coeffs, ("sigma", device): sigma_coeffs}
    return pk


def keygen_vk(params, circuit, k: int, F, device=None, commit="native") -> VerifyingKey:
    """Verifying key alone: synthesis, fixed/sigma iNTTs, commitments, digest
    (halo2 `keygen_vk`)."""
    device = _keygen_device(device)
    _check_commit(device, commit)
    structure, fixed_values, _sv, fixed_coeffs, sigma_coeffs = _synthesize_columns(
        circuit, k, F, device
    )
    return _vk_from_coeffs(
        params, k, structure, len(fixed_values), fixed_coeffs, sigma_coeffs, commit
    )


def keygen_pk(params, vk: VerifyingKey, circuit, k: int, F, device=None) -> ProvingKey:
    """Proving key from an existing vk: re-synthesizes and rebuilds the
    fixed/sigma polynomials (halo2 `keygen_pk` re-runs synthesis the same
    way).  It commits nothing."""
    device = _keygen_device(device)
    _st, fixed_values, sigma_values, fixed_coeffs, sigma_coeffs = _synthesize_columns(
        circuit, k, F, device
    )
    return _proving_key(vk, fixed_values, sigma_values, fixed_coeffs, sigma_coeffs, device)


def keygen(params, circuit, k: int, F, device=None, commit="native") -> ProvingKey:
    """vk + pk in one pass (synthesis and iNTTs shared; the split entry
    points above are halo2's API, which full_prover times)."""
    device = _keygen_device(device)
    _check_commit(device, commit)
    structure, fixed_values, sigma_values, fixed_coeffs, sigma_coeffs = _synthesize_columns(
        circuit, k, F, device
    )
    vk = _vk_from_coeffs(
        params, k, structure, len(fixed_values), fixed_coeffs, sigma_coeffs, commit
    )
    return _proving_key(vk, fixed_values, sigma_values, fixed_coeffs, sigma_coeffs, device)


def keygen_cached(params, circuit, k: int, F, cache_path: str, device=None, commit="native") -> ProvingKey:
    """keygen with a pk/vk disk cache in the reference's saved format."""
    if os.path.exists(cache_path):
        return ProvingKey.load(cache_path, circuit, k, F)
    pk = keygen(params, circuit, k, F, device, commit)
    os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
    pk.save(cache_path)
    return pk
