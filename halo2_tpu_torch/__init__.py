"""halo2_tpu_torch — the halo2_tpu prover ported to PyTorch and CUDA (Hopper).

The reference package ``halo2_tpu`` stays the source of truth for every module
that holds no JAX code: the PLONKish frontend, the chips and circuits, the
host field/curve arithmetic, the transcript, the SHPLONK host code, the
verifier and the native C++ host engine.  Those are not copied.  This
package's ``__path__`` ends with the ``halo2_tpu/`` directory, so
``halo2_tpu_torch.chips.merkle_sum_tree`` loads ``halo2_tpu/chips/
merkle_sum_tree.py`` under this package's name, and its relative imports
(``..plonkish``, ``..poseidon.primitives``) land on this package's modules.

Why not ``import halo2_tpu``: ``halo2_tpu/__init__.py`` imports JAX at module
level (to configure XLA's compile cache), and the machine with the card has
no JAX.  Importing any ``halo2_tpu.<x>`` module would run that ``__init__``.
Loading the reference files under this package's name never does.

Subpackages whose reference modules import JAX (``field``, ``poly``,
``plonkish``, ``poseidon``, ``kzg``, ``ec``) have their own directory here:
its ``__init__`` appends the matching reference directory to its own
``__path__``, re-exports what the reference ``__init__`` exports minus the
JAX code, and the JAX-bearing modules themselves are rewritten on torch
tensors.  The reference's six Pallas kernels are CUDA C++ under ``csrc/``,
built at first use by :mod:`halo2_tpu_torch._build`.
"""

from ._refpath import REF_ROOT as _REF_ROOT

__version__ = "0.1.0"

__path__.append(_REF_ROOT)
