"""halo2_tpu_torch — the halo2_tpu prover ported to PyTorch and CUDA (Hopper).

The package stands alone: it imports neither JAX nor anything of the
reference package ``halo2_tpu``.  The reference's modules that hold no JAX
code (the PLONKish frontend, the chips and circuits, the host field/curve
arithmetic, the transcript, the SHPLONK host code, the verifier, the failure
classes and the native C++ host engine) are verbatim copies here at the same
relative paths, so their relative imports land on this package's modules.
The modules that hold JAX code in the reference are rewritten on torch
tensors, and its six Pallas kernels are CUDA C++ under ``csrc/``, built at
first use by :mod:`halo2_tpu_torch._build`.

The entry points (``kzg.create_proof``, ``kzg.keygen*``, ``ParamsKZG.setup``,
``dev.MockProver``, ``circuits.utils.full_prover``) run on the CUDA device
unless the caller passes ``device="cpu"``; without a card they raise.
"""

__version__ = "0.1.0"
