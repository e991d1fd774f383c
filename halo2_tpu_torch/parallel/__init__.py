"""The sharded prover's layer (port of halo2_tpu/parallel): a ``(dp, sp)``
device mesh over ``torch.distributed``, the MSM, NTT and grand-product scan
split across its ranks, and the sharded prove-step demo.

SPMD: one process a rank (:func:`.launch.spawn`, or ``torchrun``), each
calling the same functions on replicated inputs, computing its share on its
own device, exchanging through :mod:`.comm`, and returning the whole result.
``create_proof(..., mesh=)`` (:class:`..kzg.engine.ShardedEngine`) proves
on it.
"""

from .mesh import make_mesh
from .msm import sharded_msm
from .ntt import sharded_ntt
from .pipeline import build_sharded_prove_step
from .scan import grand_product_z, sharded_prefix_product

__all__ = [
    "make_mesh",
    "sharded_msm",
    "sharded_ntt",
    "build_sharded_prove_step",
    "grand_product_z",
    "sharded_prefix_product",
]
