"""The reference directory that the port's packages extend (see the package
docstring of :mod:`halo2_tpu_torch`)."""

import os

REF_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "halo2_tpu"
)


def reference_dir(subpackage: str) -> str:
    """``halo2_tpu/<subpackage>``, for a port subpackage's ``__path__``."""
    return os.path.join(REF_ROOT, subpackage)
