"""Circuit protocol (halo2 `plonk::Circuit`).

A circuit implements:
  * ``configure(meta: ConstraintSystem) -> Config``   (classmethod)
  * ``synthesize(self, config, layouter)``
  * ``without_witnesses(self) -> Circuit``
Floor planning follows SimpleFloorPlanner semantics (see assignment.py).
"""

from __future__ import annotations


class Circuit:
    def without_witnesses(self):
        return type(self)()

    @classmethod
    def configure(cls, meta):
        raise NotImplementedError

    def synthesize(self, config, layouter):
        raise NotImplementedError
