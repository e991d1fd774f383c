"""Write the reference's results on the experiment circuits to
tests/data/experiments/.

    python scripts/experiment_fixtures.py

From the JAX package on the CPU: each MockProver vector's failures (their
``repr``s, in order) and each circuit's proof (its bytes, the verifier's
verdict, the verdict on a tampered instance where the proof verifies, or the
type of the exception keygen raises).  The vectors are
tests/experiment_vectors.py's.  tests/test_torch_experiments.py and
tests/test_torch_experiment_proofs*.py rebuild every result from the
reference and hold it against these files; chip_smoke.py holds the port's
runs on the card against them.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import experiment_vectors as ev  # noqa: E402


def main() -> None:
    ref = ev.side("halo2_tpu")
    ev.save_results({
        "mock": {v.label: ev.failures(ref, v) for v in ev.mock_vectors(ref)},
        "proofs": {name: ev.prove(ref, ev.proof_vector(ref, name)) for name in ev.CIRCUITS},
    })
    print(f"wrote {os.path.relpath(ev.DATA, ROOT)}")


if __name__ == "__main__":
    main()
