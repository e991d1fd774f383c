"""Summary of scripts/torch_compare.sh's prove pairs: for each metric of
chip_smoke.time_proves (native- and device-commit prove walls and their
grand_products phase), the median of each process's runs, then for each
side the median and quartiles over its processes, the pairs the change
won, and a verdict against a bound of BOUND of the parent's median:
"unresolved" where the parent's quartile spread is wider than the bound,
unless every change process reads below every parent process; else "no
regression" or "regression" by the change's median.

    python3 scripts/prove_pairs.py <log dir>    # proves_<pair>_<side>.log
"""

from __future__ import annotations

import json
import re
import statistics
import sys
from pathlib import Path

# the most a change's median may exceed the parent's before it counts as
# slower, as a share of the parent's median
BOUND = 0.03


def _runs(log_dir: Path) -> dict:
    """{pair: {side: {metric: median of the process's runs}}}."""
    pairs = {}
    for log in sorted(log_dir.glob("proves_*_*.log")):
        pair, side = re.fullmatch(r"proves_(\d+)_(\w+)\.log", log.name).groups()
        lines = [ln for ln in log.read_text().splitlines() if ln.startswith("[proves] ")]
        if not lines:
            print(f"{log.name}: no [proves] line")
            continue
        times = json.loads(lines[-1][len("[proves] "):])
        pairs.setdefault(int(pair), {})[side] = {k: statistics.median(v) for k, v in times.items()}
    return pairs


def _quartiles(xs: list) -> tuple:
    q1, q2, q3 = statistics.quantiles(xs, n=4) if len(xs) > 1 else (xs[0],) * 3
    return q1, q2, q3


def main(log_dir: str) -> int:
    pairs = {p: s for p, s in _runs(Path(log_dir)).items() if {"parent", "change"} <= s.keys()}
    if not pairs:
        print("[pairs] no complete pair")
        return 1
    for metric in next(iter(pairs.values()))["parent"]:
        old = [pairs[p]["parent"][metric] for p in sorted(pairs)]
        new = [pairs[p]["change"][metric] for p in sorted(pairs)]
        wins = sum(n < o for o, n in zip(old, new))
        (o1, om, o3), (n1, nm, n3) = _quartiles(old), _quartiles(new)
        if max(new) < min(old):
            verdict = "every change process below every parent process"
        elif o3 - o1 > BOUND * om:
            verdict = f"unresolved (parent spread {o3 - o1:.4f} s > {BOUND:.0%} of its median)"
        elif nm <= om * (1 + BOUND):
            verdict = f"no regression (within {BOUND:.0%})"
        else:
            verdict = f"regression ({nm / om - 1:+.1%})"
        print(
            f"[pairs] {metric}, {len(old)} pairs (s, process medians): parent median {om:.4f} "
            f"(quartiles {o1:.4f}-{o3:.4f}), change {nm:.4f} ({n1:.4f}-{n3:.4f}); change faster "
            f"in {wins} of {len(old)} pairs; {verdict}",
            flush=True,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else ".chip_scratch/compare"))
