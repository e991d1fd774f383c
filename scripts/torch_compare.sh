#!/bin/bash
# The port on one card against an older checkout of it, in one run:
# chip_smoke.py of the old tree and of this one, old / new / new / old, then
# one profiled warm native-commit prove (chip_smoke.profile_prove) from each
# tree, this chip_smoke.py loaded by path from the old tree's root so that
# the old package is the one profiled.  The logs go to the directory given
# second (default .chip_scratch/compare, gitignored); the lines that carry
# the end-to-end numbers are printed.  Last, ten pairs of processes, one
# from each tree, the old tree first in odd pairs and second in even ones,
# each timing three warm native-commit and three warm device-commit proves
# in turns with their grand_products phase (chip_smoke.time_proves); a
# summary of the process medians follows (scripts/prove_pairs.py).  With
# "proves" as the third argument only those run; with "kernels",
# chip_smoke.compare_kernels (kernel device times
# through calls both trees have) in turns old / new / new / old, then one
# profiled warm native-commit and one W = 1 sharded prove from each tree
# (profile_prove, profile_sharded_prove), then the proves; with "setup",
# only each tree's own chip_smoke.py phases 5 and 8 (ParamsKZG.setup(16)
# and the 2^20 Poseidon sponge, after its build), three warm
# ParamsKZG.setup(16) calls timed between them, and its kernel checks of
# the setup's and the sponge's kernels (the timed sizes of jac_ladder,
# jac_fixed_base where the tree has it, and poseidon_hash), old / new /
# new / old.
# From the repository root:
#
#   git archive <commit> | tar -x -C .chip_scratch/parent   # a gitignored dir
#   bash scripts/torch_compare.sh .chip_scratch/parent [log dir] [proves|kernels|setup]
set -u
RUNS="parent1 change1 change2 parent2"
MODE=${3:-}
case $MODE in
  '') ;;
  proves|kernels|setup) RUNS="" ;;
  *) echo "unknown mode $MODE (proves, kernels or setup)" >&2; exit 2 ;;
esac
ROOT=$(cd "$(dirname "$0")/.." && pwd)
OLD=$(cd "$1" && pwd)
OUT=${2:-$ROOT/.chip_scratch/compare}
mkdir -p "$OUT"
OUT=$(cd "$OUT" && pwd)
cd "$ROOT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for run in $RUNS; do
  t0=$(date +%s)
  case $run in
    parent*) (cd "$OLD" && timeout 900 python3 chip_smoke.py > "$OUT/$run.log" 2>&1); rc=$? ;;
    change*) timeout 900 python3 chip_smoke.py > "$OUT/$run.log" 2>&1; rc=$? ;;
  esac
  echo "$run rc=$rc $(( $(date +%s) - t0 )) s"
  grep -E "^\[(prove|mock|poseidon|profile|done)\]|vm_eval m=|mod_add m=|mod_sub m=|bn254_fr C=(83 n=32768|1 n=1048576) on the device" "$OUT/$run.log" | grep -v keygen | cut -c1-900
done
if [ "$MODE" = setup ]; then
  SETUP="import statistics, time, torch, chip_smoke as m
from halo2_tpu_torch.kzg.params import ParamsKZG
d = m.phase_device()
m.phase_build()
m.phase_setup(d)
ts = []
for _ in range(3):
    torch.cuda.synchronize(); t0 = time.perf_counter(); ParamsKZG.setup(16); torch.cuda.synchronize()
    ts.append(time.perf_counter() - t0)
print(f'[setup] warm ParamsKZG.setup(16): median {statistics.median(ts):.3f} s of {[round(t, 3) for t in ts]}')
m.phase_poseidon(d)
e, t = {n: 0.0 for n, _, _ in m.KERNELS}, {}
m._check_setup_ladder(d, e, t)
if hasattr(m, '_check_fixed_base'):
    m._check_fixed_base(d, e, t)
m._check_sponge(d, e, t)"
  for run in parent1 change1 change2 parent2; do
    case $run in
      parent*) (cd "$OLD" && timeout 600 python3 -c "$SETUP" > "$OUT/setup_$run.log" 2>&1); rc=$? ;;
      change*) timeout 600 python3 -c "$SETUP" > "$OUT/setup_$run.log" 2>&1; rc=$? ;;
    esac
    echo "setup $run rc=$rc"
    grep -E "^\[(setup|poseidon)\]|^\[build\] CUDA|(jac_ladder|jac_fixed_base|poseidon_hash bn254_fr MySpec\(5, 4\) L=4) m=" \
      "$OUT/setup_$run.log" | cut -c1-900
  done
  exit 0
fi
PROF="import importlib.util
s = importlib.util.spec_from_file_location('chip_smoke_new', '$ROOT/chip_smoke.py')
m = importlib.util.module_from_spec(s); s.loader.exec_module(m)
m.profile_prove(m.phase_device())"
PROVES=${PROF/profile_prove/time_proves}
if [ "$MODE" = kernels ]; then
  KERN=${PROF/profile_prove/compare_kernels}
  for run in parent1 change1 change2 parent2; do
    case $run in
      parent*) (cd "$OLD" && timeout 600 python3 -c "$KERN" > "$OUT/kernels_$run.log" 2>&1); rc=$? ;;
      change*) timeout 600 python3 -c "$KERN" > "$OUT/kernels_$run.log" 2>&1; rc=$? ;;
    esac
    echo "kernels $run rc=$rc"
    grep -E "^\[compare\]|jac_(madd|add) m=1048576 (wide|narrow)" "$OUT/kernels_$run.log" | cut -c1-300
  done
  PROF="$PROF
m.profile_sharded_prove(m.phase_device())"
fi
if [ -n "$RUNS" ] || [ "$MODE" = kernels ]; then
  (cd "$OLD" && timeout 300 python3 -c "$PROF" > "$OUT/profile_parent.log" 2>&1; echo "profile parent rc=$?")
  grep profile "$OUT/profile_parent.log" | cut -c1-1500
  timeout 300 python3 -c "$PROF" > "$OUT/profile_change.log" 2>&1; echo "profile change rc=$?"
  grep profile "$OUT/profile_change.log" | cut -c1-1500
fi
for pair in 1 2 3 4 5 6 7 8 9 10; do
  if [ $((pair % 2)) = 1 ]; then order="parent change"; else order="change parent"; fi
  for run in $order; do
    log="$OUT/proves_${pair}_$run.log"
    case $run in
      parent) (cd "$OLD" && timeout 300 python3 -c "$PROVES" > "$log" 2>&1); rc=$? ;;
      change) timeout 300 python3 -c "$PROVES" > "$log" 2>&1; rc=$? ;;
    esac
    echo "proves pair $pair $run rc=$rc $(grep '^\[proves\]' "$log")"
  done
done
python3 "$ROOT/scripts/prove_pairs.py" "$OUT"
