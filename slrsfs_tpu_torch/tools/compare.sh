#!/bin/bash
# One bench in several unpacked trees of this repository on one card, in
# the order given and then reversed, so that versions are compared within
# one run and each is timed early and late:
#
#   mkdir -p _archive/parent && git archive dd46778 | tar -x -C _archive/parent
#   bash slrsfs_tpu_torch/tools/compare.sh maxwarp _archive/parent .
#
# k9       each tree's own K9 bench (python -m
#          slrsfs_tpu_torch.tools.conv_prototype);
# maxwarp  this checkout's chip_smoke.py --maxwarp-in TREE: K5 and K6 of
#          each tree's package, as called, on the card alone and the host's
#          cost per call, beside scatter_reduce_, with the CUDA kernels one
#          call runs, and the SLR f32 v2 render (median of 5);
# k2       this checkout's chip_smoke.py --k2-in TREE: K2 and K2-SLR of
#          each tree's package in f32 and bf16 accumulation, as called, on
#          the card alone and the host's cost per call, with the card's
#          work per call split by CUDA kernel and memset, beside
#          index_add_, and the f32 window scatter's misses; K8; and the
#          float32, bfloat16 and bfloat16-fast renders of both models
#          (median of 5);
# k3       this checkout's chip_smoke.py --k3-in TREE: the stage-1
#          training step's kernels of each tree's package: K3's forward at
#          (1, 256, 256, 65) and (16, 256, 256, 65), timed the same ways
#          and split into the output's zeroing and the scatter, beside
#          index_add_, with the window misses; K3's backward on the random
#          and the scene flow, and K7 dense and compact, each with its
#          split; K3's bf16 forward and backward on the bf16 stage-1 and
#          SLR steps' own rows, with their splits, bounds and window
#          misses; the dense baseline float32 render (median of 5) and the
#          training step (median of 3);
# k1       this checkout's chip_smoke.py --k1-in TREE: K1 of each tree's
#          package on the scene, quarter-pixel and leaving flows, and K4's
#          four forms on the scene, leaving and random flows, each held bit
#          for bit against its plain version, as called, on the card alone
#          and the host's cost per call, split by torch.profiler, beside
#          its bytes bound and its latency bound (this checkout's
#          tools/chase_probe.py); and the baseline float32 render (median
#          of 5);
# k7bwd    this checkout's chip_smoke.py --k7bwd-in TREE: K7's backward of
#          each tree's package on the unfrozen joint step's predicted
#          motion, the scene flow and the leaving flow, as called, on the
#          card alone and the host's cost per call, beside its bound and
#          the window's counts (misses, flushed cells); and the joint step
#          (median of 3).
#
# Prints the card's name and power limit, then each tree's bench lines
# (JSON lines left out) prefixed with the tree. Exits 1 if a bench failed.
set -u -o pipefail
bench=${1:-}
shift
case $bench in
  k9 | maxwarp | k2 | k3 | k1 | k7bwd) ;;
  *) echo "usage: $0 k9|maxwarp|k2|k3|k1|k7bwd TREE..." >&2; exit 2 ;;
esac
here=$(cd "$(dirname "$0")/../.." && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
rc=0
for tree in "$@" $(printf '%s\n' "$@" | tac); do
  case $bench in
    k9) (cd "$tree" && PYTHONPATH=. python -m slrsfs_tpu_torch.tools.conv_prototype) ;;
    maxwarp) python "$here/chip_smoke.py" --maxwarp-in "$tree" ;;
    k2) python "$here/chip_smoke.py" --k2-in "$tree" ;;
    k3) python "$here/chip_smoke.py" --k3-in "$tree" ;;
    k1) python "$here/chip_smoke.py" --k1-in "$tree" ;;
    k7bwd) python "$here/chip_smoke.py" --k7bwd-in "$tree" ;;
  esac 2>&1 | grep -v '^{' | sed "s|^|[$tree] |" || rc=1
done
exit $rc
