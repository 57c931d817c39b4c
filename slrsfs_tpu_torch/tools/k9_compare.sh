#!/bin/bash
# K9's bench (python -m slrsfs_tpu_torch.tools.conv_prototype) in several
# unpacked trees of this repository on one card, in the order given and then
# reversed, so that versions are compared within one run and each is timed
# early and late:
#
#   mkdir -p cmp/parent && git archive adfd28c | tar -x -C cmp/parent
#   bash slrsfs_tpu_torch/tools/k9_compare.sh cmp/parent .
#
# Prints the card's name and power limit, then each tree's bench lines
# (its JSON line left out) prefixed with the tree. Exits 1 if a bench
# failed.
set -u -o pipefail
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
rc=0
for tree in "$@" $(printf '%s\n' "$@" | tac); do
  (cd "$tree" && PYTHONPATH=. python -m slrsfs_tpu_torch.tools.conv_prototype) 2>&1 \
    | grep -v '^{' | sed "s|^|[$tree] |" || rc=1
done
exit $rc
