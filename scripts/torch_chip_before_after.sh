#!/usr/bin/env bash
# Before/after on one card in one session: chip_smoke.py of an earlier tree and
# of this one in turns (earlier, this, this, earlier), then the forward kernels
# of the earlier tree against this tree's with scripts/torch_fwd_compare.py.
#
#   scripts/torch_chip_before_after.sh EARLIER_TREE [OUT_DIR]
#
# EARLIER_TREE: an unpacked earlier commit (git archive <commit> | tar -x -C DIR),
# inside a directory .gitignore lists. Logs go to OUT_DIR (default
# build/before_after/); the attack lines and the forward kernel lines are echoed.
set -u
repo="$(cd "$(dirname "$0")/.." && pwd)"
earlier="$(cd "$1" && pwd)"
out="$(mkdir -p "${2:-$repo/build/before_after}" && cd "${2:-$repo/build/before_after}" && pwd)"
status=0

run_smoke() {  # $1: tree, $2: tag
  if (cd "$1" && python3 chip_smoke.py > "$out/smoke_$2.log" 2>&1); then
    echo "[before-after] $2: chip_smoke.py ok"
  else
    echo "[before-after] $2: chip_smoke.py FAILED"
    status=1
  fi
  grep -E '^\[main\] (fgsm|pgd)|^\[attack-profile\]|^\[kernel\] sampled_dense_(xs_)?fwd ' "$out/smoke_$2.log" | cut -c1-240
}

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run_smoke "$earlier" earlier1
run_smoke "$repo" this1
run_smoke "$repo" this2
run_smoke "$earlier" earlier2
python3 "$repo/scripts/torch_fwd_compare.py" "$earlier/robustbnns_tpu_torch/csrc/sampled_dense_fwd.cu" \
  > "$out/fwd_compare.log" 2>&1 || status=1
grep -E '^\[fwd-compare\]' "$out/fwd_compare.log"
exit $status
