#!/bin/bash
# Repeats chip_smoke.py and runs the trunk kernels' `cuda` tests under
# compute-sanitizer, to tell a fault of the port from one of the card.
#
#     bash pointnerf_tpu_torch/scripts/repeat_smoke.sh [--runs N] [--out DIR]
#                                                      [--sanitize] TREE...
#
# For each TREE (a checkout, or a `git archive` unpacked in a git-ignored
# directory), runs `python3 chip_smoke.py` from it N times (default 3), each
# log to OUT/<tree>_smoke_<i>.log (default OUT: chiprun_out/repeat). With
# --sanitize it then runs `compute-sanitizer --tool racecheck` and
# `--tool memcheck` on TREE's `tests/test_torch_port_cuda.py -k trunk`, if the
# CUDA toolkit has compute-sanitizer. `nvidia-smi -q -d ECC` and the Xid
# lines of `dmesg` (where readable) are logged before and after. Prints one
# summary line per run.
set -u
RUNS=3
OUT=chiprun_out/repeat
SAN=0
TREES=()
while [ $# -gt 0 ]; do
  case "$1" in
    --runs) RUNS=$2; shift 2 ;;
    --out) OUT=$2; shift 2 ;;
    --sanitize) SAN=1; shift ;;
    *) TREES+=("$1"); shift ;;
  esac
done
mkdir -p "$OUT"
OUT=$(cd "$OUT" && pwd)

card_state() {
  nvidia-smi -q -d ECC > "$OUT/ecc_$1.txt" 2>&1
  echo "ECC $1: $(grep -A3 -i 'Volatile' "$OUT/ecc_$1.txt" | grep -iE 'Total|Uncorr' | tr -s ' ' | tr '\n' ';')"
  if dmesg > "$OUT/dmesg_$1.txt" 2>&1; then
    echo "Xid lines $1: $(grep -ci xid "$OUT/dmesg_$1.txt")"
  else
    echo "Xid lines $1: dmesg not readable"
  fi
}

card_state before
for tree in "${TREES[@]}"; do
  name=$(basename "$(cd "$tree" && pwd)")
  for i in $(seq "$RUNS"); do
    t0=$(date +%s)
    (cd "$tree" && timeout 1200 python3 chip_smoke.py) \
      > "$OUT/${name}_smoke_$i.log" 2>&1
    rc=$?
    echo "$name chip_smoke run $i: rc $rc, $(( $(date +%s) - t0 )) s;" \
      "last line: $(tail -n 1 "$OUT/${name}_smoke_$i.log" | cut -c1-160)"
    [ $rc -ne 0 ] && grep -nE 'Error|error|assert' \
      "$OUT/${name}_smoke_$i.log" | tail -n 5
  done
  if [ "$SAN" = 1 ]; then
    san=$(command -v compute-sanitizer || ls /usr/local/cuda/bin/compute-sanitizer 2>/dev/null)
    if [ -z "$san" ]; then
      echo "$name: no compute-sanitizer in the CUDA toolkit"
    else
      for tool in racecheck memcheck; do
        (cd "$tree" && timeout 600 "$san" --tool "$tool" \
          --target-processes all --print-limit 20 \
          python3 -m pytest --noconftest -q -p no:cacheprovider \
          tests/test_torch_port_cuda.py -k trunk) \
          > "$OUT/${name}_$tool.log" 2>&1
        echo "$name $tool: rc $?; $(grep -E 'ERROR SUMMARY|RACECHECK SUMMARY|passed|failed' \
          "$OUT/${name}_$tool.log" | tail -n 3 | tr '\n' ';')"
      done
    fi
  fi
done
card_state after
