#!/bin/bash
# Time chip_smoke.py phases of another checkout beside this tree's, in turns
# (other, this, this, other), on one card in one call.
#
#   bash scripts/chip_smoke_turns.sh OTHER_DIR [PHASES]
#
# OTHER_DIR: a checkout unpacked inside this tree (e.g. `git archive <commit>`
# under outputs/); PHASES: chip_smoke.py's --phases (default
# build,train,parallel). Each run's output goes to
# chiprun_out/turns_<side>_<i>.log; the phases' times and the card's name and
# power limit to chiprun_out/turns.log.
set -u
other=$(cd "$1" && pwd)
phases=${2:-build,train,parallel}
here=$(cd "$(dirname "$0")/.." && pwd)
mkdir -p "$here/chiprun_out"
log="$here/chiprun_out/turns.log"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$log"
i=0
for side in other this this other; do
  i=$((i + 1))
  dir=$here; [ "$side" = other ] && dir=$other
  echo "=== $i $side ($dir)" | tee -a "$log"
  (cd "$dir" && python3 chip_smoke.py --phases "$phases") \
    > "$here/chiprun_out/turns_${side}_$i.log" 2>&1
  echo "rc $?" | tee -a "$log"
  grep -E "took|all phases|FAIL" "$here/chiprun_out/turns_${side}_$i.log" | tee -a "$log"
done
