#!/bin/bash
# Times chip_smoke.py of each checkout named on the command line, in the
# order given, each on the builds of its own checkout: a checkout is a
# directory under build/ (listed in .gitignore), unpacked with
# `git archive <commit> | tar -x -C build/<name>`.  Prints the card's name
# and power limit, then one line of exit code and wall seconds a turn with
# its dim phases' lines and its last two lines; the whole output of turn i
# goes to chiprun_out/turn<i>_<name>.log.
# Run from the repository's root on the card, e.g.
#   bash port_scripts/smoke_turns.sh change parent
root=$(pwd)
mkdir -p "$root/chiprun_out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'
i=0
for who in "$@"; do
  i=$((i + 1))
  log="$root/chiprun_out/turn${i}_${who}.log"
  cd "$root/build/$who" || exit 9
  s=$(date +%s.%N)
  timeout -k 10 1250 python3 chip_smoke.py > "$log" 2>&1
  rc=$?
  e=$(date +%s.%N)
  echo "turn $i $who rc=$rc wall_s=$(python3 -c "print(round($e - $s, 1))")"
  grep -a "^\[shard-dim\|^\[shard-dim-odd\]\|^\[shard-dim-logistic\]" "$log" | cut -c1-400
  tail -n 2 "$log" | cut -c1-300
done
