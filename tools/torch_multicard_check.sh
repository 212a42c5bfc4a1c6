#!/bin/bash
# The port's launchers under torchrun on N ranks against one process, from
# the repo root: the sweep's report and store, and the population's
# generations and evaluations, must be the same, with rank 0 alone
# printing. On the card (DEV=cuda, one rank a card; local rank 0 builds
# the actor kernels while the others wait) it then runs chip_smoke.py's
# phase 46 over every card. Last, the partitioned LM steps on four ranks
# as a 2x2 ("data", "model") mesh (chip_smoke.partitioned_multicard):
# Llama-3.2-1B's prefill and train step against one card's within bf16's
# 2e-2, and each collective kind's count against the fake 2x2 mesh's.
# With DEV=cpu the ranks are gloo processes (the partitioned check on the
# reduced Llama, float32, within 1e-4).
#
#   N=4 bash tools/torch_multicard_check.sh          # four cards
#   N=4 DEV=cpu bash tools/torch_multicard_check.sh  # four CPU processes
set -euo pipefail
N=${N:-4}; DEV=${DEV:-cuda}; OUT=${OUT:-build/multicard}
export PYTHONPATH=src
rm -rf "$OUT"; mkdir -p "$OUT"
S="--scenarios fig5_baseline,fig6_capacity --methods grle,droo --seeds 3 --slots 40 --devices 14 --replay 64 --batch 16 --train-every 10 --device $DEV"
P="--members 8 --generations 2 --slots 20 --devices 14 --fleets 2 --device $DEV"
t0=$(date +%s.%N)
torchrun --standalone --nproc-per-node $N -m repro_torch.launch sweep $S --store $OUT/sN --report $OUT/rN.json > $OUT/sweepN.log 2>&1 || { tail -50 $OUT/sweepN.log; exit 1; }
t1=$(date +%s.%N)
python -m repro_torch.launch sweep $S --store $OUT/s1 --report $OUT/r1.json > $OUT/sweep1.log 2>&1
t2=$(date +%s.%N)
cmp $OUT/r1.json $OUT/rN.json && echo "sweep: report of $N ranks == one process"
diff <(ls $OUT/s1) <(ls $OUT/sN) && echo "sweep: stores list the same cells"
grep -c "cell axis over $N devices" $OUT/sweepN.log
torchrun --standalone --nproc-per-node $N -m repro_torch.launch pop $P > $OUT/popN.log 2>&1 || { tail -50 $OUT/popN.log; exit 1; }
t3=$(date +%s.%N)
python -m repro_torch.launch pop $P > $OUT/pop1.log 2>&1
t4=$(date +%s.%N)
diff <(grep -E "gen |eval " $OUT/pop1.log) <(grep -E "gen |eval " $OUT/popN.log) && echo "pop: generations and evals of $N ranks == one process"
grep -c "member axis over $N devices" $OUT/popN.log
grep -E "gen |eval " $OUT/popN.log
awk -v a=$t0 -v b=$t1 -v c=$t2 -v d=$t3 -v e=$t4 'BEGIN {printf "walls: sweep torchrun %.2f s, one process %.2f s; pop torchrun %.2f s, one process %.2f s\n", b-a, c-b, d-c, e-d}'
if [ "$DEV" = cuda ]; then
  nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
  python3 -c "import torch, chip_smoke as cs; print(cs.fleet_phase(torch.device('cuda')))" 2>&1 | grep -v "Warning\|warn_once\|_set_sync_debug"
  python3 -c "from repro_torch.kernels import _build; _build.build_all(('flash_attention', 'decode_attention', 'ssm_scan'))"
fi
python3 -c "import chip_smoke as cs; cs.partitioned_multicard('$DEV')" 2>&1 | grep -v "Warning\|warn_once\|UserWarning"
