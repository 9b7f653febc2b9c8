#!/bin/bash
# One-command close of a training run of the port: stop the run, score
# every harvested export held-out, export the smoothed winner with its GPU
# pin, refit its codebooks, bound it with the autoencoder ceiling, then run
# the round close. Each stage can be run again: the trend resumes, the
# export refuses other weights and keeps its own, the refit gates on
# measured improvement.
#
# Usage:
#   scripts/torch_close_flagship.sh RUN_DIR NAME_PREFIX [DATA] [SEGMENT_LEN]
# e.g.
#   scripts/torch_close_flagship.sh runs/bf base_fast_synthetic2 synthetic2 17600
#
# The trend scores on the device of the rows already in
# RUN_DIR/heldout_trend.jsonl (CUDA when there are none): rows of two
# backends do not compare. Export is skipped when exports/<prefix>_<k>k
# already exists (it stays the headline).
set -u -o pipefail
REPO=$(cd "$(dirname "$0")/.." && pwd)
cd "$REPO"
export PYTHONPATH="$REPO:${PYTHONPATH:-}"

RUN=${1:?usage: torch_close_flagship.sh RUN_DIR NAME_PREFIX [DATA] [SEGMENT_LEN]}
PREFIX=${2:?usage: torch_close_flagship.sh RUN_DIR NAME_PREFIX [DATA] [SEGMENT_LEN]}
DATA=${3:-synthetic2}
SEG=${4:-17600}
CONFIG=${CONFIG:-base_fast}
PID_FILE=${PID_FILE:-${TMPDIR:-/tmp}/train_run.pid}
STOP_FILE=${STOP_FILE:-${TMPDIR:-/tmp}/train_stop}

echo "== close 1/7: stop training =="
touch "$STOP_FILE"
if [ -f "$PID_FILE" ] && kill -0 "$(cat "$PID_FILE")" 2>/dev/null; then
  kill "$(cat "$PID_FILE")" 2>/dev/null
  for i in $(seq 1 12); do
    kill -0 "$(cat "$PID_FILE")" 2>/dev/null || break; sleep 5
  done
  kill -9 "$(cat "$PID_FILE")" 2>/dev/null
fi
sleep 3
echo "  training stopped"

echo "== close 2/7: final harvest sweep =="
# with the training pid gone the harvester sweeps once and exits
python3 scripts/torch_harvest_checkpoints.py "$RUN" "$PID_FILE" || exit 1

echo "== close 3/7: held-out trend over all harvested exports =="
DEV=$(python3 - "$RUN/heldout_trend.jsonl" <<'PYEOF'
import sys
from nsc_tpu_torch.eval.heldout import load_rows
rows = load_rows(sys.argv[1])
print("cpu" if rows and rows[0].get("backend") == "cpu" else "cuda")
PYEOF
) || exit 1
echo "  scoring on $DEV"
timeout 5400 python3 scripts/torch_heldout_trend.py "$RUN" --config "$CONFIG" \
  --data "$DATA" --segment-len "$SEG" --device "$DEV" || exit 1

echo "== close 4/7: pick the held-out winner =="
BEST=$(python3 - "$RUN/heldout_trend.jsonl" <<'PYEOF'
import sys
from nsc_tpu_torch.eval.heldout import load_rows, smoothed_winner
rows = load_rows(sys.argv[1])
best, mean = smoothed_winner(rows)
print(best["step"])
print(f"held-out winner: step {best['step']} mel_short {best['mel_short']:.4f} "
      f"(smoothed {mean:.4f}) si_snr {best['si_snr_short']:.2f} dB "
      f"of {len(rows)} candidates", file=sys.stderr)
PYEOF
) || exit 1
NAME="${PREFIX}_$((BEST / 1000))k"
echo "  winner: step $BEST -> exports/$NAME"

if [ -d "exports/$NAME" ]; then
  echo "  exports/$NAME already exported: keeping it as the headline"
else
  echo "== close 5/7: export + codebook refit =="
  timeout 1800 python3 scripts/torch_export_flagship.py "$RUN" --name "$NAME" \
    --step "$BEST" --data "$DATA" --segment-len "$SEG" --device "$DEV" || exit 1
  timeout 3600 python3 scripts/torch_refit_flagship.py "exports/$NAME" \
    --export "${NAME}_refit" --device "$DEV"
  rc=$?
  # rc 2: the refit gate refused the export (worse full-depth mel); the
  # unrefit export stays the headline, which is not a failure of the close
  if [ "$rc" -ne 0 ] && [ "$rc" -ne 2 ]; then exit "$rc"; fi
fi
HEADLINE="exports/$NAME"
[ -d "exports/${NAME}_refit" ] && HEADLINE="exports/${NAME}_refit"

echo "== close 6/7: rate-distortion ceiling of $HEADLINE =="
timeout 3600 python3 scripts/torch_rd_ceiling.py "$HEADLINE" --device "$DEV" || exit 1

echo "== close 7/7: round close =="
exec bash scripts/torch_round_close.sh
