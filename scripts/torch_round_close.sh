#!/bin/bash
# The round-end sequence of the port, on the card, with nothing else
# running on the host:
#
#   1. stop supervision and training, check that both are gone
#   2. settle, then the device's health (`doctor`, bounded in time)
#   3. chip_smoke.py: every kernel built and held against its plain
#      version, every path driven (in the place of a bench until the port
#      has one)
#   4. the card tests (tests/test_torch_cuda.py)
#
# Not here: a suite with a staleness guard (it waits for the port's bench)
# and the multichip dryrun (a TPU-host check; chip_smoke.py's dp phase
# holds the port's data parallelism).
#
# Usage: scripts/torch_round_close.sh
set -u -o pipefail
REPO=$(cd "$(dirname "$0")/.." && pwd)
cd "$REPO"
export PYTHONPATH="$REPO:${PYTHONPATH:-}"
PID_FILE=${PID_FILE:-${TMPDIR:-/tmp}/train_run.pid}
STOP_FILE=${STOP_FILE:-${TMPDIR:-/tmp}/train_stop}

echo "== 1/4 stopping training + watchdog =="
touch "$STOP_FILE"
if [ -f "$PID_FILE" ] && kill -0 "$(cat "$PID_FILE")" 2>/dev/null; then
  kill "$(cat "$PID_FILE")" 2>/dev/null; sleep 8
  kill -9 "$(cat "$PID_FILE")" 2>/dev/null
  echo "  killed training pid $(cat "$PID_FILE")"
fi
# the watchdog sees the stop file at its next poll (120 s)
for i in $(seq 1 30); do
  pgrep -f "scripts/torch_train_watchdog.py" >/dev/null || break; sleep 5
done
sleep 5
if [ -f "$PID_FILE" ] && kill -0 "$(cat "$PID_FILE")" 2>/dev/null; then
  echo "  ERROR: training pid still alive: aborting"; exit 1
fi
if pgrep -f "scripts/torch_train_watchdog.py" >/dev/null; then
  echo "  ERROR: a watchdog is still running: aborting"; exit 1
fi
echo "  host quiet"

echo "== 2/4 idle settle + device health =="
sleep 10
# doctor runs two deadline-guarded device touches: the outer limit is
# above twice its --timeout
if ! timeout 420 python3 -m nsc_tpu_torch doctor --timeout 180 --json; then
  echo "  ERROR: the device is wedged or failing (see doctor's output); run"
  echo "  the round close again when doctor exits 0"; exit 1
fi

echo "== 3/4 chip_smoke.py =="
timeout 1200 python3 chip_smoke.py | tail -3 || exit 1

echo "== 4/4 card tests =="
# --noconftest: tests/conftest.py imports JAX, which the card's host lacks
timeout 1800 python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q || exit 1
echo "== round close complete =="
