#!/usr/bin/env bash
# Segmented, recycle-resilient long soak of the port's engine on the card.
#
# A monolithic run loses everything past its last log line when the host is
# recycled, and cannot resume. So the soak runs as SEGMENTS (at most 4 h
# each), appends a state row per finished segment (soak_stitch), and on
# start counts the accumulated steady time from the state file: re-running
# the SAME command after any interruption resumes toward the target instead
# of restarting. Every segment waits for two healthy probes of the card
# (a small product in a subprocess under a timeout, 30 s apart), and a
# segment that fails before its first frame is retried as environmental.
#
# Usage: sspv_tpu_torch/tools/run_soak.sh <target_total_seconds> <state_dir> [end_epoch]
#   target_total_seconds: accumulated frames-flowing time to reach
#   state_dir: holds state.jsonl + seg<N>.log (survives process death)
#   end_epoch: optional absolute unix-time deadline (0/absent = none)
set -u
TARGET="${1:?target total seconds}"
DIR="${2:?state dir}"
END_EPOCH="${3:-0}"
REPO="$(cd "$(dirname "$0")/../.." && pwd)"
cd "$REPO"
mkdir -p "$DIR"
STATE="$DIR/state.jsonl"
MAIN="$DIR/run_soak.log"

probe() {
  timeout 90 python -c "import torch; x=torch.ones((8,128),device='cuda'); print(float((x@x.T).sum()))" >/dev/null 2>&1
}

deadline_hit() {
  [ "$END_EPOCH" -gt 0 ] && [ "$(date +%s)" -ge "$END_EPOCH" ]
}

wait_healthy() {
  until probe; do
    if deadline_hit; then
      echo "run_soak: deadline before device became healthy" >>"$MAIN"
      return 1
    fi
    echo "run_soak: probe failed at $(date -u +%H:%M:%S); retrying" >>"$MAIN"
    sleep 120
  done
  sleep 30
  until probe; do sleep 120; done  # two healthy probes
  return 0
}

while :; do
  # adopt any segment logs orphaned by a recycle (process died before its
  # state row was appended) so their steady time counts toward the target
  python -m sspv_tpu_torch.tools.soak_stitch --reconcile "$STATE" "$DIR" >/dev/null
  ACC=$(python -m sspv_tpu_torch.tools.soak_stitch --accumulated "$STATE")
  REMAIN=$((TARGET - ACC))
  if [ "$REMAIN" -le 0 ]; then
    echo "run_soak: target reached (${ACC}s accumulated)" >>"$MAIN"
    python -m sspv_tpu_torch.tools.soak_stitch "$STATE" >>"$MAIN"
    exit 0
  fi
  if deadline_hit; then
    echo "run_soak: deadline with ${ACC}s accumulated (target $TARGET)" >>"$MAIN"
    python -m sspv_tpu_torch.tools.soak_stitch "$STATE" >>"$MAIN"
    exit 2
  fi
  wait_healthy || exit 2
  SEG=$(( $(ls "$DIR"/seg*.log 2>/dev/null | wc -l) + 1 ))
  LOG="$DIR/seg${SEG}.log"
  DUR=$REMAIN
  [ "$DUR" -gt 14400 ] && DUR=14400   # bound loss per recycle at 4 h
  [ "$DUR" -lt 1800 ] && DUR=1800
  if [ "$END_EPOCH" -gt 0 ]; then
    LEFT=$(( END_EPOCH - $(date +%s) ))
    [ "$DUR" -gt "$LEFT" ] && DUR=$LEFT
    [ "$DUR" -lt 600 ] && { echo "run_soak: <600s left" >>"$MAIN"; exit 2; }
  fi
  echo "run_soak: segment $SEG for ${DUR}s at $(date -u +%H:%M:%S) (acc ${ACC}s/$TARGET)" >>"$MAIN"
  env SOAK_GRACE_SECONDS=1800 \
    python -m sspv_tpu_torch.examples.soak "$DUR" --device cuda >>"$LOG" 2>&1
  RC=$?
  python -m sspv_tpu_torch.tools.soak_stitch --append-state "$STATE" --log "$LOG" --rc "$RC" >>"$MAIN"
  if [ "$RC" -ne 0 ]; then
    if grep -q "recent_frames=[1-9]" "$LOG"; then
      echo "run_soak: segment $SEG failed AFTER producing frames (rc=$RC) — real" >>"$MAIN"
      exit "$RC"
    fi
    echo "run_soak: segment $SEG warm-up failure (rc=$RC, no frames) — environmental; re-probing" >>"$MAIN"
  fi
done
