#!/usr/bin/env bash
# Full CPU test gate.
#
# Runs BOTH suites -- fast and slow -- on the CPU backend with 8 virtual
# devices, and refuses to pass on any failure.  The GPU path is checked
# separately on the card by `python chip_smoke.py`.
#
# Usage: tools/check.sh [extra pytest args]
set -euo pipefail
cd "$(dirname "$0")/.."

export JAX_PLATFORMS=cpu
export XLA_FLAGS="${XLA_FLAGS:---xla_force_host_platform_device_count=8}"

echo "== fast suite =="
python -m pytest tests/ -q -m "not slow" "$@"
echo "== slow suite =="
python -m pytest tests/ -q -m "slow" "$@"
echo "ALL GREEN"
