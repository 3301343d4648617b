#!/bin/bash
# Canned end-to-end run matrix (reference test.sh:1-6 parity).
#
# Six invocations sweeping template {td, fd} x injectFD {0, 1} x
# window_flag {0, 1} x downsample {0, 2, 100} on the paper source
# (M = 3.67e6, mu = 292, e0 = 0.579, Tobs = 4 yr) plus the tutorial
# source, then one check_mode_by_mode scan. nsteps=1, as in the
# reference: the matrix validates that every path runs end-to-end.
#
#   QUICK=1 ./tools/test_matrix.sh    # shrink Tobs/grids for CI boxes
set -e
cd "$(dirname "$0")/.."
PY="python -m emri_frequencydomainwaveforms_tpu.cli.emri_pe"
SCAN="python -m emri_frequencydomainwaveforms_tpu.cli.check_mode_by_mode"
OUT=$(mktemp -d)
trap 'rm -rf "$OUT"' EXIT

if [ "${QUICK:-0}" = "1" ]; then
  TOBS=0.1; TOBS2=0.1; DS0=32; NSCAN=2
else
  TOBS=4.0; TOBS2=2.0; DS0=0; NSCAN=10
fi

PAPER="-M 3670041.7362535275 -mu 292.0583167470244 -e0 0.5794130830706371 -eps 1e-2 -dt 10.0 -nwalkers 16 -ntemps 1 -nsteps 1"

$PY -Tobs $TOBS $PAPER -injectFD 0 -template td -downsample $DS0 -window_flag 1 --outname $OUT/tm1.npz
$PY -Tobs $TOBS $PAPER -injectFD 1 -template td -downsample $DS0 -window_flag 1 --outname $OUT/tm2.npz
$PY -Tobs $TOBS $PAPER -injectFD 0 -template fd -downsample $DS0 -window_flag 1 --outname $OUT/tm3.npz
$PY -Tobs $TOBS $PAPER -injectFD 1 -template fd -downsample 2 -window_flag 0 --outname $OUT/tm4.npz
$PY -Tobs $TOBS2 -M 1e6 -mu 10.0 -e0 0.35 -eps 1e-2 -dt 10.0 -injectFD 1 \
    -template fd -nwalkers 16 -ntemps 1 -downsample 100 -nsteps 1 --outname $OUT/tm5.npz
$SCAN -Tobs 1.0 -eps 1e-2 -dt 10.0 -nsteps $NSCAN --outname $OUT/tm_scan.npz

echo "test matrix: all 6 runs completed"
