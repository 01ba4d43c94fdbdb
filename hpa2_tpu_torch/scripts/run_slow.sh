#!/usr/bin/env bash
# Slow tier of the port: the tests the tier-1 run leaves out with
# -m 'not slow' (tests/test_torch_*.py marked slow):
#
#   * the deeper random differential sweeps (SLOW_GEOMETRIES of
#     tests/test_torch_random_differential.py) over the port's engines;
#   * the cross-protocol analyzer fuzz through the port's
#     mutate.run_fuzz(device="cpu") (tests/test_torch_adversarial_differential.py).
#
#     bash hpa2_tpu_torch/scripts/run_slow.sh [pytest args, e.g. -k fuzz]
#
# The port's counterpart of scripts/run_slow.sh.  Runs on the CPU (the
# JAX references run with JAX_PLATFORMS=cpu); needs no card.
set -o pipefail
cd "$(dirname "$0")/../.."

exec env JAX_PLATFORMS=cpu python -m pytest tests/test_torch_*.py -v \
    -m slow --continue-on-collection-errors -p no:cacheprovider "$@"
