#!/usr/bin/env bash
# Static analysis gate of the port: the declarative-table checks and
# spec equivalence, the lint, the analyzer's mutation self-test, the
# op-census contracts on the CPU, and the ASan+UBSan smoke run of the
# native engine.  Needs no card; prints STATIC_OK when every check passed.
#
#     bash hpa2_tpu_torch/scripts/run_static.sh
#
# The port's counterpart of scripts/run_static.sh.  The same checks run
# inside the test suite (tests/test_torch_analysis.py,
# tests/test_torch_contracts.py); this script is the standalone entry
# point.  The sanitized engine is built from native/src with g++ into
# hpa2_tpu_torch/build/native/ (hpa2_tpu_torch/native.py:ensure_sanitized),
# never by make.
set -e
cd "$(dirname "$0")/../.."

echo "== analysis check (static table checks + spec equivalence) =="
python -m hpa2_tpu_torch.analysis check

echo "== analysis lint (dead handlers, the port's pitfalls) =="
python -m hpa2_tpu_torch.analysis lint

echo "== analyzer mutation self-test =="
python -m hpa2_tpu_torch.analysis mutation-test

echo "== op-census contracts (every engine path, on the CPU) =="
timeout -k 10 600 python -m hpa2_tpu_torch.analysis contracts --check \
    --device cpu

echo "== native ASan+UBSan smoke =="
if asan=$(python -c "from hpa2_tpu_torch.native import ensure_sanitized; print(ensure_sanitized())" 2>/dev/null); then
    ASAN_OPTIONS=detect_leaks=0:abort_on_error=1 \
    UBSAN_OPTIONS=halt_on_error=1 \
        "$asan" --bench 300 --robust --json
else
    echo "sanitizer toolchain unavailable; skipped"
fi

echo "STATIC_OK"
