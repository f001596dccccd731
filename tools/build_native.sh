#!/bin/bash
# Build the native host libraries into native/build/ (the loaders also
# build them at first use; see pansvr_tpu/utils/native_build.py).
set -e
cd "$(dirname "$0")/.."
exec python -m pansvr_tpu.utils.native_build
