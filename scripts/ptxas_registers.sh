#!/usr/bin/env bash
# Registers and spills of every kernel variant in one CUDA source, as
# ptxas reports them under the port's build flags (kernels/_build.py):
#
#     bash scripts/ptxas_registers.sh src/repro_torch/csrc/fused_topk.cu
#
# Needs the CUDA toolkit (nvcc); prints one "<kernel> <registers>
# <spill stores>/<spill loads>" line per entry function.
set -euo pipefail
NVCC=$(command -v nvcc || echo /usr/local/cuda/bin/nvcc)
out=$(mktemp -d)
"$NVCC" -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
  -Xcompiler -fPIC -Xptxas -v -o "$out/lib.so" "$1" 2>&1 |
  awk '/Compiling entry function/ {name=$7}
       /spill stores/ {spill=$5"/"$9}
       /registers/ {print name, $5, spill}'
rm -rf "$out"
