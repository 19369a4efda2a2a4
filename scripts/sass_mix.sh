#!/usr/bin/env bash
# Opcode mix of one kernel's SASS, as the port's build flags compile it
# (kernels/_build.py):
#
#     bash scripts/sass_mix.sh src/repro_torch/csrc/adc.cu adc_word_kernelILb0ELb0E
#
# Needs the CUDA toolkit (nvcc, cuobjdump).  Prints "<count> <opcode>" for
# every opcode of the first function whose mangled name holds the second
# argument, and writes that function's SASS to $OUT/<name>.sass (OUT
# defaults to build/sass_mix).
set -euo pipefail
NVCC=$(command -v nvcc || echo /usr/local/cuda/bin/nvcc)
OBJDUMP=$(command -v cuobjdump || echo /usr/local/cuda/bin/cuobjdump)
out=${OUT:-build/sass_mix}
mkdir -p "$out"
"$NVCC" -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
  -Xcompiler -fPIC -o "$out/lib.so" "$1"
"$OBJDUMP" -sass "$out/lib.so" |
  awk -v pat="$2" '/Function :/ {on = index($0, pat) > 0; if (on) n++}
                   on && n == 1' > "$out/$2.sass"
grep -oE '^\s+/\*[0-9a-f]+\*/\s+(@!?U?P[0-9T] )?[A-Z0-9_.]+' "$out/$2.sass" |
  awk '{print $NF}' | sed 's/\..*//' | sort | uniq -c | sort -rn
echo "SASS: $out/$2.sass ($(wc -l < "$out/$2.sass") lines)"
