"""Compare the SASS of one kernel's instances in two CUDA sources, as the
port's build flags compile them (kernels/_build.py): each instance in
<old.cu> against the instance in <new.cu> whose template arguments are the
old ones followed by <extra> (mangled literal arguments, e.g. ``Lb0E`` for
a new trailing ``false``), instruction by instruction, whitespace ignored.

    python scripts/sass_diff.py <old.cu> <new.cu> <kernel> [<extra>]

Needs the CUDA toolkit (nvcc, cuobjdump).  Prints one line per old
instance: its instruction count, the new one's, and how many differ.
"""

import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

NVCC = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
OBJDUMP = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC"]


def instances(source: str, kernel: str, tmp: Path) -> dict:
    """{mangled template arguments: SASS instruction lines} of `kernel`."""
    so = tmp / f"{len(list(tmp.iterdir()))}.so"
    subprocess.run([NVCC, *FLAGS, "-o", str(so), source], check=True)
    sass = subprocess.run([OBJDUMP, "-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        m = re.search(kernel + r"I((?:L[a-z]+n?\d+E)+)E", name)
        if m:
            code = body.split("..........")[0].splitlines()
            out[m.group(1)] = [" ".join(line.split()) for line in code
                               if re.search(r"/\*[0-9a-f]{4,}\*/", line)]
    return out


def main():
    old_src, new_src, kernel = sys.argv[1:4]
    extra = sys.argv[4] if len(sys.argv) > 4 else ""
    with tempfile.TemporaryDirectory() as tmp:
        old = instances(old_src, kernel, Path(tmp))
        new = instances(new_src, kernel, Path(tmp))
    for args, lines in sorted(old.items()):
        other = new.get(args + extra, [])
        differ = sum(a != b for a, b in zip(lines, other)) + abs(
            len(lines) - len(other))
        print(f"{kernel}<{args}>: {len(lines)} instructions, new "
              f"<{args + extra}> {len(other)}, {differ} differ", flush=True)


if __name__ == "__main__":
    main()
