"""Build the hand-written CUDA kernels under ``csrc/`` and bind them.

Route: ``nvcc`` compiles each ``csrc/*.cu`` into its own shared library
with a plain C interface (``-gencode arch=compute_90a,code=sm_90a``), all
sources at once in parallel processes, and ``ctypes`` loads the result.
No PyTorch headers are involved, so a build takes seconds.  Output goes to
``build/repro_torch_kernels/<hash>/`` at the repository root, keyed on a
hash of every file in ``csrc/`` and the flags: an edited source rebuilds,
an unchanged one is reused.  The build happens at first use, never at
import.  Never ``--use_fast_math``: B1's codes must round exactly as the
plain version's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

#: library -> {C function: (argtypes, restype)}
SIGNATURES = {
    "quantize": {
        # x, lo, hi, zero, out, n_rows, d, bits, stream
        "rt_quantize": ([_P, _P, _P, _P, _P, _L, _I, _I, _P], _I),
    },
    "fused_topk": {
        # kind, l2, bq, cap, q0, q1, x, mask, part, gbuf, mbuf, out_s,
        # out_i, Q, N, width, k, n_splits, stream
        "rt_fused_topk": ([_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _I, _L, _I, _I, _I, _P], _I),
        # l2, bq, cap, gbuf, width, i4
        "rt_i8_blocks_per_sm": ([_I, _I, _I, _I, _I, _I], _I),
    },
    "adc": {
        # kbits, bq, mode, subsets, cap, lut0, lut1, codes, mask, part,
        # gbuf, mbuf, out_s, out_i, Q, N, mb, k, n_splits, stream
        "rt_fused_adc": ([_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                          _P, _P, _I, _L, _I, _I, _I, _P], _I),
        # bq, cap, gbuf, mb
        "rt_adc4_blocks_per_sm": ([_I, _I, _I, _I], _I),
        # bq, subsets, cap, gbuf, lutg, mb
        "rt_adc_word_blocks_per_sm": ([_I, _I, _I, _I, _I, _I], _I),
    },
    "qscore": {
        # i4, l2, tile, q0, q1, x, out, Q, N, width, stream
        "rt_qscore": ([_I, _I, _I, _P, _P, _P, _P, _I, _L, _I, _P], _I),
    },
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
#: guards the wrappers' launch counters: a maintenance thread launches
#: beside the request path, and ``+=`` on a dict item is not atomic
_COUNT_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the port's kernels are built from csrc/ with the "
            "CUDA toolkit at first use on a machine with an NVIDIA GPU"
        )
    return path


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh", ".h"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def build_all() -> dict[str, object]:
    """Compile every library that is missing for the current sources, one
    ``nvcc`` per source, all started together.  Raises on any failure;
    returns the seconds taken, what was built, and each nvcc's output."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in SIGNATURES:
        so = out / f"lib{name}.so"
        if so.exists():
            continue
        tmp = out / f"lib{name}.so.tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    logs = {}
    failed = []
    for name, (p, tmp, so) in procs.items():
        log, _ = p.communicate()
        logs[name] = log
        if p.returncode != 0:
            failed.append(f"--- {name}.cu (rc={p.returncode}) ---\n{log}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return dict(seconds=time.perf_counter() - t0, built=sorted(procs),
                logs=logs, dir=str(out))


def lib(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (building every kernel on first use)."""
    with _LOCK:
        if name not in _LIBS:
            build_all()
            so = ctypes.CDLL(str(build_dir() / f"lib{name}.so"))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(so, fn).argtypes = argtypes
                getattr(so, fn).restype = restype
            _LIBS[name] = so
        return _LIBS[name]


def count(launches: dict[str, int], name: str) -> None:
    """Add one launch of ``name`` to a wrapper's counter."""
    with _COUNT_LOCK:
        launches[name] += 1


def check(rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
