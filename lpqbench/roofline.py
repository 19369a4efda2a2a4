"""The frozen work count of a request and the published H100 peaks.

The count is the least work the request asks for, whatever kernels
implement it, so a change that replaces a kernel is read on the same
yardstick:

    bytes  every corpus code byte once (N x row bytes), the request's fp32
           queries (Q x d x 4), its k result pairs (Q x k x 8), and for a
           rerank tail the gathered fp32 rows (Q x depth x d x 4)
    ops    2 Q N d integer operations at the int8 tensor-core peak (int4
           codes too), and 2 Q depth d float32 operations of the rerank at
           the float32 peak outside the tensor cores

The least time is the larger of bytes over the memory bandwidth and the
operations' time at their peaks.  Peaks: NVIDIA's H100 SXM data sheet,
dense rates, at the full 700 W power limit; ``power_limit_w`` reads the
card's own limit, which is reported beside every share.
"""

from __future__ import annotations

import subprocess

#: H100 SXM (NVIDIA data sheet): HBM3 bytes/s, int8 tensor-core op/s,
#: float32 op/s outside the tensor cores
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
FP32_OPS_S = 67e12


def code_row_bytes(config: dict) -> int:
    """Bytes of one stored code row: d bytes at 8 bits, ceil(d / 2) at 4."""
    d, bits = int(config["dim"]), int(config["quant"]["bits"])
    return d if bits == 8 else -(-d // 2)


def request_work(config: dict, q: int) -> dict:
    """Bytes, integer ops and float32 ops of one request of ``q`` queries."""
    n, d, k = int(config["rows"]), int(config["dim"]), int(config["k"])
    depth = int(config["rerank"]["depth"]) if config.get("rerank") else 0
    nbytes = n * code_row_bytes(config) + q * d * 4 + q * k * 8
    nbytes += q * depth * d * 4
    return {"bytes": nbytes, "int_ops": 2 * q * n * d,
            "fp_ops": 2 * q * depth * d}


def least_seconds(work: dict) -> float:
    ops_s = work["int_ops"] / INT8_OPS_S + work["fp_ops"] / FP32_OPS_S
    return max(work["bytes"] / HBM_BYTES_S, ops_s)


def power_limit_w() -> float | None:
    """The card's power limit in watts (``nvidia-smi``), None if unread."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
