"""Measure the fp32 scan's error against an exact (float64) product on one
GPU: the B2 fp32 kernel, its plain version on the card (cuBLAS SGEMM, TF32
off) and the plain version on the CPU.

    python scripts/fp32_error.py [<src dir>]     # default: this checkout

For each returned id the exact score is recomputed in float64; the error
is max |returned score - exact| / row scale over every returned slot, the
row scale being max |plain score| of the row + 1 (``chip_smoke.py``'s
``_check_fp32``).  Shapes: the product-like scan (4,000,000 x 256, ip,
256 queries, k=100) and the SIFT-like one (1,000,000 x 128, l2, 256
queries, k=100), N(0, 1) data, seed 11; the CPU plain version takes the
first 16 queries.  Also prints the largest rank-wise gap between the
kernel's and the plain version's scores over the same scale.
"""

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, sys.argv[1] if len(sys.argv) > 1
                else str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

import repro_torch  # noqa: E402,F401  (TF32 off)
from repro_torch.kernels import fused_topk as F  # noqa: E402


def rel_err(q, x, metric, s, ids, scale):
    valid = ids >= 0
    rows = x[ids.clamp_min(0).long()].double()
    q64 = q.double()
    dot = torch.einsum("qd,qkd->qk", q64, rows)
    exact = dot if metric == "ip" else -((q64 * q64).sum(1, keepdim=True)
                                         + (rows * rows).sum(2) - 2 * dot)
    return float(((s.double() - exact).abs() / scale)[valid].max())


def row_scale(s, ids):
    return (torch.where(ids >= 0, s.abs(), 0).amax(1, keepdim=True).double()
            + 1.0)


def main():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    for name, N, d, metric in (("product", 4_000_000, 256, "ip"),
                               ("sift", 1_000_000, 128, "l2")):
        x = torch.randn(N, d, generator=g, device="cuda")
        q = torch.randn(256, d, generator=g, device="cuda")
        k = 100
        ks, ki = F.fused_topk_cuda(q, x, k=k, metric=metric)
        ps, pi = F.fused_topk_plain(q, x, k=k, metric=metric)
        scale = row_scale(ps, pi)
        kern = rel_err(q, x, metric, ks, ki, scale)
        plain = rel_err(q, x, metric, ps, pi, scale)
        rank = float(((ks.double() - ps.double()).abs() / scale).max())
        qc, xc = q[:16].cpu(), x.cpu()
        cs, ci = F.fused_topk_plain(qc, xc, k=k, metric=metric)
        cpu = rel_err(qc, xc, metric, cs, ci, row_scale(cs, ci))
        swaps = int((ki != pi).sum())
        print(f"{name} {N}x{d} {metric} Q=256 k={k}: |score - float64| / row "
              f"scale: kernel {kern:.3e}, plain on the card (cuBLAS) "
              f"{plain:.3e}, plain on the CPU (16 queries) {cpu:.3e}; "
              f"kernel vs plain by rank {rank:.3e}, id swaps {swaps} | {card}",
              flush=True)
        del x, q


if __name__ == "__main__":
    main()
