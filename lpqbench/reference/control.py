"""The control: the plain reference put in the program's place and computed
one precision below what the configuration states (its ``control`` key):

    bits     the codes' width (int4 for an int8 configuration)
    float    the type of Eq. 1's constants and of the encode (bfloat16 for
             float32)
    matmul   "tf32": the rerank's float32 products with TF32 operands
             (the configuration's are float32 with TF32 off); the rounding
             is written out, since the card's batched matrix-vector product
             takes no tensor-core path and so ignores the TF32 switch

It answers with the same interface as the program (``__call__`` on a
[Q, d] fp32 batch, ``constants``, ``code_rows``), so the harness drives it
and the judge reads it as it would the program; ``correct`` has to come
out false.  It is not run by the benchmark's own runs (``control.py``
runs it).
"""

from __future__ import annotations

import torch

from lpqbench import data
from lpqbench.reference import eq1, scan
from lpqbench.reference.judge import STEP

FLOATS = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits, to nearest even
    (finite values; the exponent's 8 bits are float32's)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class Control:
    def __init__(self, config: dict, corpus: torch.Tensor, dev):
        ctl = config["control"]
        self.config, self.x, self.dev = config, corpus, dev
        self.bits = int(ctl.get("bits", config["quant"]["bits"]))
        self.fdt = FLOATS[ctl.get("float", "float32")]
        self.tf32 = ctl.get("matmul") == "tf32"
        q = config["quant"]
        self.consts = eq1.constants(corpus.split(data.SLAB),
                                    int(config["dim"]), q["scheme"],
                                    float(q.get("sigmas", 1.0)), dev,
                                    dtype=self.fdt)

    def constants(self):
        return [c.float() for c in self.consts]

    def code_rows(self, lo: int, hi: int) -> torch.Tensor:
        return eq1.encode(self.x[lo:hi], *self.consts, self.bits, self.fdt)

    def __call__(self, q: torch.Tensor):
        cfg = self.config
        k, metric = int(cfg["k"]), cfg["metric"]
        depth = int(cfg["rerank"]["depth"]) if cfg.get("rerank") else k
        qc = eq1.encode(q, *self.consts, self.bits, self.fdt)
        top = scan.TopD(q.shape[0], depth, self.dev)
        for start in range(0, self.x.shape[0], STEP):
            top.add(scan.int_scores(qc, self.code_rows(start, start + STEP),
                                    metric), start)
        s, i = top.result()
        if not cfg.get("rerank"):
            return s[:, :k].float(), i[:, :k].int()
        rows, qf = self.x[i], q.float()
        if self.tf32:
            rows, qf = tf32(rows), tf32(qf)
        rs = torch.bmm(rows, qf[:, :, None])[:, :, 0]
        order = torch.sort(rs, dim=1, descending=True, stable=True).indices[:, :k]
        return torch.gather(rs, 1, order), torch.gather(i, 1, order).int()

    def release(self) -> None:
        """Nothing to free before the judge: its corpus is its state."""
