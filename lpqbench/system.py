"""The system under test: ``repro_torch``'s index behind its Searcher, built
the way a user builds it (``make_index`` on the configuration's factory
string, then ``index.searcher(k, batch_sizes=...)``).  The window calls
``Program.__call__`` only, which is ``Searcher.__call__``.
"""

from __future__ import annotations

import torch

#: the Searcher's planned batch sizes: a request is padded up to the next
#: one, and one over the largest is split into pieces of it
BUCKETS = (1, 8, 32, 256)


class Program:
    def __init__(self, config: dict, corpus: torch.Tensor, dev):
        from repro_torch.knn import make_index

        self.index = make_index(config["factory"], corpus,
                                metric=config["metric"], device=dev)
        self.searcher = self.index.searcher(int(config["k"]),
                                            batch_sizes=BUCKETS)
        store = self.index.store
        q = config["quant"]
        want = (int(q["bits"]), q["scheme"],
                int(config["rerank"]["depth"]) if config.get("rerank") else None)
        rr = self.searcher.rerank
        got = (store.bits, store.params.scheme,
               rr.depth if rr is not None else None)
        if got != want:
            raise ValueError(f"the built index is {got}, its configuration "
                             f"states {want}")
        self._params, self._codes = store.params, store.data
        self._packed, self.d = store.packed, store.d

    def __call__(self, q: torch.Tensor):
        res = self.searcher(q)
        return res.scores, res.ids

    def constants(self):
        p = self._params
        return [p.lo, p.hi, p.zero]

    def code_rows(self, lo: int, hi: int) -> torch.Tensor:
        """Stored codes of rows [lo, hi) as int8 values, [r, d]; packed int4
        rows hold dim 2t in the low nibble and 2t + 1 in the high one, each
        as value + 8."""
        rows = self._codes[lo:hi]
        if not self._packed:
            return rows
        u = rows.to(torch.int16)
        out = torch.stack([(u & 0x0F) - 8, ((u >> 4) & 0x0F) - 8], dim=-1)
        return out.reshape(rows.shape[0], -1)[:, : self.d].to(torch.int8)

    def release(self) -> None:
        """Drop the index and the Searcher; keep what the judge reads."""
        del self.searcher, self.index
