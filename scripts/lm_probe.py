"""Where an LM serving step's time goes on one card: gemma2-9b at full
width and depth in bf16 (``chip_smoke.py`` 14(c)'s model and shapes).

    python scripts/lm_probe.py [--batch 4] [--prompt 4608]

Prefills B x S tokens, then times decode steps on the bf16 cache and on
the int8 cache (CUDA events, median of 5 after 2 warm-ups), and traces
one prefill and three steps of each with ``torch.profiler``: the device's
busy time (the sum of its kernels' times) against the host clock, the
kernels a step, and the kernels that take the most device time.  Prints
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def _traced(label, fn, n: int):
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    rows = [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in rows) / 1e3 / n
    kernels = sum(e.count for e in rows) / n
    print(f"[probe] {label}: host clock {wall:.3f} ms, device busy "
          f"{busy:.3f} ms ({busy / wall:.3f} of the wall), {kernels:.0f} "
          f"kernels a call", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[probe]   {e.self_device_time_total / 1e3 / n:9.3f} ms "
              f"{e.count / n:7.1f}x  {e.key[:90]}", flush=True)


def main() -> int:
    import torch

    import chip_smoke as C
    from repro_torch.data import lm_data
    from repro_torch.models import transformer as TF
    from repro_torch.quantized import qkv_cache as QC

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=4608)
    a = ap.parse_args()
    print(f"[device] {torch.cuda.get_device_name(0)} | {C.smi()}", flush=True)
    cfg = C._lm_cfg("gemma2-9b")
    dev = torch.device("cuda")
    params = TF.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                            device=dev)
    B, S, steps = a.batch, a.prompt, 16
    toks = lm_data.lm_batch(torch.Generator(device=dev).manual_seed(1), B, S,
                            cfg.vocab, device=dev)["tokens"]
    lg, kv = TF.prefill(params, toks, cfg)
    kc, vc = TF.make_cache(cfg, B, S + steps, device=dev)
    TF.write_prefix(kc, kv[0])
    TF.write_prefix(vc, kv[1])
    qc = QC.quantize_cache(kv[0], kv[1], S + steps)
    del kv
    tok = lg.argmax(-1)[:, None]
    pos = [S]

    def fp():
        TF.decode_step(params, (kc, vc), tok, pos[0], cfg)

    def q8():
        QC.decode_step_q8(params, qc, tok, pos[0], cfg)

    for label, fn in (("decode, bf16 cache", fp), ("decode, int8 cache", q8)):
        ms = []
        for _ in range(7):
            ms.append(C._events(fn)[1])
        print(f"[probe] {label}: {statistics.median(ms[2:]):.3f} ms a step "
              f"(CUDA events, median of 5)", flush=True)
        _traced(label, fn, 3)
    _traced(f"prefill B={B} x S={S}", lambda: TF.prefill(params, toks, cfg),
            1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
