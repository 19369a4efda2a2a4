"""Where SchNet's large cells spend their time on one card
(``chip_smoke.py`` 15(d) and 15(e)'s graphs and shapes).

    python scripts/schnet_probe.py products
    python scripts/schnet_probe.py sampler <src> [<src> ...]

``products``: ogb_products at its real size (2,449,029 nodes, 61,859,140
edges, 300 RBFs, published widths): a warm-up train step, then one step
and one forward traced with ``torch.profiler``: the host clock, the
device's busy time (the sum of its kernels' times), kernels a call and
the kernels that take the most device time; then the step's time by
CUDA events at the default edge block and at half and double of it.

``sampler``: minibatch_lg's graph (232,965 nodes, 114,615,892 edges)
drawn on the card as 15(d) draws it, its ``NeighborSampler`` built once,
then ``sample`` of 1,024 seeds at fan-out (15, 10) timed on the host
clock with the ``data/graph_data.py`` of each ``src`` tree given (e.g.
the parent's, unpacked with ``git archive``), in turns A, B, B, A, five
samples a turn from one generator seed, medians printed.  Every tree's
sample is held equal to the first's.  Prints the card's name and power
limit.
"""

from __future__ import annotations

import importlib.util
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def _traced(label, fn):
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"[probe] {label}: host clock {wall:.1f} ms, device busy "
          f"{busy:.1f} ms ({busy / wall:.3f} of the wall), "
          f"{sum(e.count for e in rows)} kernels", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[probe]   {e.self_device_time_total / 1e3:9.1f} ms "
              f"{e.count:6d}x  {e.key[:100]}", flush=True)


def products() -> None:
    import torch

    import chip_smoke as C
    from repro_torch.configs import base, get
    from repro_torch.data import graph_data
    from repro_torch.launch import steps as ST
    from repro_torch.models.gnn import schnet as SN
    from repro_torch.train import OptConfig, adamw_init

    spec = base.GNN_SHAPES["ogb_products"]
    cfg = get("schnet").config("ogb_products")
    dev = torch.device("cuda")
    n = spec["n_nodes"]
    g = graph_data.random_graph(n, spec["n_edges"], spec["d_feat"],
                                torch.Generator(device=dev).manual_seed(8),
                                device=dev)
    batch = {"senders": g.senders, "receivers": g.receivers,
             "edge_mask": g.edge_mask, "node_feat": g.node_feat,
             "labels": torch.clamp(g.labels, 0, cfg.n_classes - 1)}
    params = C._to(SN.init_params(torch.Generator().manual_seed(3), cfg,
                                  device="cpu"), dev)
    step = ST.make_gnn_train_step(cfg, "full_graph", OptConfig(
        lr=1e-3, warmup_steps=0, schedule="const"), n)
    state = adamw_init(params)
    step(params, state, batch)                        # warm-up
    _traced("ogb_products train step", lambda: step(params, state, batch))
    with torch.no_grad():
        _traced("ogb_products forward", lambda: ST._schnet_node_loss(
            params, batch, cfg, n))
    block = SN.edge_block(cfg.n_rbf)
    for edges in (block, block // 2, block * 2):
        with C._rbf_block(edges, cfg.n_rbf):
            ms = [C._events(lambda: step(params, state, batch))[1]
                  for _ in range(2)]
        print(f"[probe] train step at blocks of {edges:,} edges "
              f"({-(-spec['n_edges'] // edges)} blocks): "
              f"{', '.join(f'{t:.1f}' for t in ms)} ms (CUDA events)",
              flush=True)


def _graph_data(src: str):
    path = Path(src) / "repro_torch" / "data" / "graph_data.py"
    spec = importlib.util.spec_from_file_location(f"gd_{abs(hash(src))}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod            # its dataclass looks itself up
    spec.loader.exec_module(mod)
    return mod


def sampler(srcs: list[str]) -> None:
    import numpy as np
    import torch

    from repro_torch.configs import base
    from repro_torch.data import graph_data

    spec = base.GNN_SHAPES["minibatch_lg"]
    dev = torch.device("cuda")
    g = graph_data.random_graph(
        spec["n_nodes"], spec["n_edges"], spec["d_feat"],
        torch.Generator(device=dev).manual_seed(6), device=dev)
    t0 = time.perf_counter()
    built = graph_data.NeighborSampler(g.senders.cpu().numpy(),
                                       g.receivers.cpu().numpy(),
                                       spec["n_nodes"])
    print(f"[probe] NeighborSampler built in {time.perf_counter() - t0:.2f} "
          "s (host)", flush=True)
    samplers = []
    for src in srcs:
        mod = _graph_data(src)
        s = object.__new__(mod.NeighborSampler)
        s.__dict__.update(built.__dict__)       # the build is the same code
        samplers.append((src, s))
    times = {src: [] for src in srcs}
    want = None
    order = samplers + samplers[::-1]
    for src, s in order:
        rng = np.random.default_rng(7)
        for _ in range(5):
            seeds = rng.integers(0, spec["n_nodes"], spec["batch_nodes"])
            t = time.perf_counter()
            nodes, layers = s.sample(seeds, spec["fanout"], rng)
            times[src].append((time.perf_counter() - t) * 1e3)
        got = (nodes, [x for la in layers for x in la])
        if want is None:
            want = got
        assert np.array_equal(got[0], want[0]) and all(
            np.array_equal(a, b) for a, b in zip(got[1], want[1])), src
    for src in srcs:
        print(f"[probe] sample (1,024 seeds, fan-out (15, 10)) with {src}: "
              f"median {statistics.median(times[src]):.1f} ms of "
              f"{len(times[src])} ({', '.join(f'{t:.1f}' for t in times[src])})",
              flush=True)


def main() -> int:
    import torch

    import chip_smoke as C

    print(f"[device] {torch.cuda.get_device_name(0)} | {C.smi()}", flush=True)
    if sys.argv[1:2] == ["products"]:
        products()
    elif sys.argv[1:2] == ["sampler"] and sys.argv[2:]:
        sampler(sys.argv[2:])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
