"""CUDA kernels the trace holds in the window over the requests served:
the index's and the engine's launches a request (every torch op's kernel
too, which the port's own launch counters miss)."""


def read(ctx):
    tr = ctx["trace"]
    reqs = ctx["window"]["requests"]
    if not tr or not reqs:
        return None
    return tr["kernels"] / len(reqs)
