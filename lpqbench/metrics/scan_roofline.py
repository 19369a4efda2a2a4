"""The request's least time on the card (``roofline.request_work``: the
codes once, queries, results, the rerank's gathered rows; operations at
their peaks) over the device's busy time per request, in %: the scan
kernel and, for ``+r32``, the rerank tail.  Counted from the request's
work, not from kernel names, so a kernel that replaces another is read on
the same yardstick."""

from lpqbench import roofline


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["busy_s"] <= 0:
        return None
    least = sum(roofline.least_seconds(roofline.request_work(ctx["config"],
                                                             r["size"]))
                for r in ctx["window"]["requests"])
    return 100.0 * least / tr["busy_s"]
