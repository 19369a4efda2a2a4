"""Median host time inside ``Searcher.__call__`` (a harness span around
the call, no synchronise: the path waits on the card nowhere), in ms."""

import statistics


def read(ctx):
    calls = [r["host_call_s"] for r in ctx["window"]["requests"]]
    return statistics.median(calls) * 1e3 if calls else None
