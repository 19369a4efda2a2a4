"""Device bytes the built index holds over its rows: the allocator's
bytes once the harness has dropped its own corpus, less what the harness
still holds (the query pool)."""


def read(ctx):
    b = ctx["memory"].get("index_bytes")
    return b / int(ctx["config"]["rows"]) if b else None
