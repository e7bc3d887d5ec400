"""KV manager: chain hashes the block manager computed per engine step in
the window (the change of ``BlockManagerMetrics.hashed_blocks`` over the
window's iterations): prefix lookups at allocation, and each commit's walk
of its request's full blocks from the first. Moves ``offline_tok_s``."""


def read(run):
    start, end = run.counters.get("start"), run.counters.get("end")
    if not start or not end or "hashed_blocks" not in end or not run.iterations:
        return None
    return (end["hashed_blocks"] - start["hashed_blocks"]) / len(run.iterations)
