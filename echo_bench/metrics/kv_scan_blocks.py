"""KV manager: blocks the whole-pool walks visited per engine step in the
window (the change of ``BlockManagerMetrics.scanned_blocks`` over the
window's iterations). Every walk visits the whole pool, 40,704 blocks in
yi-9b, in Python on the host while the card waits. Moves
``offline_tok_s``."""


def read(run):
    start, end = run.counters.get("start"), run.counters.get("end")
    if not start or not end or "scanned_blocks" not in end or not run.iterations:
        return None
    return (end["scanned_blocks"] - start["scanned_blocks"]) / len(run.iterations)
