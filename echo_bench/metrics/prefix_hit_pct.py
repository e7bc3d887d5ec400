"""KV manager: the share of offline prompt blocks looked up in the window
that the prefix cache held (the change of ``BlockManagerMetrics``'
``offline_hit_blocks`` over that of ``offline_lookup_blocks``). Moves
``offline_tok_s``: a hit is prompt progress with no compute."""


def read(run):
    start, end = run.counters.get("start"), run.counters.get("end")
    if not start or not end:
        return None
    looked = end["offline_lookup_blocks"] - start["offline_lookup_blocks"]
    hit = end["offline_hit_blocks"] - start["offline_hit_blocks"]
    return 100.0 * hit / looked if looked else None
