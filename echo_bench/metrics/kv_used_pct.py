"""KV manager: the share of the page pool that holds KV (blocks running or
cached, online and offline) at the window's end, from
``BlockManager.usage_breakdown``. Moves ``offline_tok_s``: the fuller the
pool, the more evictions the KV manager's task-aware order decides, and
the more an offline prefix it drops has to be computed again."""
from echo_bench import stats


def read(run):
    end = run.occupancy.get("end")
    return stats.occupancy(end, run.num_blocks) if end and run.num_blocks else None
