"""Engine and scheduler, in a cell whose end-to-end metric is
``itl_p95_ms``: the offline progress in the window over its seconds (as
``offline_tok_s``: a prompt token once its KV is in place, computed or a
prefix hit; an output token when emitted). Here it spreads too widely to
hold a bound, so it stands beside the tail it pays for: the offline chunks
run beside each decode call lengthen an online token's gap."""
from echo_bench import stats


def read(run):
    if run.window[1] <= run.window[0]:
        return None
    return stats.rate(run.offline_progress, run.window)
