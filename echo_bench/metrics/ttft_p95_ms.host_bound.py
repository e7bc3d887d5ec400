"""Engine and scheduler, as an online user meets them in a cell whose card
idles over half its time (the host paces the tails, so they stand here and
not among the end-to-end metrics): the p95, over every online request due in
the window, of the time from its due time to its first token; one with no
first token by the drain's end counts at the drain's end. Moves
``offline_tok_s``: the host time that delays online requests is the host
time offline work waits for."""
from echo_bench import stats


def read(run):
    ttft, _ = run.ttfts()
    return 1e3 * stats.quantile(ttft, 0.95) if ttft else None
