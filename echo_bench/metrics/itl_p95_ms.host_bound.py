"""Engine and scheduler, as an online user meets them in a cell whose card
idles over half its time: the p95 of every gap between consecutive online
tokens whose later token lands in the window (a gap is one engine step,
its decode call and the offline chunks beside it). Moves ``offline_tok_s``:
the chunks that lengthen a gap are the offline progress."""
from echo_bench import stats


def read(run):
    itl = run.itls()
    return 1e3 * stats.quantile(itl, 0.95) if itl else None
