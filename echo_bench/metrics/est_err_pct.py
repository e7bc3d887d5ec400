"""Engine + scheduler: the median, over the window's steps that called the
runner, of the scheduler's estimate's error: |``predicted_us`` - the
step's runner spans| / its runner spans x 100, from the port's host track
(``run.spans``). ``hostspans.estimate_errors`` gives the signed errors.
Moves ``offline_tok_s``: the estimate decides what a step admits."""
from echo_bench import stats
from echo_bench.hostspans import estimate_errors


def read(run):
    errs = estimate_errors(getattr(run, "spans", None) or ())
    return 100.0 * stats.quantile([abs(e) for e in errs], 0.5) if errs else None
