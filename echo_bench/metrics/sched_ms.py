"""Engine + scheduler: mean wall milliseconds ``Scheduler.schedule`` took
an iteration in the window (``IterationDetail.schedule_wall``, measured
by the engine around the call, read by a listener's ``on_iteration``).
Moves ``offline_tok_s``: every iteration schedules before it runs, and
while it does the card waits."""


def read(run):
    waits = [s for _, s in run.iterations]
    return 1e3 * sum(waits) / len(waits) if waits else None
