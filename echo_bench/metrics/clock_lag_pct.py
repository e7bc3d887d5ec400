"""Engine + scheduler: how far the engine's clock (``engine.now``, on
``clock="wall"`` the sum of the runner windows and swap launches) falls
behind the wall clock between the ends of the window's first and last
steps: 100 x (1 - change of ``now`` / change of wall time), from the port's
host track (``run.spans``). The SLO gate judges ``now``. Moves
``offline_tok_s``."""


def read(run):
    steps = sorted((s for s in getattr(run, "spans", None) or () if s.name == "step"),
                   key=lambda s: s.t1)
    if len(steps) < 2 or steps[-1].t1 == steps[0].t1:
        return None
    d_now = steps[-1].args["now"] - steps[0].args["now"]
    return 100.0 * (1.0 - d_now / ((steps[-1].t1 - steps[0].t1) / 1e9))
