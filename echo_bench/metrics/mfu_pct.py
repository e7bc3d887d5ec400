"""Model step: the FLOPs of the live tokens the runner computed in the
profiled sub-window (``roofline.prefill_call_flops`` and
``decode_call_flops``: the matrix products of the live rows, attention at
their contexts, the logits rows computed; no padding) over the
sub-window's seconds times the bf16 peak (989 TFLOP/s). Moves
``offline_tok_s``."""
from echo_bench import roofline


def read(run):
    if run.trace is None:
        return None
    flops = 0
    for kind, spans in run.trace.calls.items():
        for _, _, i in spans:
            c = run.calls[i]
            if kind == "eb.prefill":
                flops += roofline.prefill_call_flops(run.model, c.chunk, c.ctx[0])
            elif kind == "eb.decode":
                flops += roofline.decode_call_flops(run.model, c.ctx, run.engine["block_size"])
    if not flops:
        return None
    peak = roofline.PEAK_FLOPS[run.model["dtype"]]
    return 100.0 * flops / (run.trace.window_s * peak)
