"""Kernels: the chunked-prefill attention kernel
(``csrc/chunked_prefill.cu``) against its roofline in the profiled
sub-window: the sum of each launch's bound (live rows only:
``roofline.prefill_attn_work`` at its call's chunk length and context)
over the sum of the launches' device time. Moves ``offline_tok_s``."""
from echo_bench import roofline

KERNEL = "chunked_prefill"


def read(run):
    if run.trace is None:
        return None
    bound = busy = 0.0
    for sec, (kind, i) in run.trace.kernel_calls(KERNEL):
        if kind != "eb.prefill":
            continue
        c = run.calls[i]
        nbytes, flops = roofline.prefill_attn_work(run.model, c.chunk, c.ctx[0])
        bound += roofline.bound_s(nbytes, flops, run.model["dtype"])
        busy += sec
    return 100.0 * bound / busy if busy > 0 else None
