"""Kernels: the split-K paged decode kernel
(``csrc/paged_attention_splitk.cu``) against its roofline in the profiled
sub-window: the sum of each launch's bound (live rows and their contexts
only: ``roofline.decode_attn_work``) over the sum of the launches' device
time. Moves ``offline_tok_s`` (the decode call is part of every step)."""
from echo_bench import roofline

KERNEL = "splitk"


def read(run):
    if run.trace is None:
        return None
    bound = busy = 0.0
    for sec, (kind, i) in run.trace.kernel_calls(KERNEL):
        if kind != "eb.decode":
            continue
        nbytes, flops = roofline.decode_attn_work(run.model, run.calls[i].ctx,
                                                  run.engine["block_size"])
        bound += roofline.bound_s(nbytes, flops, run.model["dtype"])
        busy += sec
    return 100.0 * bound / busy if busy > 0 else None
