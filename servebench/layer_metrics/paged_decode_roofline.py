"""paged_decode_roofline (kernels, ``csrc/paged_attention.cu`` via
``ops/paged_attention.py``): the decode kernel's bound over its device time
in the traced stretch, in percent. The bound is counted from the tokens
the traced steps made: token ``j`` of a request attends ``prompt + j``
keys (``work.decode``)."""

from servebench import stats, trace, work

KERNELS = ("paged_decode_kernel",)


def read(run, name):
    if run.trace is None:
        return None
    seconds = trace.kernel_seconds(run.trace.kernel_s, KERNELS)
    flops = nbytes = 0
    for rec in run.recs:
        for ctx in stats.decode_contexts(run, rec, "trace_start", "trace_end"):
            f, b = work.decode(run.dims, ctx)
            flops, nbytes = flops + f, nbytes + b
    if not seconds or not flops:
        return None
    return 100.0 * work.bound_s(flops, nbytes) / seconds
