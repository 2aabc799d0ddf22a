"""paged_prefill_roofline (kernels, ``csrc/paged_prefill.cu`` via
``ops/paged_attention.py``, its merge pass included): the chunked prefill
kernel's bound over its device time in the traced stretch, in percent. The
bound is counted from the chunked admissions the traced steps made: every
real prompt token but the last (which the first decode step feeds), in
chunks of the server's ``prefill_chunk`` (``work.paged_prefill``)."""

from servebench import stats, trace, work

KERNELS = ("paged_prefill_kernel", "prefill_wgmma_kernel", "split_merge_kernel")


def read(run, name):
    if run.trace is None:
        return None
    seconds = trace.kernel_seconds(run.trace.kernel_s, KERNELS)
    chunk = int(run.server["prefill_chunk"])
    flops = nbytes = 0
    for rec in stats.admitted(run, *run.trace_t):
        if stats.chunked(run, rec):
            f, b = work.paged_prefill(run.dims, rec.plen - 1, chunk)
            flops, nbytes = flops + f, nbytes + b
    if not seconds or not flops:
        return None
    return 100.0 * work.bound_s(flops, nbytes) / seconds
