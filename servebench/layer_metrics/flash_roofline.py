"""flash_roofline (kernels, ``csrc/flash_attention.cu`` via
``ops/flash_attention.py``): the flash kernel's bound over its device time
in the traced stretch, in percent. The bound is counted from the one-shot
admissions the traced steps made: each prompt's real tokens, causal
(``work.flash``)."""

from servebench import stats, trace, work

KERNELS = ("flash_wgmma_kernel", "flash_f32_kernel")


def read(run, name):
    if run.trace is None:
        return None
    seconds = trace.kernel_seconds(run.trace.kernel_s, KERNELS)
    flops = nbytes = 0
    for rec in stats.admitted(run, *run.trace_t):
        if not stats.chunked(run, rec):
            f, b = work.flash(run.dims, rec.plen)
            flops, nbytes = flops + f, nbytes + b
    if not seconds or not flops:
        return None
    return 100.0 * work.bound_s(flops, nbytes) / seconds
