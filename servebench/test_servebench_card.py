"""On the card: the trace reads device time, and an annotation's device-side
copy is not counted as an operation. Skips without a CUDA device."""

import time

import pytest
import torch

from servebench.trace import STEP_ANNOTATION, Trace


@pytest.mark.cuda
@pytest.mark.parametrize("host", [False, True])
def test_trace_reads_device_time(card, host):
    x = torch.randn(2048, 2048, device=card)
    x @ x
    tr = Trace(host=host)
    tr.start()
    for _ in range(3):
        with torch.profiler.record_function(STEP_ANNOTATION):
            for _ in range(20):
                x = torch.tanh(x @ x)
        torch.cuda.synchronize()
        time.sleep(0.01)  # the device idles while the host sleeps
    tr.stop()
    assert 0 < tr.busy_s < tr.window_s
    assert STEP_ANNOTATION not in tr.kernel_s
    assert sum(tr.kernel_s.values()) >= tr.busy_s * 0.99
    assert tr.device_ops and bool(tr.idle_gaps) == host
