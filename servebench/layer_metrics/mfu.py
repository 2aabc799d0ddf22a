"""mfu (model step, ``parallel/serve.py``, ``models/llama.py``): the model's
useful operations inside the window (``stats.useful_flops``: weights'
products of every real token, visible attention pairs, the head once per
token made; no padding) over the window's seconds at the card's bf16 peak,
in percent."""

from servebench import stats, work


def read(run, name):
    flops = stats.useful_flops(run, "open", "close", run.t_open, run.t_close)
    return 100.0 * flops / (run.window_s * work.PEAK_FLOPS_BF16)
