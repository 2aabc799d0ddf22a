"""device_idle (the H100): the share of the traced stretch in which no
operation ran on the device (one minus the union of the device events'
intervals over its length), in percent."""


def read(run, name):
    if run.trace is None or not run.trace.window_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
