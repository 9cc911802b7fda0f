"""device_idle.<serve|batch>: the share of the traced slice in which no
operation ran on the device (1 - the union of its operations' intervals
over the slice's length)."""


def read(run, name):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
