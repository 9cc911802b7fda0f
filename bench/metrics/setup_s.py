"""setup_s: seconds from the start of the process to the window's opening:
imports, the weights made on the device, the KV pool, the step graphs'
capture (and the kernels' build in a checkout's first run), and the
traffic's warm-up to steady occupancy."""


def read(run, name):
    return run.setup_s
