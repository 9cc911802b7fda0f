"""tokens_per_s: every branch token sampled in the window, over the
window's seconds."""


def read(run, name):
    a, b = run.window
    return run.tokens_in_window() / (b - a)
