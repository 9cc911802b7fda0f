"""Plain references, one file per model family, found by the ``family`` of
a configuration file. Each imports nothing of the program and takes the
configuration file's keys, the weights the benchmark made, and token ids."""
