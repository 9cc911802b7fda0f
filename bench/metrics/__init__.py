"""One reader per metric, found by the metric's name (or its name up to
the first dot): ``read(run, name)`` returns the number, or None where the
run holds nothing for it to read."""
