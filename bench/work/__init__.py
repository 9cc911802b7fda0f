"""The yardstick's arithmetic: the operations and bytes the work of a step
or a kernel needs, from the configuration's shapes alone."""
