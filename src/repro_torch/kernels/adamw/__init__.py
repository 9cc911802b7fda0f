"""AdamW's update of one leaf in one fused pass (not a TPU kernel: it
stands in for what XLA fuses inside the reference's jitted update):
``ops.adamw_leaf`` dispatches."""
