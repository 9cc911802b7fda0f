"""k3_roofline.<serve>: K3's work over the traced slice, the same bytes as
``k1_roofline`` (bench/work/kv_bytes.py: each K/V page the decode rows
attend once, a prompt page that siblings or requests share counted once,
plus their q and outputs) over the device time of both of K3's passes
(its shared pass and its branch pass), as a share of the card's HBM
bandwidth. Nothing to read where K3 did not run."""
from bench.metrics.k1_roofline import roofline


def read(run, name):
    return roofline(run, "k3")
