"""k1_roofline.<serve|batch>: K1's work over the traced slice
(bench/work/kv_bytes.py: each K/V page the decode rows attend once, plus
their q and outputs, in the layers that hold K/V) over the device time
of K1's kernels in the slice, as a share of the card's HBM bandwidth
(bench/peaks.json). Nothing to read where K1 did not run."""
from bench.work.kv_bytes import decode_bytes


def roofline(run, kernel: str):
    peaks = run.peaks()
    if run.trace is None or peaks is None:
        return None
    seconds, launches = run.trace.kernel_s(kernel)
    if not launches or seconds <= 0:
        return None
    ps = run.workload["engine"]["page_size"]
    work = sum(decode_bytes(run.family, run.config, s.tables, ps)
               for s in run.steps if s.traced)
    return 100.0 * work / seconds / peaks["hbm_bytes_per_s"]


def read(run, name):
    return roofline(run, "k1")
