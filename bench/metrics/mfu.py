"""mfu.<serve|batch>: the model FLOPs of every decode and chunk row the
window's steps ran (bench/work/model_flops.py, with the counts of the
configuration's family), over the window's seconds, as a share of the
card's bf16 peak (bench/peaks.json)."""
from bench.work.model_flops import step_flops


def read(run, name):
    peaks = run.peaks()
    steps = run.window_steps()
    if peaks is None or not steps:
        return None
    a, b = run.host_window
    fam, cfg = run.family, run.config
    flops = sum(step_flops(fam, cfg, s.tokens, s.ctx)
                + step_flops(fam, cfg, s.chunk_tokens, s.chunk_ctx)
                for s in steps)
    return 100.0 * flops / (b - a) / peaks["bf16_flops_per_s"]
