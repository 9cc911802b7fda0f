"""prefix_hit_rate: prompt tokens served from the prefix cache
(kv/prefix_cache.py) over the prompt tokens looked up there, that is
admitted, in the window: the change of the cache's ``hit_tokens`` and
``lookup_tokens`` between the window's open and its close. Nothing to
read with the cache off or no admission in the window."""


def read(run, name):
    if run.prefix_stats is None or run.prefix_stats[0] is None:
        return None
    a, b = run.prefix_stats
    looked = b["lookup_tokens"] - a["lookup_tokens"]
    if looked <= 0:
        return None
    return (b["hit_tokens"] - a["hit_tokens"]) / looked
