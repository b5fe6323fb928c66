"""The device feature cache's build, in seconds (host clock with a
synchronise at both ends, in set-up)."""


def read(run):
    return run.counters.get("cache_build_s")
