"""Share of the window's steps that the adaptive skip re-tracked at the
safe level, in %, from the batched runner's ``fallback_frames``."""


def read(run):
    falls = [j.counters.get("fallback_frames") for j in run.jobs]
    if any(f is None for f in falls):
        return None
    return sum(falls) / sum(j.steps for j in run.jobs) * 100.0
