"""Share of the window the batched runner's own loop did not cover: 1 -
the sum of ``run_sequences_batched``'s ``wall_seconds`` over the window,
in %. What is left is each job's set-up (initial state, first chunk's read
and upload), the uploader's start and the pose chaining on the host."""


def read(run):
    walls = [j.counters.get("runner_wall") for j in run.jobs]
    if any(w is None for w in walls):
        return None
    return (1.0 - sum(walls) / run.window_s) * 100.0
