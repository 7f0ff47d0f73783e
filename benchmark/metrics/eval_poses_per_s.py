"""eval_poses_per_s: held-out poses scored in the window over its seconds."""


def read(run):
    return run.values["poses"] / run.window_s
