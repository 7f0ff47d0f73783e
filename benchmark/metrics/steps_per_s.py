"""steps_per_s: episode steps completed in the window over its seconds."""


def read(run):
    return run.values["steps"] / run.window_s
