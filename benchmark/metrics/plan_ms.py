"""plan_ms: the window's milliseconds over the planning events completed in
it: what the agent waits per replan."""


def read(run):
    return run.window_s * 1e3 / run.values["events"]
