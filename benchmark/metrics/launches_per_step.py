"""launches_per_step: kernels the profiler saw on the card in the traced
stretch over the episode steps in it."""


def read(run):
    s, steps = run.trace_summary, run.values.get("traced_steps")
    if not s or not steps:
        return None
    return len([k for k in s["kernels"]
                if s["lo"] <= k[0] <= s["hi"]]) / steps
