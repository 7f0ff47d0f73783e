"""adam_step_ms.map: the port's span map.step (one Adam iteration of
models/slam.py _mapping_phase_impl: the renders and loss, the autograd
backward, adam_step), its mean host milliseconds after the traced
stretch."""
from harness.spans import mean_span_ms


def read(run):
    return mean_span_ms(run, "map.step")
