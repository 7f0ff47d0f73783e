"""render_pose_ms.eval: the port's span render.pose (one pose's render in
models/slam.py _render_pose_batch), its mean host milliseconds over the
evaluation chunks after the traced ones."""
from harness.spans import mean_span_ms


def read(run):
    return mean_span_ms(run, "render.pose")
