"""Host layouts built a fused RK4 launch: the port's counter
``fused_rk4.layout_builds`` over ``launches + launches_streamed``, both
since the process started (1.0 while every launch builds its layout; a
layout cache would take it toward 0).  Read in a traced run that
launched a kernel."""

UNIT = "builds/launch"


def read(r):
    from qgs_tpu_torch.ops import fused_rk4
    from qgs_tpu_torch.utils import profiling
    builds = getattr(fused_rk4, "layout_builds", None)
    launches = fused_rk4.launches + fused_rk4.launches_streamed
    totals = getattr(profiling, "span_totals", lambda: {})()
    if (r.trace is None or builds is None or launches == 0
            or "qgs.layout" not in totals):
        return None
    return builds / launches
