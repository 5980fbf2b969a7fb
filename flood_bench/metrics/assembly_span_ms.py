"""Face values into the simplex tree and the monotone repair a cloud with
no fences: the program's ``dim*:assembly`` and ``monotonicity`` spans in
the profiled clouds."""

from fbench.records import stage_ms


def read(ctx):
    return stage_ms(ctx, lambda k: k.endswith(":assembly")
                    or k == "monotonicity")
