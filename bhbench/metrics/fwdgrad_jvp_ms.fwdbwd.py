"""Mean milliseconds a gradient step spends in the per-tangent jvps of
the host stages (the program's fwdgrad.jvp spans: the null init's in
prepare_fwdgrad, the shading's in its finish), over the steps
(grad.value_and_grad spans) after the traced part of the window, which
the profiler slows: host clock."""

from bhbench import spans


def read(run):
    return spans.per_root_ms(run, "grad.value_and_grad", {"fwdgrad.jvp"})
