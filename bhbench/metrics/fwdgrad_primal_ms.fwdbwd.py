"""Mean milliseconds a gradient step spends in the primal's own host
stages: the self time of the program's fwdgrad.prepare and
fwdgrad.finish spans (the null init and the shading, less their
per-tangent jvps), over the steps after the traced part: host clock."""

from bhbench import spans


def read(run):
    return spans.per_root_ms(run, "grad.value_and_grad",
                             {"fwdgrad.prepare", "fwdgrad.finish"}, own=True)
