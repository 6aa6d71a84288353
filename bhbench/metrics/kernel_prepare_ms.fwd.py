"""Mean milliseconds a frame spends before K1's launches (the program's
kernel.prepare spans in trace_rays_kernel: the null init and the depth
order's gather, for the prepass and the render), over the frames
(image.render spans) after the traced part of the window: host clock."""

from bhbench import spans


def read(run):
    return spans.per_root_ms(run, "image.render", {"kernel.prepare"})
