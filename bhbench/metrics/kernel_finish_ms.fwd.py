"""Mean milliseconds a frame spends after K1's launches (the program's
kernel.finish spans in trace_rays_kernel: the conserved L, the capture
margin and postprocess's shading, for the prepass and the render), over
the frames after the traced part of the window: host clock."""

from bhbench import spans


def read(run):
    return spans.per_root_ms(run, "image.render", {"kernel.finish"})
