"""Percent of the gradient steps (grad.value_and_grad spans) after the
traced part of the window whose fwdgrad.prepare and fwdgrad.finish both
hold a fwdgrad.replay span: the steps whose host stages replayed their
CUDA graphs instead of issuing each op.  None for a program that keeps
no such graphs (no fwdgrad_replays counter in its trace_kernel)."""

from bhbench import spans

STAGES = ("fwdgrad.prepare", "fwdgrad.finish")


def read(run):
    prof = spans.ring()
    if prof is None or run.trace is None or not _graphed():
        return None
    records = prof.spans()
    roots = spans.untraced_roots(records, "grad.value_and_grad")
    if not roots:
        return None
    by_id = {r.id: r for r in records}
    replayed = {by_id[r.parent].id for r in records
                if r.name == "fwdgrad.replay" and r.parent in by_id
                and by_id[r.parent].name in STAGES}
    stages = {}
    for r in records:
        if r.name in STAGES and r.parent is not None:
            stages.setdefault(r.parent, []).append(r.id)
    full = sum(1 for root in roots
               if len(stages.get(root.id, ())) == len(STAGES)
               and all(s in replayed for s in stages[root.id]))
    return 100.0 * full / len(roots)


def _graphed():
    try:
        from blackhole_tpu_torch.render import trace_kernel
    except ImportError:
        return False
    return hasattr(trace_kernel, "fwdgrad_replays")
