"""launches_per_set.agg: launches of the program's hand kernels
(``lighthouse_tpu_torch.ops.bls.fused_mul.launches``) during the window,
over the signature sets answered in it: the host dispatch a set costs."""

from benchmark.harness.readings import sets_answered


def read(ctx):
    n = sets_answered(ctx)
    return ctx.launches / n if ctx.launches is not None and n else None
