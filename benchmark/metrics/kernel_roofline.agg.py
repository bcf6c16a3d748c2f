"""kernel_roofline.agg: the least time the window's verify work could take
on the card, over the device's busy time in those calls, in %.

The work of a call with n signature sets and K keys in all is counted as
a*K + b*n + c modular products of 381-bit numbers (``roofline_work.json``:
the constants fitted once to the program's kernel launches at the cells'
shapes, with padded counts; here real counts, so padding is waste), each
priced at the 51 x 51 digit convolution's int32 operations, beside the
bytes the call must read (each key's limbs once). Least time is the larger
of operations over the int32 peak and bytes over the memory rate. Only
calls that started and ended in the window count, with the device time
inside their spans."""

from benchmark.harness.readings import calls_inside, roofline_work


def read(ctx):
    if ctx.trace is None:
        return None
    calls = calls_inside(ctx)
    if not calls:
        return None
    rw = roofline_work()
    a, b, c = rw["products"]["a"], rw["products"]["b"], rw["products"]["c"]
    products = sum(a * k + b * n + c for _, _, n, k, _, _ in calls)
    n_bytes = sum(rw["bytes_per_key"] * k + rw["bytes_per_set"] * n for _, _, n, k, _, _ in calls)
    least = max(products * rw["int32_ops_per_product"] / rw["peak_int32_ops_per_s"],
                n_bytes / rw["peak_bytes_per_s"])
    spans = [(s, e) for s, e, *_ in calls]
    busy = 0.0
    j = 0
    for a0, b0 in ctx.trace.busy_intervals():
        while j < len(spans) and spans[j][1] <= a0:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < b0:
            busy += max(0.0, min(b0, spans[k][1]) - max(a0, spans[k][0]))
            k += 1
    return 100.0 * least / busy if busy > 0 else None
