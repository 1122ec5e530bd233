"""The served dispatches' share of the card's peak in the served
precision (float32: three TF32 products on the tensor cores): the model's
operations of the samples the march keeps for the requests answered in
the traced stretch (each the family's ``sample_flops``), over the
device's busy time in the stretch. At a fixed offered rate the window's
operations are the offered work; over the busy time they are not, and
unlike K5's roofline this share still reads when another kernel serves
the route."""

from counts.peaks import compute_peak


def read(ctx):
    busy = ctx.trace["busy_s"]
    if busy <= 0.0 or ctx.samples <= 0:
        return None
    row = ctx.cell.family.sample_flops(ctx.spec)
    return 100.0 * ctx.samples * row / busy \
        / compute_peak(ctx.serve["compute_dtype"])
