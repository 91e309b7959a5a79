"""Check ``film``: the film holds exactly the samples that the harness
asked of the program (the spp of each progression run, warm-up
included), each of box-filter weight one.  One number,
``film_weight_gap``: the gap between the film's total weight and the
samples asked, over the samples asked, an exact comparison (limit 0).
The total and not each pixel: a sample whose jitter rounds up to the next
pixel's edge in float32 lands in that pixel.  A count has no lower
precision to serve as a control: the control reads what the program
reads."""


def readings(ctx, out, params, control=False):
    w = out["film_weight"].double()
    expected = out["expected_weight"] * w.shape[0]
    return {"film_weight_gap": float(abs(float(w.sum()) - expected) / expected)}
