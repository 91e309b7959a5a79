"""Check ``image``: the program's image against the reference path
tracer's, as the means of a grid of blocks of pixels.  The reference
renders ``passes`` passes of one sample a pixel with its own random
numbers.  One number, ``image_gap``: the widest gap of a block's mean
(summed over the channels), over the reference's block mean plus a tenth
of the mean over all blocks.  It leaves the reference's closest-hit
queries a path in ``ctx.work["queries_per_path"]``, the work count of the
fused kernel's roofline."""
import torch

from pgbench.reference.pathtracer import render_blocks


def block_means(img, width, height, blocks):
    by, bx = blocks
    img = img.reshape(height, width, 3).double()
    return img.reshape(by, height // by, bx, width // bx, 3).mean(dim=(1, 3))


def readings(ctx, out, params, control=False):
    blocks = tuple(params["blocks"])
    args = dict(width=ctx.width, height=ctx.height, blocks=blocks, passes=int(params["passes"]),
                max_depth=ctx.cell.config["max_depth"], device=ctx.device)
    ref, ctx.work["queries_per_path"] = render_blocks(ctx.compiled, seed=ctx.seed ^ 0x5EED,
                                                      dtype=torch.float32, **args)
    if control:
        prog, _ = render_blocks(ctx.compiled, seed=ctx.seed ^ 0xC0DE, dtype=torch.bfloat16, **args)
    else:
        prog = block_means(out["image"].to(ctx.device), ctx.width, ctx.height, blocks)
    p, r = prog.sum(-1), ref.sum(-1)
    return {"image_gap": float(((p - r).abs() / (r + 0.1 * r.mean())).max())}
