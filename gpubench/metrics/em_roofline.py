"""The EM's least time over ``em_ms``, in %.

The work is the EM passes' at the cell's shapes (gpubench/yardstick.py:
``n_iter`` passes with moments on the fit grid, the full-resolution
refine passes, one labels-only pass; the buffers read once, the labels
written once); the k-means init and the factorisations that ``em_ms``
also holds are not counted, so the share is a lower bound. The compute
peak is the bf16 tensor cores' 989 TFLOP/s, the fastest unit at the
configuration's stated precision (bf16 buffers); the memory peak is
3.35 TB/s."""

from gpubench import yardstick

SOURCES = ("maximin_t.cu", "lloyd_t.cu", "precision_chol.cu", "em_pass.cu", "common.cuh")
PEAK = "bf16_tensor_flop_per_s"


def read(ctx):
    ms = ctx.kernel_ms(SOURCES)
    if not ms:
        return None
    cfg, tr = ctx.config, ctx.traffic
    h, w = tr["frame_hw"]
    d = sum(n * 3 for n, _, _ in yardstick.bank_radii(cfg["bank"])) + 3
    flops, nbytes = yardstick.em_counts(tr["batch"], h, w, cfg["cluster"], d, cfg["dtype"])
    least, by = yardstick.least_seconds(flops, nbytes, yardstick.PEAKS[PEAK])
    share = 100.0 * 1e3 * least / ms
    ctx.log(f"em_roofline: {flops:.6g} operations, {nbytes:.6g} bytes, least "
            f"{1e3 * least:.4f} ms ({by}; {PEAK}) over {ms:.4f} ms = {share:.4f} % "
            f"({ctx.card['name']}, power limit {ctx.card['power_limit']})")
    return share
