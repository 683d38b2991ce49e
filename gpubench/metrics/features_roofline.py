"""The Gabor energies' least time over ``features_ms``, in %.

The work is the algorithm's at the cell's shapes (gpubench/yardstick.py:
the separable modulated blur, the smoothing and, where the clustering
reads the 2x2 twin, its pooled smoothing; the float32 colour read once,
the energies and the twin written once in the stored dtype). The compute
peak is the bf16 tensor cores' 989 TFLOP/s: the configuration stores
bf16 and the blur's operands are bf16, so a rewrite on the tensor cores
is faithful, and the fastest unit that can do the stage's arithmetic
bounds it. The memory peak is 3.35 TB/s."""

from gpubench import yardstick

SOURCES = ("gabor_energies.cu",)
PEAK = "bf16_tensor_flop_per_s"


def read(ctx):
    ms = ctx.kernel_ms(SOURCES)
    if not ms:
        return None
    cfg, tr = ctx.config, ctx.traffic
    h, w = tr["frame_hw"]
    cl = cfg["cluster"]
    twin = cl["method"] == "kmeans" and (cl["coarse_iters"] > 0 or cl["cue_weight"] == "coherence")
    flops, nbytes = yardstick.energies_counts(tr["batch"], h, w, 3, cfg["bank"], twin,
                                              cfg["dtype"])
    least, by = yardstick.least_seconds(flops, nbytes, yardstick.PEAKS[PEAK])
    share = 100.0 * 1e3 * least / ms
    ctx.log(f"features_roofline: {flops:.6g} operations, {nbytes:.6g} bytes, least "
            f"{1e3 * least:.4f} ms ({by}; {PEAK}) over {ms:.4f} ms = {share:.4f} % "
            f"({ctx.card['name']}, power limit {ctx.card['power_limit']})")
    return share
