"""attn_roofline.serve: the least time the attention of the traced window's
segments needs (each segment against its own valid keys, every layer; the
larger of its FLOPs at the dtype's peak and Q, K, V and O moved once at
the memory's) over the device time of the attention forward kernels in the
trace, in percent. Moves ``serve_frames_per_s``."""

from h100_bench import flops

KERNELS = ("flash_attn_fwd",)


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    spent = run.trace.kernel_seconds(KERNELS)
    if spent <= 0:
        return None
    need = 0.0
    for u in run.done():
        f = b = 0
        for t in u["segments"]:
            df, db = flops.attention_work(run.model, t, t, run.dtype)
            f, b = f + df, b + db
        need += flops.least_seconds(f, b, run.card, run.dtype)
    return 100.0 * need * run.model["encoder_layers"] / spent
