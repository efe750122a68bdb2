"""attn_roofline.train: the least time the attention of the traced window's
micro-batches needs, forward and backward (each sequence against its own
valid keys, every layer; FLOPs at the dtype's peak or the bytes moved
once, whichever is larger, per kernel) over the device time of the
attention forward, dQ and dK/dV kernels in the trace, in percent. Moves
``train_frames_per_s``."""

from h100_bench import flops

KERNELS = ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    spent = run.trace.kernel_seconds(KERNELS)
    if spent <= 0:
        return None
    need = 0.0
    for u in run.done():
        for batch in u["segments"]:
            for backward in (False, True):
                f = b = 0
                for t in batch:
                    df, db = flops.attention_work(run.model, t, t,
                                                  run.dtype, backward)
                    f, b = f + df, b + db
                need += flops.least_seconds(f, b, run.card, run.dtype)
    return 100.0 * need * run.model["encoder_layers"] / spent
