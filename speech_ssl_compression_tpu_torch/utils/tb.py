"""TensorBoard scalar logging shared by both trainers: a copy of
``speech_ssl_compression_tpu/utils/tb.py``.

The reference logs sample-size-normalized loss and grad-norm through
tensorboardX (reference runner.py:42,430-446) under tags such as
``weight-pruning/train-loss``. tensorboardX is optional: without it the
logger is a no-op, so training never depends on an observability package.
"""

from __future__ import annotations


class TBLogger:
    def __init__(self, logdir):
        # logdir=None -> disabled
        if logdir is None:
            self._writer = None
            return
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            # optional dependency: degrade silently
            self._writer = None
            return
        try:
            self._writer = SummaryWriter(logdir)
        except Exception as e:  # unwritable logdir etc. - degrade LOUDLY
            print(f"[TBLogger] WARNING: TensorBoard logging disabled "
                  f"({type(e).__name__}: {e})")
            self._writer = None

    def scalar(self, tag: str, value, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), global_step=step)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
