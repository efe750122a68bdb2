"""Hubconf-style entry points, port of
``speech_ssl_compression_tpu/s3prl/hubconf.py`` (reference
s3prl_upstream/hubconf.py:11-83): one factory per mode x frame period x
dataset hours, each returning an :class:`UpstreamExpert` from a local
checkpoint path. The mean-std stats default to the repository's
``example/libri-{hours}-mean-std.npy``; ``mean_std_npy_path=`` overrides
them, and ``device=`` (cuda by default) picks the device.
"""

import os
import pathlib

from .expert import UpstreamExpert as _UpstreamExpert

_EXAMPLE = pathlib.Path(__file__).resolve().parents[2] / "example"


def _default_mean_std(hours: int) -> str:
    return str(_EXAMPLE / f"libri-{hours}-mean-std.npy")


def _make(mode, fp, hours):
    def factory(ckpt, *, mean_std_npy_path=None, **kwargs):
        if not os.path.isfile(ckpt):
            raise FileNotFoundError(f"no checkpoint at {ckpt!r}")
        return _UpstreamExpert(
            ckpt,
            mode=mode,
            fp=fp,
            mean_std_npy_path=mean_std_npy_path or _default_mean_std(hours),
            **kwargs,
        )

    factory.__name__ = f"compression_{fp}ms_{mode.replace('-', '_')}_{hours}hours_local"
    factory.__doc__ = f"The model from a local ckpt ({mode}, {fp} ms, {hours} h)."
    return factory


compression_20ms_weight_pruning_960hours_local = _make("weight-pruning", 20, 960)
compression_10ms_weight_pruning_960hours_local = _make("weight-pruning", 10, 960)
compression_20ms_head_pruning_960hours_local = _make("head-pruning", 20, 960)
compression_10ms_head_pruning_960hours_local = _make("head-pruning", 10, 960)
compression_20ms_row_pruning_960hours_local = _make("row-pruning", 20, 960)
compression_10ms_row_pruning_960hours_local = _make("row-pruning", 10, 960)
compression_20ms_distillation_960hours_local = _make("distillation", 20, 960)
compression_10ms_distillation_960hours_local = _make("distillation", 10, 960)
compression_20ms_melhubert_960hours_local = _make("melhubert", 20, 960)
compression_10ms_melhubert_960hours_local = _make("melhubert", 10, 960)
# 360-hour variants (reference :67-83)
compression_20ms_row_pruning_local = _make("row-pruning", 20, 360)
compression_10ms_row_pruning_local = _make("row-pruning", 10, 360)
compression_20ms_melhubert_local = _make("melhubert", 20, 360)
compression_10ms_melhubert_local = _make("melhubert", 10, 360)
