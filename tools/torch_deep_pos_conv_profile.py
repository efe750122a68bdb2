"""Profile forward_packed from features of MelHuBERT-20ms with the deep
pos-conv (5 x k = 19) and with the depth-1 pos-conv (k = 128), f32 and
bf16, on one card: device busy time and the largest device kernels.
Builds the kernels first. Run from the repository's root:

    python3 tools/torch_deep_pos_conv_profile.py
"""
import pathlib
import sys
import tempfile
ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import torch
import chip_smoke as cs
from speech_ssl_compression_tpu_torch.ops import _kernels
from speech_ssl_compression_tpu_torch.configs import (
    MelHuBERTConfig, melhubert_config_from_yaml)
from speech_ssl_compression_tpu_torch.extract import MelHuBERTExtractor
from speech_ssl_compression_tpu_torch.utils.checkpoint import save_checkpoint
from speech_ssl_compression_tpu_torch.utils.weights import init_params_np

gpu = cs.gpu_name_and_power()
print("gpu:", gpu, flush=True)
_kernels.build()
_kernels.load()
base = melhubert_config_from_yaml(cs.CONFIG_YAML).to_dict()
wavs = cs.synthetic_wavs(seed=0)
with tempfile.TemporaryDirectory() as tmp:
    for name, extra in (("depth 1", {}), ("deep", cs.DEEP_POS_CONV)):
        cfg = MelHuBERTConfig.from_dict(dict(base, **extra))
        ckpt = f"{tmp}/{name.replace(' ', '')}.npz"
        save_checkpoint(ckpt, init_params_np(cfg, seed=0), meta={
            "Upstream_Config": {"melhubert": cfg.to_dict()}, "Step": 0})
        for dtype in (torch.float32, torch.bfloat16):
            ext = MelHuBERTExtractor(ckpt, fp=20,
                                     mean_std_npy_path=str(cs.MEAN_STD),
                                     dtype=dtype, device="cuda")
            feat, pad, lengths = ext.featurize(wavs)
            ms = cs.cuda_ms(lambda: ext._pack_and_dispatch(feat, pad, lengths))
            wav_ms = cs.cuda_ms(lambda: ext.forward_packed(wavs))
            print(f"{name} {dtype}: from features {ms:.2f} ms, from "
                  f"waveforms {wav_ms:.2f} ms [{gpu}]", flush=True)
            cs.profile_calls(f"{name} {dtype} forward_packed from features",
                             lambda: ext._pack_and_dispatch(feat, pad,
                                                            lengths), gpu)
            del ext
