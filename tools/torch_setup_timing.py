"""Time, on one card, the full-width setup steps that chip_smoke.py
repeats (the seeded init, the npz save and load, the model build and its
parts, an extractor a dtype, the wave_bench set-up) and the first and
second calls of F.scaled_dot_product_attention at the library phase's
shapes, then that phase itself. Run from the repository's root:

    python3 tools/torch_setup_timing.py
"""
import pathlib
import subprocess
import sys
import tempfile
import time
ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import torch
import torch.nn.functional as F
import chip_smoke as cs

print(sys.version, torch.__version__, torch.version.cuda, flush=True)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout, flush=True)
dev = torch.device("cuda", 0)
torch.zeros(1, device=dev)


def t(name, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    print(f"{name}: {time.perf_counter() - t0:.3f} s", flush=True)
    return r


from speech_ssl_compression_tpu_torch.configs import (
    MelHuBERTConfig, melhubert_config_from_yaml)
from speech_ssl_compression_tpu_torch.utils.weights import (
    init_params_np, load_model, state_dict_from_jax_params)
from speech_ssl_compression_tpu_torch.utils.checkpoint import (
    save_checkpoint)
from speech_ssl_compression_tpu_torch.extract import load_any_checkpoint
from speech_ssl_compression_tpu_torch.models.melhubert import MelHuBERTModel
from speech_ssl_compression_tpu_torch.extract import MelHuBERTExtractor

cfg = melhubert_config_from_yaml(cs.CONFIG_YAML)
deep = MelHuBERTConfig.from_dict(dict(cfg.to_dict(), **cs.DEEP_POS_CONV))
for c, tag in ((cfg, "depth 1"), (deep, "deep")):
    params = t(f"{tag} init_params_np", lambda: init_params_np(c, seed=0))
    with tempfile.TemporaryDirectory() as tmp:
        ck = str(pathlib.Path(tmp) / "m.npz")
        t(f"{tag} save_checkpoint", lambda: save_checkpoint(ck, params, meta={
            "Upstream_Config": {"melhubert": c.to_dict()}, "Step": 0}))
        t(f"{tag} load_any_checkpoint", lambda: load_any_checkpoint(ck))
        m = t(f"{tag} MelHuBERTModel(cfg)", lambda: MelHuBERTModel(c))
        sd = t(f"{tag} state_dict_from_jax_params",
               lambda: state_dict_from_jax_params(params, None))
        t(f"{tag} load_state_dict", lambda: m.load_state_dict(sd))
        t(f"{tag} .to(dev)", lambda: m.to(dev))
        t(f"{tag} load_model", lambda: load_model(params, c))
        t(f"{tag} extractor f32", lambda: MelHuBERTExtractor(
            ck, fp=20, mean_std_npy_path=str(cs.MEAN_STD), device=dev))
        t(f"{tag} extractor bf16", lambda: MelHuBERTExtractor(
            ck, fp=20, mean_std_npy_path=str(cs.MEAN_STD),
            dtype=torch.bfloat16, device=dev))

from speech_ssl_compression_tpu_torch.train import wave_bench as wb
for name in ("hubert", "wav2vec2"):
    t(f"wave_bench_setup {name}", lambda: wb.wave_bench_setup(
        name, device=dev))

print("sdp backends: flash", torch.backends.cuda.flash_sdp_enabled(),
      "mem", torch.backends.cuda.mem_efficient_sdp_enabled(),
      "cudnn", torch.backends.cuda.cudnn_sdp_enabled(), flush=True)
for dtype in (torch.float32, torch.bfloat16):
    gen = torch.Generator(device=dev).manual_seed(5)
    for case, shape in (("training", (4, 12, 768, 64)),
                        ("long", (1, 12, 5000, 64)),
                        ("long_8192", (1, 12, 8192, 64))):
        for mask in (None, "pad"):
            q, k, v = (torch.randn(shape, generator=gen, device=dev)
                       .to(dtype).requires_grad_() for _ in range(3))
            am = None
            if mask:
                am = torch.ones(shape[0], 1, 1, shape[2], dtype=torch.bool,
                                device=dev)
                am[..., -5:] = False
            o = t(f"{dtype} {case} mask={mask} fwd first",
                  lambda: F.scaled_dot_product_attention(q, k, v,
                                                         attn_mask=am))
            t(f"{dtype} {case} mask={mask} fwd second",
              lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am))
            t(f"{dtype} {case} mask={mask} bwd first",
              lambda: torch.autograd.grad(o, (q, k, v), torch.ones_like(o),
                                          retain_graph=True))
    t(f"{dtype} attention_library_ms (the phase)",
      lambda: cs.attention_library_ms(dev, "", dtype))
