"""``chip_smoke.py``'s preprocess, fairseq dump, deep pos-conv, device
masks and wave_bench phases end to end on the CPU at a narrow width: the
plain attention counted as the kernels' launches (its bf16 forward walked
in the kernel's key tiles), the CUDA synchronisation and timing stubbed,
the train phase's trainer replaced by an f32 run of the same CLI on the
preprocess phase's CSV. Their launch counts per path and their checks."""

import pathlib
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

NARROW = dict(encoder_layers=2, encoder_embed_dim=64,
              encoder_ffn_embed_dim=128, encoder_attention_heads=1,
              conv_pos=16, conv_pos_groups=4)
LAYERS = NARROW["encoder_layers"]


@pytest.fixture
def counted(monkeypatch):
    """The plain attention routes counted as the kernels' launches."""
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa

    plain_fwd, plain_bwd = fa._reference_fwd, fa.reference_bwd

    def counted_fwd(q, k, v, *args, **kwargs):
        if len(args) == 4 and q.dtype == torch.bfloat16:
            kwargs["block_k"] = fa.KERNEL_BLOCK_K
        fa._count("flash_attn_fwd", q, k.shape[2])
        return plain_fwd(q, k, v, *args, **kwargs)

    def counted_bwd(q, k, *args):
        for name in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
            fa._count(name, q, k.shape[2])
        return plain_bwd(q, k, *args)

    monkeypatch.setattr(fa, "_reference_fwd", counted_fwd)
    monkeypatch.setattr(fa, "reference_bwd", counted_bwd)
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, **kw: (fn(), 1.0)[1])


def _narrow_yaml(tmp_path, monkeypatch, **extra):
    from speech_ssl_compression_tpu_torch.configs import read_yaml

    tree = read_yaml(chip_smoke.CONFIG_YAML)
    tree["melhubert"].update(NARROW, **extra)
    path = tmp_path / "model.yaml"
    path.write_text(chip_smoke.to_yaml(tree) + "\n")
    monkeypatch.setattr(chip_smoke, "CONFIG_YAML", path)
    return path


def test_data_phases_train_from_the_offline_path(counted, monkeypatch,
                                                 tmp_path):
    from speech_ssl_compression_tpu_torch.train.__main__ import main as train

    csv = chip_smoke.phase_preprocess(torch.device("cpu"), "cpu",
                                      str(tmp_path))
    assert csv.endswith("libri960-stg2-20ms.csv")
    model_yaml = _narrow_yaml(tmp_path, monkeypatch, dropout=0.0,
                              attention_dropout=0.0, activation_dropout=0.0)
    runner_yaml = tmp_path / "runner.yaml"
    runner_yaml.write_text(chip_smoke.RUNNER_YAML.format(csv=csv).replace(
        "bf16: true", "bf16: false").replace("total_steps: 3",
                                             "total_steps: 1").replace(
        "gradient_accumulate_steps: 8", "gradient_accumulate_steps: 1"))
    runner = train(["-m", "melhubert", "-g", str(model_yaml), "-c",
                    str(runner_yaml), "-n", str(tmp_path / "exp"),
                    "--device", "cpu", "--seed", "0"])
    assert [e["step"] for e in runner.log_history] == [1]
    batch = runner._device_batch(runner._get_dataloader().get_batch(0))
    assert tuple(batch["feat"].shape) == (4, 768, 80)

    dump = chip_smoke.phase_fairseq_dump(torch.device("cpu"), "cpu",
                                         str(tmp_path), runner)
    for name in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        assert dump[name] == {"f32": LAYERS, "bf16": 0}

    monkeypatch.setattr(chip_smoke, "DEVICE_MASK_DRAWS", 40)
    masks = chip_smoke.phase_device_masks(torch.device("cpu"), "cpu",
                                          runner, batch)
    assert masks["flash_attn_fwd"] == {"f32": LAYERS, "bf16": 0}
    assert masks["flash_attn_bwd_dq"] == {"f32": 0, "bf16": 0}


def test_deep_pos_conv_phase(counted, monkeypatch, tmp_path):
    _narrow_yaml(tmp_path, monkeypatch)
    monkeypatch.setattr(chip_smoke, "SERVE_LENGTHS", (21, 21, 92, 92))
    monkeypatch.setattr(chip_smoke, "DEEP_POS_CONV",
                        dict(pos_conv_depth=5, conv_pos=95))
    rng = np.random.default_rng(0)
    lengths = np.array([128, 100, 77, 40])
    pad = (np.arange(128)[None, :] < lengths[:, None]).astype(np.float32)
    batch = {"feat": torch.from_numpy(
                 rng.standard_normal((4, 128, 80)).astype(np.float32)),
             "label": torch.from_numpy(np.where(
                 pad > 0, rng.integers(0, 512, (4, 128)), -100)).long(),
             "pad_mask": torch.from_numpy(pad), "length": lengths}
    serve, train = chip_smoke.phase_deep_pos_conv(
        torch.device("cpu"), "cpu", str(tmp_path), batch)
    assert serve["flash_attn_fwd"] == {"f32": LAYERS, "bf16": LAYERS}
    for name in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        assert train[name] == {"f32": LAYERS, "bf16": 0}


def test_wave_bench_phase(counted, monkeypatch):
    from speech_ssl_compression_tpu_torch.train import wave_bench

    monkeypatch.setattr(wave_bench, "BASE_COMMON", dict(
        wave_bench.BASE_COMMON, encoder_layers=2, encoder_embed_dim=64,
        encoder_ffn_embed_dim=128, encoder_attention_heads=1,
        conv_feature_layers="[(32,10,5)] + [(32,3,2)] * 2", final_dim=16,
        conv_pos=16, conv_pos_groups=4))
    monkeypatch.setattr(chip_smoke, "WAVE_BENCH", (2, 8000))
    paths = chip_smoke.phase_wave_bench(torch.device("cpu"), "cpu")
    assert set(paths) == {"hubert wave bench", "wav2vec2 wave bench"}
    for counts in paths.values():
        # bf16 on the CPU: the compute dtype of the bench's step
        assert counts["flash_attn_fwd"]["bf16"] == LAYERS
        assert counts["flash_attn_bwd_dq"]["bf16"] == LAYERS
