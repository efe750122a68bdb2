"""The frozen operation counts against counts worked out by hand at
MelHuBERT's and HuBERT's published widths."""

import pytest

from h100_bench import flops, harness

SPEC = harness.load_benchmark()
MEL = harness.load_config(SPEC, "melhubert-20ms-base")
HUB = harness.load_config(SPEC, "hubert-base-ls960")

# one layer at one frame: q, k, v, out (2 * 4 * 768^2), scores and context
# (4 * 768), fc1 and fc2 (4 * 768 * 3072)
LAYER_1 = 2 * 4 * 768 * 768 + 4 * 768 + 4 * 768 * 3072
POS_CONV_1 = 2 * 768 * 48 * 128  # 768 outputs, 48 inputs each, 128 taps


def test_encoder_one_frame():
    assert LAYER_1 == 14_158_848
    assert flops.encoder_fwd_flops(MEL, 1) == 12 * LAYER_1


def test_encoder_attention_grows_with_the_square():
    extra = flops.encoder_fwd_flops(MEL, 100) - 100 * flops.encoder_fwd_flops(
        MEL, 1)
    assert extra == 12 * 4 * 768 * (100 * 100 - 100)


def test_pos_conv_per_frame():
    assert POS_CONV_1 == 9_437_184  # the ~9.4e6 a frame utils/flops.py missed
    assert flops.pos_conv_fwd_flops(MEL, 10) == 10 * POS_CONV_1


def test_melhubert_forward():
    serve = 2 * 80 * 768 + POS_CONV_1 + 12 * LAYER_1
    assert flops.melhubert_fwd_flops(MEL, 1, final_proj=False) == serve
    assert flops.melhubert_fwd_flops(MEL, 1, final_proj=True) == (
        serve + 2 * 768 * 512)
    assert flops.train_flops(serve) == 3 * serve


def test_hubert_frontend_400_samples():
    # output lengths 79, 39, 19, 9, 4, 2, 1
    want = (2 * 79 * 512 * 10 + 2 * 39 * 512 * 512 * 3
            + 2 * 19 * 512 * 512 * 3 + 2 * 9 * 512 * 512 * 3
            + 2 * 4 * 512 * 512 * 3 + 2 * 2 * 512 * 512 * 2
            + 2 * 1 * 512 * 512 * 2)
    layers = HUB["conv_feature_layers"]
    assert flops.conv_frontend_fwd_flops(layers, 400) == want == 115_628_032
    assert flops.conv_output_length(layers, 400) == 1
    assert flops.hubert_fwd_flops(HUB, 400) == (
        want + 2 * 512 * 768 + POS_CONV_1 + 12 * LAYER_1)


def test_attention_work():
    assert flops.attention_work(MEL, 100, 100, "float32") == (
        4 * 100 * 100 * 768, (2 * 100 + 2 * 100) * 768 * 4)
    assert flops.attention_work(MEL, 100, 50, "bfloat16", backward=True) == (
        8 * 100 * 50 * 768, (4 * 100 + 4 * 50) * 768 * 2)


def test_least_seconds_takes_the_larger_bound():
    card = "NVIDIA H100 80GB HBM3"
    # f32 products in split TF32: 495 / 3 TFLOP/s
    assert flops.least_seconds(495e12, 0, card, "float32") == pytest.approx(
        3.0)
    assert flops.least_seconds(0, 3.35e12, card, "bfloat16") == 1.0
    with pytest.raises(ValueError):
        flops.peak_flops("NVIDIA A100-SXM4-80GB", "float32")


def test_matches_the_ports_counts_where_they_overlap():
    from speech_ssl_compression_tpu_torch.configs import MelHuBERTConfig
    from speech_ssl_compression_tpu_torch.utils import flops as port

    cfg = MelHuBERTConfig.from_dict({k: MEL[k] for k in (
        "encoder_layers", "encoder_embed_dim", "encoder_ffn_embed_dim",
        "encoder_attention_heads", "feat_emb_dim", "num_cluster")})
    for t in (1, 37, 750):
        assert flops.encoder_fwd_flops(MEL, t) == port.encoder_fwd_flops(
            cfg, t)
        assert flops.melhubert_fwd_flops(MEL, t, True) == (
            port.melhubert_fwd_flops(cfg, t, 80) + flops.pos_conv_fwd_flops(
                MEL, t))
