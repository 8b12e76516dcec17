"""The roofline and model-FLOP counts give the port's kernel-table
bounds (PERF.md §6) at its shapes."""

import pytest

from roofline import counts, model_flops
from h100bench import spec


def ms(s):
    return round(s * 1e3, 4)


def test_kernel_a_bound():
    assert ms(counts.encoder_attention_s(32, 1500, 20, 64)) == 0.3727


def test_kernel_b_bound():
    assert ms(counts.cross_attention_s(32, 2, 1500, 1280)) == 0.0369


def test_layer_step_bound():
    parts = counts.layer_step_s(64, 100, 32, 1500, 1280, 20)
    assert [ms(p) for p in parts] == [0.0120, 0.0378, 0.0040]
    assert ms(sum(parts)) == 0.0538


def test_fused_blocks_without_kernel_b():
    f, b = counts.fused_without_kernel_b(64, 100, 32, 1500, 1280, 20)
    whole = [counts.self_block(64, 100, 1280), counts.cross_block(
        64, 32, 1500, 1280, 20), counts.mlp_block(64, 1280)]
    assert b == sum(x[1] for x in whole) - counts.cross_block_kernel_b(
        32, 1500, 1280, 20)
    assert f < sum(x[0] for x in whole)


@pytest.mark.parametrize("cfg", ["whisper-large-v3-turbo",
                                 "whisper-large-v2-int8"])
def test_model_flops(cfg):
    m = spec.config(cfg)["model"]
    d, t, layers = 1280, 1500, 32
    enc = model_flops.encoder_window(m)
    # 2 x the parameters a frame, plus attention
    assert enc == pytest.approx(
        2 * t * 12 * d * d * layers + 4 * t * t * d * layers, rel=0.02)
    one = model_flops.decoder_token(m, 0, 1500)
    assert one > 2 * d * m["vocab_size"]
    b = model_flops.batch(m, 1500, 32, 2, 128, 3)
    assert b == pytest.approx(32 * (enc + model_flops.cross_kv_window(
        m, 1500)) + 64 * sum(model_flops.decoder_token(m, p, 1500)
                             for p in range(131)))
