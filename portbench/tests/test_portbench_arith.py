"""The yardstick's arithmetic against values worked out by hand at the
cells' shapes."""
import json
from pathlib import Path

import pytest

from portbench import arith

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _model(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())["model"]


def test_granite_train_step_flops_by_hand():
    # a layer, a token, at a mean causal context of 2048 keys:
    # q, o 2*1024*2048 + k, v 2*1024*1024 = 6,291,456; scores and values
    # 4*2048*1024 = 8,388,608; router 2*1024*32 = 65,536; 8 GLU experts
    # 2*8*1024*512*3 = 25,165,824; the tied head 2*1024*49155 = 100,669,440
    per_token = 24 * (6_291_456 + 8_388_608 + 65_536 + 25_165_824) \
        + 100_669_440
    assert per_token == 1_058_543_616
    m = _model("granite-moe-1b-a400m")
    assert arith.train_step_flops(m, 4, 4096) == 3 * 16384 * per_token


def test_rwkv6_forward_flops_by_hand():
    # r, k, v, g 8*2048^2; decay lora 2*2048*64*2; mix loras 2*2048*5*32*2;
    # WKV 32*64*64*6; channel mix 2*2048*7168*2 + 2*2048^2; output 2*2048^2
    layer = (33_554_432 + 524_288 + 1_310_720 + 786_432 + 67_108_864
             + 8_388_608)
    m = _model("rwkv6-1.6b")
    assert arith.fwd_flops(m, 1, 1) == 24 * layer + 2 * 2048 * 65536


def test_request_flops_sum_the_decode_steps():
    m = _model("granite-moe-1b-a400m")
    prompt, n_out = 1000, 7
    steps = sum(arith.fwd_flops(m, 1, prompt + j, decode=True)
                for j in range(n_out - 1))
    want = arith.fwd_flops(m, prompt, prompt) + steps
    assert arith.request_flops(m, prompt, n_out) == pytest.approx(want, rel=1e-12)
    assert arith.request_flops(m, prompt, 1) == arith.fwd_flops(m, prompt, prompt)


def test_wkv_bound_by_hand():
    # 1000 tokens, one sequence: operations 1000*32*(5*64^2 + 6*64)*24 over
    # 67 TFLOP/s against bytes (1000*2048*4*5 + 32*64^2*4)*24 over 3.35 TB/s
    m = _model("rwkv6-1.6b")
    ops = 1000 * 32 * (5 * 4096 + 384) * 24 / 67e12
    nbytes = (1000 * 2048 * 20 + 32 * 4096 * 4) * 24 / 3.35e12
    assert nbytes > ops
    assert arith.wkv_bound_s(m, 1000, 1) == pytest.approx(nbytes, rel=1e-12)
    assert arith.wkv_bound_s(m, 1000, 1) == pytest.approx(2.97200869e-4, rel=1e-6)
