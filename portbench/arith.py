"""The yardstick's arithmetic: the card's published peaks, model FLOPs and
the WKV scan's least work, computed from a configuration file's numbers.

A frozen copy of the formulas of ``repro_torch/launch/flops.py``
(``_attn_flops``, ``_moe_flops``, ``_rwkv_flops``, ``fwd_flops`` for the
layer kinds the benchmark's configurations have) and of the H100 rates of
``repro_torch/launch/analysis.py``, taken here so that a change to the
program cannot move the benchmark's units.  Every function reads the
``model`` section of a configuration file (Hugging Face key names).
"""
from __future__ import annotations

#: NVIDIA H100 SXM, dense rates without sparsity (NVIDIA's data sheet), at
#: the card's full 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores
PEAK_HBM_BYTES = 3.35e12


def _attn_flops(m: dict, t: float, kv_eff: float) -> float:
    d, hq, hkv, dh = (m["hidden_size"], m["num_attention_heads"],
                      m["num_key_value_heads"], m["head_dim"])
    proj = 2 * t * d * (2 * hq * dh + 2 * hkv * dh)  # q, o + k, v
    core = 2 * t * kv_eff * hq * dh * 2  # q k^T + p v
    return proj + core


def _moe_flops(m: dict, t: float) -> float:
    """Active experts only: the router and ``top_k`` GLU experts a token."""
    d, ffe = m["hidden_size"], m["intermediate_size"]
    f = 2 * t * d * m["num_local_experts"]  # router
    f += 2 * t * m["num_experts_per_tok"] * d * ffe * 3
    return f


def _rwkv_flops(m: dict, t: float) -> float:
    d = m["hidden_size"]
    n = m["head_size"]
    h = d // n
    f = 2 * t * d * d * 4  # r, k, v, g projections
    f += 2 * t * d * m["decay_lora"] * 2
    f += 2 * t * d * 5 * m["mix_lora"] * 2
    f += t * h * n * n * 6  # WKV state update and read-out
    f += 2 * t * d * m["intermediate_size"] * 2 + 2 * t * d * d  # channel mix
    f += 2 * t * d * d  # output projection
    return f


def fwd_flops(m: dict, tokens: float, kv_len: float,
              decode: bool = False) -> float:
    """Model FLOPs of a forward over ``tokens`` tokens against ``kv_len``
    keys: a causal prefill attends to ``kv_len / 2`` keys on average, a
    decode step to all ``kv_len``."""
    total = 0.0
    arch = m["arch"]
    for _ in range(m["num_hidden_layers"]):
        if arch == "rwkv6":
            total += _rwkv_flops(m, tokens)
            continue
        total += _attn_flops(m, tokens, kv_len if decode else kv_len / 2)
        total += _moe_flops(m, tokens)
    total += 2 * tokens * m["hidden_size"] * m["vocab_size"]  # the head
    return total


def request_flops(m: dict, prompt: int, n_out: int) -> float:
    """Model FLOPs that serving one request needs: its prompt's forward, and
    one decode step for each generated token after the first (the first
    comes from the prompt's last logits).  A decode step at context ``c``
    is linear in ``c``, so the steps at contexts ``prompt .. prompt +
    n_out - 2`` sum to ``n_out - 1`` steps at their mean context."""
    f = fwd_flops(m, prompt, prompt)
    steps = max(n_out - 1, 0)
    if steps:
        f += fwd_flops(m, steps, prompt + (steps - 1) / 2, decode=True)
    return f


def train_step_flops(m: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: forward and backward (3 forwards),
    with no recomputation counted."""
    return 3.0 * fwd_flops(m, batch * seq, seq)


def wkv_bound_s(m: dict, tokens: int, sequences: int) -> float:
    """Least time of the WKV scans over ``tokens`` tokens of ``sequences``
    sequences, all layers: per (token, head) r.S 2N^2, the state update
    w*S + k v^T 3N^2, the bonus 5N and one exp a channel, in f32 on the
    CUDA cores, against r, k, v, log_w read once and y written once (f32),
    and each sequence's state (H N^2 f32) written once a layer.  The
    larger of the two."""
    d, n = m["hidden_size"], m["head_size"]
    h = d // n
    layers = m["num_hidden_layers"]
    flops = float(tokens) * h * (5 * n * n + 6 * n) * layers
    nbytes = (float(tokens) * d * 4 * 5 + sequences * h * n * n * 4) * layers
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES)
