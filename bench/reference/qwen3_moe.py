"""Qwen3-MoE decoder, plain: RMSNorm pre-norm blocks of GQA attention
with RoPE and a softmax top-k mixture of SwiGLU experts, then RMSNorm and
the LM head.  As the port runs it (``bench/port/qwen3_moe.py``): no
per-head q/k norm (a configuration with ``qk_norm`` not false is
refused); query head h reads key/value head h % Hkv (under random
weights a relabelling of the published h // g)."""

from __future__ import annotations

import torch

from bench.reference.common import (causal_attention, lin, rms, rope,
                                    routed_experts)


def logits(c: dict, w, tokens: torch.Tensor, at: torch.Tensor,
           precision: str = "fp32") -> torch.Tensor:
    """The logits (len(at), vocab) at positions ``at`` of the sequence
    ``tokens`` (N,), float32."""
    if c.get("qk_norm", True):
        raise ValueError("this reference has no qk-norm")
    n = tokens.shape[0]
    h, hkv, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                  c["head_dim"])
    eps, theta = c["rms_norm_eps"], float(c["rope_theta"])
    pos = torch.arange(n, device=tokens.device)
    x = w.embed()[tokens].float()
    for i in range(c["num_hidden_layers"]):
        p = w.layer(i)
        a = rms(x, p["ln1/scale"], eps)
        q = rope(lin(a, p["attn/w_q"], precision).view(n, h, hd), pos, theta)
        k = rope(lin(a, p["attn/w_k"], precision).view(n, hkv, hd), pos,
                 theta)
        v = lin(a, p["attn/w_v"], precision).view(n, hkv, hd)
        x = x + lin(causal_attention(q, k, v, precision).reshape(n, h * hd),
                    p["attn/w_o"], precision)
        a = rms(x, p["ln2/scale"], eps)
        x = x + routed_experts(a, p["moe/router"], p["moe/w_gate"],
                               p["moe/w_up"], p["moe/w_down"],
                               c["num_experts_per_tok"], precision)
    return lin(rms(x[at], w.final_norm(), eps), w.lm_head(), precision)


def arch(c: dict) -> dict:
    """The work of one token, for the whole step's share of the peak:
    each layer's matrix FLOPs a token, the attention's heads and widths,
    the LM head's FLOPs a token it emits."""
    d, h, hkv, hd = (c["hidden_size"], c["num_attention_heads"],
                     c["num_key_value_heads"], c["head_dim"])
    e, k, f = (c["num_experts"], c["num_experts_per_tok"],
               c["moe_intermediate_size"])
    layer = 2 * d * (h + 2 * hkv) * hd + 2 * h * hd * d + 2 * d * e \
        + k * 6 * d * f
    return {"layer_flops": [layer] * c["num_hidden_layers"],
            "attn": (h, hkv, hd, hd), "head_flops": 2 * d * c["vocab_size"]}
