"""DeepSeek-V2 decoder, plain: RMSNorm pre-norm blocks of multi-head
latent attention (the query through its low-rank path and RMSNorm; the
keys and values from one latent of ``kv_lora_rank`` with its RMSNorm, a
shared rope key of ``qk_rope_head_dim``; softmax scale 1/sqrt(nope +
rope)), then a dense SwiGLU in the first ``first_k_dense_replace`` blocks
and elsewhere a greedy softmax top-k of routed SwiGLU experts beside
``n_shared_experts`` shared ones; then RMSNorm and the LM head.  As the
port runs the configuration (``bench/port/deepseek_v2.py``): no YaRN, no
expert groups, renormalised top-k weights, no routed scaling; a
configuration that states otherwise is refused."""

from __future__ import annotations

import torch

from bench.reference.common import (causal_attention, lin, rms, rope,
                                    routed_experts, swiglu)


AS_RUN = {"rope_scaling": None, "topk_method": "greedy", "n_group": 1,
          "topk_group": 1, "norm_topk_prob": True,
          "routed_scaling_factor": 1}


def logits(c: dict, w, tokens: torch.Tensor, at: torch.Tensor,
           precision: str = "fp32") -> torch.Tensor:
    bad = {k: c.get(k) for k, v in AS_RUN.items() if c.get(k) != v}
    if bad:
        raise ValueError(f"this reference runs none of {bad}")
    n = tokens.shape[0]
    h = c["num_attention_heads"]
    nope, rd, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                    c["v_head_dim"])
    eps, theta = c["rms_norm_eps"], float(c["rope_theta"])
    pos = torch.arange(n, device=tokens.device)
    x = w.embed()[tokens].float()
    for i in range(c["num_hidden_layers"]):
        p = w.layer(i)
        a = rms(x, p["ln1/scale"], eps)
        cq = rms(lin(a, p["attn/w_dq"], precision), p["attn/q_norm/scale"],
                 eps)
        q = lin(cq, p["attn/w_uq"], precision).view(n, h, nope + rd)
        q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, theta)], -1)
        ckv = rms(lin(a, p["attn/w_dkv"], precision),
                  p["attn/kv_norm/scale"], eps)
        kr = rope(lin(a, p["attn/w_kr"], precision)[:, None], pos, theta)
        kn = lin(ckv, p["attn/w_uk"], precision).view(n, h, nope)
        k = torch.cat([kn, kr.expand(n, h, rd)], -1)
        v = lin(ckv, p["attn/w_uv"], precision).view(n, h, dv)
        x = x + lin(causal_attention(q, k, v, precision).reshape(n, h * dv),
                    p["attn/w_o"], precision)
        a = rms(x, p["ln2/scale"], eps)
        if i < c["first_k_dense_replace"]:
            x = x + swiglu(a, p["mlp/w_gate"], p["mlp/w_up"],
                           p["mlp/w_down"], precision)
        else:
            x = x + routed_experts(a, p["moe/router"], p["moe/w_gate"],
                                   p["moe/w_up"], p["moe/w_down"],
                                   c["num_experts_per_tok"], precision) \
                + swiglu(a, p["moe/shared/w_gate"], p["moe/shared/w_up"],
                         p["moe/shared/w_down"], precision)
    return lin(rms(x[at], w.final_norm(), eps), w.lm_head(), precision)


def arch(c: dict) -> dict:
    """As ``qwen3_moe.arch``.  Attention a token: the query's low-rank
    path, the latent and the rope key, the keys and values of its own
    latent (once, as the architecture computes them), the output
    projection; over the context, heads of nope + rope against dv."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    nope, rd, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                    c["v_head_dim"])
    ql, kvl = c["q_lora_rank"], c["kv_lora_rank"]
    attn = 2 * (d * ql + ql * h * (nope + rd) + d * (kvl + rd)
                + kvl * h * (nope + dv) + h * dv * d)
    f = c["moe_intermediate_size"]
    moe = 2 * d * c["n_routed_experts"] + c["num_experts_per_tok"] * 6 * d * f \
        + c["n_shared_experts"] * 6 * d * f
    dense = 6 * d * c["intermediate_size"]
    layers = [attn + (dense if i < c["first_k_dense_replace"] else moe)
              for i in range(c["num_hidden_layers"])]
    return {"layer_flops": layers, "attn": (h, h, nope + rd, dv),
            "head_flops": 2 * d * c["vocab_size"]}
