"""Small configurations of both architectures and a small cell, for the
benchmark's own tests on the CPU (float32 weights, the port's plain
kernels)."""

TINY_QWEN3 = {
    "name": "tiny-qwen3-moe", "source": "test", "model_type": "qwen3_moe",
    "num_hidden_layers": 3, "hidden_size": 64, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 96,
    "num_experts": 8, "num_experts_per_tok": 2, "moe_intermediate_size": 32,
    "vocab_size": 97, "max_position_embeddings": 256, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-6, "norm_topk_prob": True, "rope_scaling": None,
    "tie_word_embeddings": False, "torch_dtype": "float32",
}

TINY_DEEPSEEK = {
    "name": "tiny-deepseek-v2", "source": "test", "model_type": "deepseek_v2",
    "num_hidden_layers": 3, "hidden_size": 64, "num_attention_heads": 4,
    "num_key_value_heads": 4, "intermediate_size": 96, "kv_lora_rank": 16,
    "q_lora_rank": 24, "qk_rope_head_dim": 8, "qk_nope_head_dim": 16,
    "v_head_dim": 16, "n_routed_experts": 8, "num_experts_per_tok": 2,
    "n_shared_experts": 1, "moe_intermediate_size": 32,
    "first_k_dense_replace": 1, "moe_layer_freq": 1, "vocab_size": 97,
    "max_position_embeddings": 256, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-6, "norm_topk_prob": True, "rope_scaling": None,
    "topk_method": "greedy", "routed_scaling_factor": 1,
    "scoring_func": "softmax", "tie_word_embeddings": False,
    "torch_dtype": "float32",
}

TINY_TRAFFIC = {"process": "poisson", "base_seed": 7,
                "prompt": {"mean": 20, "std": 10, "lo": 4},
                "output": {"mean": 8, "std": 3, "lo": 3}}


def tiny_cell(limit: float = 0.02) -> dict:
    return {"config": "tiny", "traffic": "tiny", "scheduler": "layered",
            "moe_dispatch": "ragged", "prefix_cache": True, "slots": 3,
            "max_len": 64, "quantum": 16, "token_budget": 16, "rate": 4.0,
            "check": {"requests": 8,
                      "tokens": 200, "limit": limit}}
