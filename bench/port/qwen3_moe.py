"""A ``qwen3_moe`` configuration (Hugging Face keys) as the port runs it.
Qwen3 normalises each head's query and key by an RMSNorm before RoPE;
the port's attention has no such norm.  ``DEPARTURES`` names it (a key
of the architecture, not of the published file), and the port and the
reference both run without it."""

DEPARTURES = {
    "qk_norm": (False, "the port's attention has no per-head RMSNorm of "
                "q and k"),
}


def config(c: dict):
    """The port's ``ModelConfig`` of ``c`` as run (``as_run``)."""
    from repro_torch.models.config import ModelConfig, MoEConfig
    if c.get("qk_norm", True):
        raise ValueError("the port's attention has no qk-norm")
    if c.get("rope_scaling") is not None or c.get("use_sliding_window"):
        raise ValueError("the port's qwen3_moe has no rope scaling and no "
                         "sliding window")
    if not c["norm_topk_prob"] or c.get("mlp_only_layers"):
        raise ValueError("the port renormalises the top-k weights and puts "
                         "experts in every layer")
    return ModelConfig(
        name=c["name"], family="moe", source=c["source"],
        n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
        d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
        max_seq_len=c["max_position_embeddings"],
        rope_theta=float(c["rope_theta"]), norm_eps=c["rms_norm_eps"],
        tie_embeddings=c["tie_word_embeddings"],
        moe=MoEConfig(n_experts=c["num_experts"],
                      top_k=c["num_experts_per_tok"],
                      expert_d_ff=c["moe_intermediate_size"]),
        dtype=c["torch_dtype"], param_dtype=c["torch_dtype"]).validate()
