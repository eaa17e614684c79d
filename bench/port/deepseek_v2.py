"""A ``deepseek_v2`` configuration (Hugging Face keys) as the port runs
it.  The port's MLA and router are a narrower form of the published
model; each setting it cannot honour is named in ``DEPARTURES`` and run
as stated there, by the port and the reference alike."""

DEPARTURES = {
    "rope_scaling": (None, "plain RoPE at rope_theta with the softmax "
                     "scale 1/sqrt(nope + rope): the port has no YaRN"),
    "topk_method": ("greedy", "a softmax top-k over all routed experts: "
                    "the port's router has no expert groups"),
    "n_group": (1, "no expert groups"),
    "topk_group": (1, "no expert groups"),
    "norm_topk_prob": (True, "the port renormalises the top-k weights"),
    "routed_scaling_factor": (1, "the port does not scale the routed "
                              "output"),
}


def config(c: dict):
    """The port's ``ModelConfig`` of ``c`` as run (``as_run``)."""
    from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig
    if any(c.get(k) != v for k, (v, _) in DEPARTURES.items()) \
            or c["scoring_func"] != "softmax" or c["moe_layer_freq"] != 1:
        raise ValueError("the port routes by a greedy softmax top-k with "
                         "renormalised weights, in every layer past the "
                         "dense ones, and rotates by plain RoPE")
    return ModelConfig(
        name=c["name"], family="moe", source=c["source"],
        n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], head_dim=c["v_head_dim"],
        d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
        max_seq_len=c["max_position_embeddings"],
        rope_theta=float(c["rope_theta"]), norm_eps=c["rms_norm_eps"],
        tie_embeddings=c["tie_word_embeddings"],
        moe=MoEConfig(n_experts=c["n_routed_experts"],
                      top_k=c["num_experts_per_tok"],
                      expert_d_ff=c["moe_intermediate_size"],
                      n_shared_experts=c["n_shared_experts"],
                      shared_d_ff=c["moe_intermediate_size"]),
        mla=MLAConfig(kv_lora_rank=c["kv_lora_rank"],
                      q_lora_rank=c["q_lora_rank"] or 0,
                      qk_rope_dim=c["qk_rope_head_dim"],
                      qk_nope_dim=c["qk_nope_head_dim"],
                      v_head_dim=c["v_head_dim"]),
        dense_block_ids=tuple(range(c["first_k_dense_replace"])),
        dtype=c["torch_dtype"], param_dtype=c["torch_dtype"]).validate()
