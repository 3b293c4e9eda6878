"""The latent-attention flash instantiation's share of its roofline in the
traced window: the least time of the expanded prefill attention of every
request the pool pulled in the window (each layer's causal attention over
the prefill's valid positions, the merged prompt at the frames the
reference's PSD keeps; ``counting_deepseek_v3.mla_attention``), max(FLOPs /
989 T, bytes / 3.35 T) summed, over the device time of the kernel named
below; nothing from a program that has no such kernel."""

from portbench import counting, counting_deepseek_v3 as cd

UNIT, LAYER, MOVES = "%", "kernels", "decode_audio_s_per_s"
KERNEL = "flash_fwd_mla_bf16_kernel"


def read(run):
    t, prefills = run.trace_summary, run.facts.get("prefills")
    if t is None or not prefills:
        return None
    seconds = t.kernel_seconds(lambda n: KERNEL in n)
    if seconds <= 0:
        return None
    llm = run.cfg["llm"]
    qk = llm["qk_nope_head_dim"] + llm["qk_rope_head_dim"]
    least = sum(llm["num_hidden_layers"] * counting.least_seconds(*cd.mla_attention(
        r["text"] + r["kept"] - 1, llm["num_attention_heads"], qk, llm["v_head_dim"]))
        for r in prefills)
    return 100.0 * least / seconds
