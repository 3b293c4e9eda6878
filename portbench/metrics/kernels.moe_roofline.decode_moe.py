"""The grouped expert kernels' share of their roofline in the traced
window: the least time of the MoE calls the program's device tallies
recorded (``moe.rows``, ``moe.experts_read``: one-token steps and the rest
each against the larger of FLOPs / 989 T and bytes / 3.35 T;
``counting_deepseek_v3.moe_least_seconds``) over the device time of the
kernels named below; nothing from a program without them."""

from portbench import counting_deepseek_v3 as cd
from portbench import program_spans as ps

UNIT, LAYER, MOVES = "%", "kernels", "decode_audio_s_per_s"
KERNELS = ("moe_grouped_gemm_gate_up", "moe_grouped_gemm_down")


def read(run):
    t, rec = run.trace_summary, ps.recorded()
    tallies = None if rec is None else rec.get("tallies")
    if t is None or not tallies or "moe.rows" not in tallies:
        return None
    seconds = t.kernel_seconds(lambda n: any(k in n for k in KERNELS))
    if seconds <= 0:
        return None
    return 100.0 * cd.moe_least_seconds(run.cfg["llm"], tallies) / seconds
