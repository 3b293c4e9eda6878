"""The least time of the traced window's useful serving work over the
window, as ``model.mfu.decode`` at a mixture of experts' active
parameters (``counting_deepseek_v3.decode_least_seconds``): each refill's
front half and prefill of its own positions; the decode steps' FLOPs at
the weights each token uses, their bytes the weights outside the routed
experts once a step (the head included), the experts the device tallies
say the steps read (``moe.experts_read``, one-token steps), and each
slot's valid latent cells; prompts at the frames the reference's PSD
keeps."""

from portbench import counting_deepseek_v3 as cd
from portbench import program_spans as ps

UNIT, LAYER, MOVES = "%", "LLM and front half", "decode_audio_s_per_s"


def read(run):
    reqs, window, rec = run.facts.get("requests"), run.facts.get("window_s"), ps.recorded()
    tallies = None if rec is None else rec.get("tallies")
    if not reqs or not window or not tallies or "moe.experts_read" not in tallies:
        return None
    read_steps = sum(tallies["moe.experts_read"][0])
    least = cd.decode_least_seconds(run.cfg, reqs, run.facts["slots"], read_steps)
    return 100.0 * least / window
