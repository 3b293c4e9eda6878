"""The least time of the traced window's useful serving work over the
window (``counting.decode_least_seconds``): each refill's front half and
prefill of its own positions; every decode step max(FLOPs / 989 T,
bytes / 3.35 T), the int8 weights read once a step of ``slots`` tokens,
each slot's valid KV cells; prompts at the frames the reference's PSD
keeps."""

from portbench import counting

UNIT, LAYER, MOVES = "%", "LLM and front half", "decode_audio_s_per_s"


def read(run):
    reqs, window = run.facts.get("requests"), run.facts.get("window_s")
    if not reqs or not window:
        return None
    least = counting.decode_least_seconds(run.cfg, reqs, run.facts["slots"],
                                          run.facts["weight_bits"] / 8)
    return 100.0 * least / window
