"""The traced window's useful ASR FLOPs (the encoder and its CTC head over
each utterance's valid positions, queries counted; ``counting.asr_flops``)
over the window times the H100's dense bf16 peak."""

from portbench import counting

UNIT, LAYER, MOVES = "%", "encoder and ASR", "asr_audio_s_per_s"


def read(run):
    lengths, window = run.facts.get("asr_lengths"), run.facts.get("window_s")
    if not lengths or not window:
        return None
    return 100.0 * counting.asr_flops(run.cfg["encoder"], lengths) / (window * counting.PEAK_FLOPS)
