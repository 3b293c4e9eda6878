"""Inference: KV-cache decoding, draft verification and the slot pools."""


def validate_pool_decode_knobs(tc, mode: str) -> None:
    """The slot pools and the draft-verified path implement plain greedy and
    beam search only: reject the knobs they would silently ignore (the
    static path honours them), as the JAX package's decode and serve CLIs
    do."""
    if tc.repetition_penalty != 1.0:
        raise ValueError(
            f"{mode} does not apply repetition_penalty; unset it or use the static "
            "decode path")
    if tc.do_sample:
        raise ValueError(f"{mode} does not sample; unset do_sample or use the static decode path")
    if tc.min_length > 1:
        raise ValueError(f"{mode} does not apply min_length; use the static decode path")
    if tc.speculative_ctc and tc.spec_window < 2:
        raise ValueError(
            "spec_window must be >= 2 (a 1-token window has no draft tokens to verify — "
            "use plain greedy instead)")
    if tc.speculative_ctc and tc.num_beams != 1:
        raise ValueError(
            "speculative_ctc requires num_beams=1 (draft verification is defined "
            "against greedy decode)")
    if tc.stream_partials and tc.num_beams != 1:
        raise ValueError(
            "stream_partials requires num_beams=1 — beam hypotheses have no stable "
            "prefix until finalization")


def make_pool_decoder(model, tc, dc, *, eos_token_id: int, device="cuda"):
    """The slot pool the decode knobs select (speculative_ctc, then
    num_beams > 1, then greedy), built as the JAX ``make_pool_decoder``
    builds it: the speculative pool syncs every
    ``max(decode_sync_every // spec_window, 2)`` windows."""
    common = dict(num_slots=tc.decode_slots, prefill_len=dc.eval_max_frame_length,
                  max_new_tokens=tc.max_new_tokens, eos_token_id=eos_token_id,
                  kv_bits=tc.kv_cache_bits, device=device)
    if tc.speculative_ctc:
        from ps_slm_tpu_torch.inference.continuous_spec import ContinuousSpeculativeDecoder

        return ContinuousSpeculativeDecoder(
            model, window=tc.spec_window,
            sync_every=max(tc.decode_sync_every // tc.spec_window, 2), **common)
    if tc.num_beams > 1:
        from ps_slm_tpu_torch.inference.continuous_beam import ContinuousBeamDecoder

        return ContinuousBeamDecoder(
            model, num_beams=tc.num_beams, length_penalty=tc.length_penalty,
            sync_every=tc.decode_sync_every, **common)
    from ps_slm_tpu_torch.inference.continuous import ContinuousGreedyDecoder

    return ContinuousGreedyDecoder(model, sync_every=tc.decode_sync_every, **common)


def ctc_draft(model, batch, encoder_tokenizer, tokenizer) -> list:
    """One request's CTC transcript re-tokenized into the LLM vocabulary:
    the speculative pools' draft."""
    from ps_slm_tpu_torch.inference.generate import ctc_transcript_ids

    (row,) = ctc_transcript_ids(model, batch)
    return tokenizer.encode(encoder_tokenizer.decode(row))
