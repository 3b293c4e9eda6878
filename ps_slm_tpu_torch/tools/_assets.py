"""Synthetic stand-ins for the recipes' assets, written by the port.

scripts/decode.sh's layout from any port model: an HF Qwen2 directory
(config, one safetensors file, a byte-level tokenizer), a funasr
SenseVoiceSmall directory (``model.pt``, ``config.yaml``, a seeded
``am.mvn``), the projector's reference checkpoint and a ``multitask.jsonl``
manifest over seeded 16 kHz audio in a Kaldi ``wav.ark``, ``.wav`` and
``.flac`` files.  ``chip_smoke.py`` and ``tools/asset_day.py``'s dry run
build their assets with these; the weights are whatever the model holds.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

# Qwen2.5's special tokens at their ids; the tokenizer adds <speech> after
QWEN_SPECIALS = {"<|endoftext|>": 151643, "<|im_start|>": 151644, "<|im_end|>": 151645}
WORDS = ("the cat sat on a mat while rain fell over quiet hills and old ships "
         "sailed past bright towers into the evening sea").split()
DECODE_UTTS = {"ark": 24, "wav": 4, "flac": 4}
DECODE_SECONDS = (2.0, 12.0)


def write_safetensors(path: str, tensors: dict) -> None:
    """A ``.safetensors`` file: 8-byte little-endian header length, JSON
    header (names sorted, data offsets from the end of the header, padded
    with spaces to 8 bytes), raw little-endian data."""
    names = {torch.float32: "F32", torch.bfloat16: "BF16", torch.float16: "F16",
             torch.int64: "I64"}
    header, offset = {}, 0
    for k in sorted(tensors):
        t = tensors[k]
        n = t.numel() * t.element_size()
        header[k] = {"dtype": names[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for k in sorted(tensors):
            f.write(tensors[k].detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy())


def write_llm_dir(path: str, llm, dtype, specials=None) -> dict:
    """An HF directory from the port's ``llm`` (Qwen2, or DeepSeek-V3 by its
    ``model_type``): ``config.json`` (``tie_word_embeddings`` as the model
    has it), one ``model.safetensors`` in ``dtype`` under the HF names, and
    a byte-level tokenizer: the 256 byte tokens (ids 0-255), no merges,
    ``specials`` (default: Qwen2.5's at their ids) and ``<|im_end|>`` as EOS.
    Returns the written tensors."""
    import dataclasses

    from ps_slm_tpu_torch.data.bbpe import bytes_to_unicode
    from ps_slm_tpu_torch.models import deepseek_v3
    from ps_slm_tpu_torch.models.qwen2 import state_dict_to_hf

    specials = specials or QWEN_SPECIALS
    cfg = llm.cfg
    deepseek = getattr(cfg, "model_type", "qwen2") == "deepseek_v3"
    to_hf = deepseek_v3.state_dict_to_hf if deepseek else state_dict_to_hf
    os.makedirs(path, exist_ok=True)
    tensors = {k: v.detach().to(dtype).cpu() for k, v in to_hf(llm).items()}
    write_safetensors(os.path.join(path, "model.safetensors"), tensors)
    if deepseek:
        config = {"architectures": ["DeepseekV3ForCausalLM"], "model_type": "deepseek_v3",
                  **dataclasses.asdict(cfg), "q_lora_rank": None}
    else:
        config = {
            "architectures": ["Qwen2ForCausalLM"], "model_type": "qwen2",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_hidden_layers,
            "num_attention_heads": cfg.num_attention_heads,
            "num_key_value_heads": cfg.num_key_value_heads, "head_dim": cfg.head_dim,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
            "max_position_embeddings": cfg.max_position_embeddings,
            "tie_word_embeddings": cfg.tie_word_embeddings,
        }
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(config, torch_dtype=str(dtype).replace("torch.", "")), f, indent=2)
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump({c: b for b, c in sorted(bytes_to_unicode().items())}, f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({
            "tokenizer_class": "Qwen2Tokenizer", "eos_token": "<|im_end|>",
            "pad_token": "<|endoftext|>",
            "added_tokens_decoder": {str(i): {"content": t, "special": True}
                                     for t, i in specials.items()},
        }, f, indent=2)
    return tensors


def write_encoder_dir(path: str, encoder, seed: int = 0) -> dict:
    """A funasr SenseVoiceSmall directory from the port's ``encoder``:
    ``model.pt`` (fp32, funasr names), ``config.yaml`` and a seeded
    ``am.mvn`` as wide as the encoder's input.  Returns the written
    tensors."""
    from ps_slm_tpu_torch.training.checkpoint import _encoder_to_reference

    cfg = encoder.cfg
    os.makedirs(path, exist_ok=True)
    tensors = {k[len("encoder."):]: v for k, v in _encoder_to_reference(encoder).items()}
    torch.save(tensors, os.path.join(path, "model.pt"))
    with open(os.path.join(path, "config.yaml"), "w") as f:
        f.write(f"input_size: {cfg.input_size}\nvocab_size: {cfg.vocab_size}\nencoder_conf:\n")
        for k in ("output_size", "attention_heads", "linear_units", "num_blocks",
                  "tp_blocks", "kernel_size"):
            f.write(f"  {k}: {getattr(cfg, k)}\n")
    rng = np.random.default_rng(seed)
    d = cfg.input_size
    shift = -(12.0 + rng.normal(size=d))                    # minus the log-mel means
    scale = 0.25 + 0.05 * rng.random(size=d)                # inverse standard deviations
    with open(os.path.join(path, "am.mvn"), "w") as f:
        f.write(f"<Nnet>\n<Splice> {d} {d}\n[ 0 ]\n<AddShift> {d} {d}\n<LearnRateCoef> 0 [ ")
        f.write(" ".join(f"{v:.6f}" for v in shift))
        f.write(f" ]\n<Rescale> {d} {d}\n<LearnRateCoef> 0 [ ")
        f.write(" ".join(f"{v:.6f}" for v in scale))
        f.write(" ]\n</Nnet>\n")
    return tensors


def write_manifest(path: str, utts=None, seconds=DECODE_SECONDS, seed: int = 0) -> float:
    """``path/multitask.jsonl`` over seeded 16 kHz 16-bit utterances of
    ``seconds`` (lo, hi): ``utts["ark"]`` in one Kaldi ``wav.ark``, then
    ``utts["wav"]`` .wav and ``utts["flac"]`` .flac files (the port's
    writers); tasks drawn from ASR and the three translation prompts,
    targets and GT of random words.  Returns the seconds of audio."""
    from ps_slm_tpu_torch.data import audio_io
    from ps_slm_tpu_torch.data.flac import write_flac

    utts = utts or DECODE_UTTS
    rng = np.random.default_rng(seed)
    rate = 16000
    os.makedirs(path, exist_ok=True)
    audio, rows, total = {}, [], 0.0
    for kind, n in utts.items():
        for i in range(n):
            key = f"{kind}{i:02d}"
            t = np.arange(int(rng.uniform(*seconds) * rate)) / rate
            wave = (0.05 * rng.normal(size=t.size)
                    + 0.1 * np.sin(2 * np.pi * rng.uniform(100, 400) * t)).astype(np.float32)
            total += t.size / rate
            audio[key] = (kind, wave)
    ark = os.path.join(path, "wav.ark")
    offsets = audio_io.write_kaldi_wav_ark(
        ark, {k: (rate, w) for k, (kind, w) in audio.items() if kind == "ark"})
    for key, (kind, wave) in audio.items():
        if kind == "ark":
            src = f"{ark}:{offsets[key]}"
        else:
            src = os.path.join(path, f"{key}.{kind}")
            (audio_io.write_wav if kind == "wav" else write_flac)(src, rate, wave)
        words = " ".join(rng.choice(WORDS, size=int(rng.integers(4, 16))))
        task = str(rng.choice(["ASR", "ASR", "ZH2EN", "EN2ZH", "EN2DE"]))
        rows.append({"key": key, "path": src, "target": words, "GT": words, "task": task})
    with open(os.path.join(path, "multitask.jsonl"), "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return total


def write_assets(root: str, model, *, llm_dtype, specials=None, utts=None,
                 seconds=DECODE_SECONDS, seed: int = 0) -> dict:
    """scripts/decode.sh's inputs under ``root`` from the port's ``model``:
    ``Qwen2.5-1.5B-Instruct/`` (:func:`write_llm_dir`), ``SenseVoiceSmall/``
    (:func:`write_encoder_dir`), ``half_audio_finetuned/pytorch_model.bin``
    (the projector under reference keys) and ``test/`` (:func:`write_manifest`).
    Returns the paths, the written tensors by kind and the audio seconds."""
    from ps_slm_tpu_torch.training.checkpoint import export_reference_checkpoint

    out = {"llm_path": os.path.join(root, "Qwen2.5-1.5B-Instruct"),
           "encoder_path": os.path.join(root, "SenseVoiceSmall"),
           "ckpt_path": os.path.join(root, "half_audio_finetuned", "pytorch_model.bin"),
           "data": os.path.join(root, "test")}
    out["llm"] = write_llm_dir(out["llm_path"], model.llm, llm_dtype, specials)
    out["encoder"] = write_encoder_dir(out["encoder_path"], model.encoder, seed)
    os.makedirs(os.path.dirname(out["ckpt_path"]), exist_ok=True)
    out["projector"] = export_reference_checkpoint(model, out["ckpt_path"],
                                                   exclude=("llm", "encoder"))
    out["audio_seconds"] = write_manifest(out["data"], utts, seconds, seed)
    return out
