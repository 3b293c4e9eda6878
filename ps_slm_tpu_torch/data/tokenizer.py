"""LLM-side tokenizer wrappers.

A copy of ``ps_slm_tpu/data/tokenizer.py`` (the port imports nothing of the
JAX package).  Every tokenizer adds the ``<speech>`` special token and pads
with EOS.  ``OwnBPETokenizer`` reads GPT-2-style checkpoints (vocab.json +
merges.txt, Qwen2/2.5 included) with ``data/bbpe.py``; ``StubTokenizer`` is
a dependency-free whitespace tokenizer for tests and smoke runs.  Where
the JAX package takes HF ``transformers`` (every other checkpoint, or
``PS_USE_HF_TOKENIZER=1``), the port's ``HFTokenizer`` raises
``ImportError``: no silent fallback to another tokenizer.
"""

from __future__ import annotations

import zlib
from typing import List, Optional

DEFAULT_SPEECH_TOKEN = "<speech>"
DEFAULT_IGNORE_TOKEN = -100


class HFTokenizer:
    """The JAX package's last resort for checkpoints whose pre-tokenization
    ``data/bbpe.py`` does not implement: HF ``AutoTokenizer`` from the
    ``transformers`` package, which the port does not use (the H100
    machine has none).  Constructing one raises ``ImportError``."""

    def __init__(self, path: str):
        raise ImportError(
            f"the tokenizer at {path} needs HF transformers (it is not a "
            "Qwen2/GPT-2 vocab.json + merges.txt checkpoint, or "
            "PS_USE_HF_TOKENIZER=1 asks for the wheel); the port reads only "
            "byte-level BPE checkpoints and does not import transformers"
        )


class OwnBPETokenizer:
    """Byte-level BPE (data/bbpe.py) behind the HFTokenizer interface, for
    GPT-2-style checkpoints (vocab.json + merges.txt, Qwen2/2.5 included)."""

    def __init__(self, path: str):
        import json
        import os

        from ps_slm_tpu_torch.data.bbpe import ByteLevelBPE

        self.tok = ByteLevelBPE.from_pretrained(path)
        eos = "<|endoftext|>"
        cfg_path = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                cfg = json.load(f)
            t = cfg.get("eos_token")
            if isinstance(t, dict):
                t = t.get("content")
            if t:
                eos = t
        self.tok.add_special_tokens([eos, DEFAULT_SPEECH_TOKEN])
        self.speech_token_id = self.tok.special_tokens[DEFAULT_SPEECH_TOKEN]
        self.eos_token_id = self.tok.special_tokens[eos]
        self.pad_token_id = self.eos_token_id  # reference: pad = eos
        self.bos_token_id = None
        self.default_ignore_token = DEFAULT_IGNORE_TOKEN

    @property
    def vocab_size(self) -> int:
        return self.tok.vocab_size

    def encode(self, text: str) -> List[int]:
        return self.tok.encode(text)

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return self.tok.decode(ids, skip_special_tokens)

    def batch_decode(self, idss, skip_special_tokens: bool = True):
        return [self.decode(ids, skip_special_tokens) for ids in idss]


class StubTokenizer:
    """Whitespace tokenizer over a fixed-size hashed vocab (tests only).

    Hashing is stable across processes (crc32, not the salted ``hash()``),
    so every process maps a word to the same id."""

    def __init__(self, vocab_size: int = 256):
        self._vocab = vocab_size
        self.eos_token_id = vocab_size - 1
        self.pad_token_id = vocab_size - 1
        self.bos_token_id = None
        self.speech_token_id = vocab_size - 2
        self.default_ignore_token = DEFAULT_IGNORE_TOKEN
        self._decode_memory = {}

    @property
    def vocab_size(self) -> int:
        return self._vocab

    def encode(self, text: str) -> List[int]:
        out = []
        for word in text.replace(DEFAULT_SPEECH_TOKEN, " \x00 ").split():
            if word == "\x00":
                out.append(self.speech_token_id)
            else:
                i = (zlib.crc32(word.encode("utf-8")) % (self._vocab - 3)) + 1
                self._decode_memory[i] = word
                out.append(i)
        return out

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        words = []
        for i in ids:
            i = int(i)
            if i in (self.pad_token_id, self.speech_token_id) or i < 0:
                continue
            words.append(self._decode_memory.get(i, f"<{i}>"))
        return " ".join(words)

    def batch_decode(self, idss, skip_special_tokens: bool = True):
        return [self.decode(ids) for ids in idss]


def load_tokenizer(path: Optional[str], vocab_size: int = 256):
    """Byte-level BPE for vocab.json/merges.txt checkpoints whose
    pre-tokenization is implemented (Qwen2/2.5 and classic GPT-2, selected
    from ``tokenizer_class``); ``HFTokenizer`` (which raises) for everything
    else, or always with PS_USE_HF_TOKENIZER=1; the stub without a path."""
    import json
    import os

    if path:
        if (
            os.environ.get("PS_USE_HF_TOKENIZER") != "1"
            and os.path.exists(os.path.join(path, "vocab.json"))
            and os.path.exists(os.path.join(path, "merges.txt"))
        ):
            klass = ""
            cfg_path = os.path.join(path, "tokenizer_config.json")
            if os.path.exists(cfg_path):
                with open(cfg_path, encoding="utf-8") as f:
                    klass = str(json.load(f).get("tokenizer_class", ""))
            # unknown classes may pre-tokenize differently (e.g. Llama's
            # digit handling) — those go to the wheel, not a silent guess
            if not klass or klass.startswith(("Qwen2", "GPT2")):
                return OwnBPETokenizer(path)
        return HFTokenizer(path)
    return StubTokenizer(vocab_size)
