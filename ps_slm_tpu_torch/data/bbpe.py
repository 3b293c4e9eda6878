r"""Byte-level BPE (GPT-2 family: Qwen2/Qwen2.5) over vocab.json + merges.txt.

A copy of ``ps_slm_tpu/data/bbpe.py`` (the port imports nothing of the JAX
package):

  * loads the standard ``vocab.json`` + ``merges.txt`` (and added special
    tokens) of any GPT-2-style checkpoint, including Qwen2.5's;
  * GPT-2 byte->unicode table, regex pre-tokenization (Qwen2's pattern by
    default, GPT-2's classic pattern selected from ``tokenizer_class``),
    ranked-pair merge loop with per-pretoken caching;
  * special tokens are matched before pre-tokenization;
  * byte-exact decode via the inverse byte table; ids the vocabulary lacks
    are skipped.

The JAX package compiles the patterns with the third-party ``regex``
module, whose ``\p{L}`` / ``\p{N}`` classes the standard ``re`` lacks.
The port compiles them with ``re`` (:func:`to_stdlib_pattern`): ``\p{L}``
and ``\p{N}`` become explicit character classes from the code-point
ranges of ``_unicode_classes.py``, generated from the ``regex`` module
(its Unicode version, not the interpreter's ``unicodedata``), and ``\s`` /
``\S`` the whitespace class ``regex`` uses (``re``'s ``\s`` also takes
U+001C-U+001F).  The tests hold every code point's class to ``regex``'s.
"""

from __future__ import annotations

import json
import os
import re
import unicodedata
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

from ._unicode_classes import LETTER_RANGES, NUMBER_RANGES

# Qwen2/2.5 pattern (transformers' PRETOKENIZE_REGEX for Qwen2: a single
# \p{N}, unlike cl100k's \p{N}{1,3}), in the ``regex`` module's syntax
QWEN_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)"
    r"|[^\r\n\p{L}\p{N}]?\p{L}+"
    r"|\p{N}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*"
    r"|\s*[\r\n]+"
    r"|\s+(?!\S)"
    r"|\s+"
)
# classic GPT-2 pattern (what `tokenizers`' ByteLevel pre-tokenizer uses)
GPT2_PATTERN = (
    r"'s|'t|'re|'ve|'m|'ll|'d"
    r"| ?\p{L}+| ?\p{N}+"
    r"| ?[^\s\p{L}\p{N}]+"
    r"|\s+(?!\S)|\s+"
)


@lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode table."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


# the whitespace ``regex`` matches with ``\s`` (Unicode White_Space), as
# the body of a character class
_WHITESPACE = r"\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"


@lru_cache(maxsize=None)
def _category_class(ranges: Tuple[Tuple[int, int], ...]) -> str:
    """The body of a character class (no brackets) of the code-point
    ranges ``ranges``."""
    return "".join(re.escape(chr(lo)) if lo == hi else f"{re.escape(chr(lo))}-{re.escape(chr(hi))}"
                   for lo, hi in ranges)


def to_stdlib_pattern(pattern: str) -> str:
    r"""Rewrite a ``regex``-module pattern that uses ``\p{L}``, ``\p{N}``,
    ``\s`` and ``\S`` into one the standard ``re`` compiles to the same
    matches: each class written out, inside a bracket expression or not."""
    classes = {"p{L}": _category_class(LETTER_RANGES), "p{N}": _category_class(NUMBER_RANGES),
               "s": _WHITESPACE}
    out = []
    i, in_class = 0, False
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\":
            name = next((k for k in classes if pattern.startswith(k, i + 1)), None)
            if name is not None:
                out.append(classes[name] if in_class else f"[{classes[name]}]")
                i += 1 + len(name)
                continue
            if pattern.startswith("S", i + 1) and not in_class:
                out.append(f"[^{_WHITESPACE}]")
                i += 2
                continue
            out.append(pattern[i:i + 2])
            i += 2
            continue
        if ch == "[" and not in_class:
            in_class = True
            out.append(ch)
            if pattern.startswith("^", i + 1):
                out.append("^")
                i += 1
        elif ch == "]" and in_class:
            in_class = False
            out.append(ch)
        else:
            out.append(ch)
        i += 1
    return "".join(out)


class ByteLevelBPE:
    """GPT-2-style byte-level BPE over vocab.json + merges.txt."""

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: List[Tuple[str, str]],
        special_tokens: Optional[List[str]] = None,
        pattern: str = QWEN_PATTERN,
        nfc: Optional[bool] = None,
    ):
        # Qwen2's tokenizer.json runs an NFC normalizer before
        # pre-tokenization; classic GPT-2 checkpoints have none.  Default
        # follows the pattern choice (same autoselection rule as
        # from_pretrained's tokenizer_class sniff).
        self.nfc = (pattern == QWEN_PATTERN) if nfc is None else nfc
        self.vocab = vocab
        self.inv_vocab = {i: t for t, i in vocab.items()}
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.pat = re.compile(to_stdlib_pattern(pattern))
        self.byte_enc = bytes_to_unicode()
        self.byte_dec = {c: b for b, c in self.byte_enc.items()}
        self._cache: Dict[str, List[str]] = {}
        self.special_tokens: Dict[str, int] = {}
        self._special_re = None
        if special_tokens:
            self.add_special_tokens(special_tokens)

    # -- construction ------------------------------------------------------

    @classmethod
    def from_pretrained(cls, path: str, pattern: Optional[str] = None
                        ) -> "ByteLevelBPE":
        """Load an HF checkpoint dir (vocab.json + merges.txt [+
        tokenizer_config.json added specials])."""
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                a, _, b = line.partition(" ")
                merges.append((a, b))
        specials: Dict[str, Optional[int]] = {}
        cfg_path = os.path.join(path, "tokenizer_config.json")
        cfg = {}
        if os.path.exists(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                cfg = json.load(f)
            # added_tokens_decoder maps EXPLICIT id -> {content: ...}; the
            # id keys are authoritative (they are the checkpoint's embedding
            # rows), never re-derived from enumeration order.
            added = cfg.get("added_tokens_decoder", {})
            for k, v in added.items():
                if isinstance(v, dict) and "content" in v:
                    specials[v["content"]] = int(k)
            for k in ("eos_token", "pad_token", "unk_token", "bos_token"):
                t = cfg.get(k)
                if isinstance(t, dict):
                    t = t.get("content")
                if t and t not in specials:
                    specials[t] = None
        if pattern is None:
            # transformers.models.qwen2 applies QWEN_PATTERN; classic GPT-2
            # family checkpoints use the ByteLevel pre-tokenizer pattern.
            klass = str(cfg.get("tokenizer_class", ""))
            pattern = GPT2_PATTERN if klass.startswith("GPT2") \
                else QWEN_PATTERN
        tok = cls(vocab, merges, pattern=pattern)
        if specials:
            tok.add_special_tokens(specials)
        return tok

    def add_special_tokens(self, tokens) -> None:
        """Register special tokens.  ``tokens`` is a list of strings (ids
        assigned as max-existing+1, matching HF fast-tokenizer behavior for
        genuinely new tokens) or a dict ``{content: id-or-None}`` carrying
        the checkpoint's explicit ids (``added_tokens_decoder`` keys)."""
        if not isinstance(tokens, dict):
            tokens = {t: None for t in tokens}
        for t, explicit in tokens.items():
            if explicit is not None:
                self.special_tokens[t] = int(explicit)
            elif t in self.vocab:
                self.special_tokens[t] = self.vocab[t]
            elif t not in self.special_tokens:
                nid = (
                    max(
                        max(self.vocab.values(), default=-1),
                        max(self.special_tokens.values(), default=-1),
                    ) + 1
                )
                self.special_tokens[t] = nid
        for t, i in self.special_tokens.items():
            self.inv_vocab.setdefault(i, t)
        parts = sorted(self.special_tokens, key=len, reverse=True)
        # empty alternation would compile to "()" which matches the empty
        # string and makes split() shred text into single characters
        self._special_re = re.compile(
            "(" + "|".join(re.escape(t) for t in parts) + ")"
        ) if parts else None

    # -- encode ------------------------------------------------------------

    def _bpe(self, pretoken: str) -> List[str]:
        """Merge loop over one pre-token (already byte-mapped)."""
        cached = self._cache.get(pretoken)
        if cached is not None:
            return cached
        parts = list(pretoken)
        while len(parts) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                r = self.ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            parts[best_i: best_i + 2] = [
                parts[best_i] + parts[best_i + 1]
            ]
        if len(self._cache) < 65536:
            self._cache[pretoken] = parts
        return parts

    def encode_ordinary(self, text: str) -> List[int]:
        """Encode ignoring special tokens."""
        if self.nfc and not text.isascii():
            # decomposed input (e.g. 'e' + U+0301) must produce the same
            # ids as its composed form — see the ``nfc`` init comment
            text = unicodedata.normalize("NFC", text)
        out: List[int] = []
        for m in self.pat.finditer(text):
            mapped = "".join(
                self.byte_enc[b] for b in m.group(0).encode("utf-8")
            )
            for part in self._bpe(mapped):
                tid = self.vocab.get(part)
                if tid is None:
                    # unknown byte-sequence: fall back to single bytes
                    out.extend(
                        self.vocab[c] for c in part if c in self.vocab
                    )
                else:
                    out.append(tid)
        return out

    def encode(self, text: str) -> List[int]:
        if not self._special_re:
            return self.encode_ordinary(text)
        out: List[int] = []
        for chunk in self._special_re.split(text):
            if not chunk:
                continue
            sid = self.special_tokens.get(chunk)
            if sid is not None:
                out.append(sid)
            else:
                out.extend(self.encode_ordinary(chunk))
        return out

    # -- decode ------------------------------------------------------------

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        special_ids = set(self.special_tokens.values())
        pieces: List[str] = []
        buf: List[int] = []

        def flush():
            if buf:
                pieces.append(bytes(buf).decode("utf-8", errors="replace"))
                buf.clear()

        for i in ids:
            i = int(i)
            tok = self.inv_vocab.get(i)
            if tok is None:
                continue
            if i in special_ids:
                flush()
                if not skip_special_tokens:
                    pieces.append(tok)
                continue
            buf.extend(self.byte_dec[c] for c in tok)
        flush()
        return "".join(pieces)

    @property
    def vocab_size(self) -> int:
        n = max(self.vocab.values(), default=-1)
        if self.special_tokens:
            n = max(n, max(self.special_tokens.values()))
        return n + 1
