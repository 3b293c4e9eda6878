"""WER/CER scorer over ``key\\ttext`` files.

A copy of ``ps_slm_tpu/tools/wer.py`` (the port imports nothing of the
JAX package); tests hold the two to the same output.

Functional equivalent of the reference's vendored wenet Levenshtein tool
(``Multitask/utils/wenet_compute_cer.py``, invoked as
``python utils/wenet_compute_cer.py --char=1 -v=1 gt pred`` at
``scripts/decode_sensevoice.sh:94-97``).  Same semantics, fresh
implementation:

  * unicode characterization: CJK codepoints are single tokens, latin /
    digit runs are word tokens, ``<tag>`` markers are single tokens,
    punctuation is dropped (``--char=1``); ``--char=0`` splits on whitespace
  * case-insensitive by default (wenet upper-cases)
  * full alignment printing with ``-v 1``
  * per-language-cluster (Mandarin/English/Other) statistics
  * summary: corrections / substitutions / deletions / insertions and
    WER = (S+D+I) / (C+S+D) * 100

CLI: ``python -m ps_slm_tpu_torch.tools.wer [--char=1] [-v=1] ref hyp``.  Full
flag surface: ``--char --v --cs --rt --ig= --splitfile= --maxw=
--padding-symbol= --cluster=`` (wenet_compute_cer.py:296-380).
"""

from __future__ import annotations

import re
import sys
import unicodedata
from typing import Dict, List, Optional


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0xF900 <= cp <= 0xFAFF
        or 0x3040 <= cp <= 0x30FF   # kana
        or 0xAC00 <= cp <= 0xD7AF   # hangul
    )


def characterize(text: str) -> List[str]:
    """Tokenize: CJK per-char, latin/digit runs as words, <tags> kept."""
    tokens: List[str] = []
    i = 0
    while i < len(text):
        ch = text[i]
        if ch.isspace():
            i += 1
            continue
        if ch == "<":
            j = text.find(">", i)
            if j != -1:
                tokens.append(text[i: j + 1])
                i = j + 1
                continue
            i += 1
            continue
        if _is_cjk(ch):
            tokens.append(ch)
            i += 1
            continue
        if ch.isalnum() or ch in "'’":
            j = i
            while j < len(text) and (text[j].isalnum() or text[j] in "'’"):
                j += 1
            tokens.append(text[i:j])
            i = j
            continue
        i += 1  # punctuation dropped
    return tokens


def strip_tags(token: str) -> str:
    """Drop ``<...>`` spans inside a token (wenet stripoff_tags; on by
    default there via the module-global ``remove_tag = True``)."""
    out = []
    i = 0
    while i < len(token):
        if token[i] == "<":
            j = token.find(">", i)
            if j == -1:
                break
            i = j + 1
        else:
            out.append(token[i])
            i += 1
    return "".join(out)


def normalize(
    tokens: List[str], ignore_words=frozenset(), case_sensitive: bool = False,
    split: Optional[Dict[str, List[str]]] = None, remove_tag: bool = True,
) -> List[str]:
    """wenet ``normalize``: upper-case, drop ignore words, strip tags,
    expand split-file words."""
    out: List[str] = []
    for token in tokens:
        x = token if case_sensitive else token.upper()
        if x in ignore_words:
            continue
        if remove_tag:
            x = strip_tags(x)
        if not x:
            continue
        if split and x in split:
            out.extend(split[x])
        else:
            out.append(x)
    return out


def default_cluster(token: str) -> str:
    """Language cluster of a token (wenet default_cluster semantics)."""
    if not token:
        return "Other"
    ch = token[0]
    if _is_cjk(ch):
        try:
            name = unicodedata.name(ch)
        except ValueError:
            return "Other"
        if "CJK" in name:
            return "Mandarin"
        if "HIRAGANA" in name or "KATAKANA" in name:
            return "Japanese"
        if "HANGUL" in name:
            return "Korean"
        return "Other"
    if ch.isascii() and ch.isalpha():
        return "English"
    return "Other"


class Calculator:
    """Levenshtein alignment + per-token statistics accumulator."""

    def __init__(self):
        self.data: Dict[str, Dict[str, int]] = {}

    def _rec(self, token: str) -> Dict[str, int]:
        if token not in self.data:
            self.data[token] = {"all": 0, "cor": 0, "sub": 0, "ins": 0, "del": 0}
        return self.data[token]

    def calculate(
        self, lab: List[str], rec: List[str]
    ) -> Dict:
        """Align `rec` (hypothesis) to `lab` (reference).

        Returns {"lab": aligned_ref, "rec": aligned_hyp, "all", "cor",
        "sub", "ins", "del"} with '' marking gaps.
        """
        L, R = len(lab), len(rec)
        # dp[i][j]: cost; back[i][j]: 0 diag-cor, 1 diag-sub, 2 up-del, 3 left-ins
        INF = 10 ** 9
        dp = [[0] * (R + 1) for _ in range(L + 1)]
        back = [[0] * (R + 1) for _ in range(L + 1)]
        for i in range(1, L + 1):
            dp[i][0] = i
            back[i][0] = 2
        for j in range(1, R + 1):
            dp[0][j] = j
            back[0][j] = 3
        for i in range(1, L + 1):
            for j in range(1, R + 1):
                same = lab[i - 1] == rec[j - 1]
                diag = dp[i - 1][j - 1] + (0 if same else 1)
                up = dp[i - 1][j] + 1
                left = dp[i][j - 1] + 1
                best = min(diag, up, left)
                dp[i][j] = best
                if best == diag:
                    back[i][j] = 0 if same else 1
                elif best == up:
                    back[i][j] = 2
                else:
                    back[i][j] = 3

        # backtrace
        a_lab: List[str] = []
        a_rec: List[str] = []
        counts = {"all": 0, "cor": 0, "sub": 0, "ins": 0, "del": 0}
        i, j = L, R
        while i > 0 or j > 0:
            op = back[i][j]
            if i > 0 and j > 0 and op in (0, 1):
                a_lab.append(lab[i - 1])
                a_rec.append(rec[j - 1])
                rec_tok = self._rec(lab[i - 1])
                if op == 0:
                    counts["cor"] += 1
                    rec_tok["cor"] += 1
                else:
                    counts["sub"] += 1
                    rec_tok["sub"] += 1
                counts["all"] += 1
                rec_tok["all"] += 1
                i, j = i - 1, j - 1
            elif i > 0 and op == 2:
                a_lab.append(lab[i - 1])
                a_rec.append("")
                counts["del"] += 1
                counts["all"] += 1
                t = self._rec(lab[i - 1])
                t["del"] += 1
                t["all"] += 1
                i -= 1
            else:
                a_lab.append("")
                a_rec.append(rec[j - 1])
                counts["ins"] += 1
                self._rec(rec[j - 1])["ins"] += 1
                j -= 1
        a_lab.reverse()
        a_rec.reverse()
        return {"lab": a_lab, "rec": a_rec, **counts}

    def overall(self, tokens: Optional[List[str]] = None) -> Dict[str, int]:
        keys = tokens if tokens is not None else list(self.data)
        out = {"all": 0, "cor": 0, "sub": 0, "ins": 0, "del": 0}
        for t in keys:
            if t in self.data:
                for k in out:
                    out[k] += self.data[t][k]
        return out

    def cluster(self, cluster_name: str) -> Dict[str, int]:
        toks = [t for t in self.data if default_cluster(t) == cluster_name]
        return self.overall(toks)


def width(string: str) -> int:
    """Display width of a token in the alignment printout: wide (east-asian
    A/F/W) codepoints count 2 columns, everything else 1
    (wenet_compute_cer.py:244-245 semantics)."""
    return sum(1 + (unicodedata.east_asian_width(c) in "AFW") for c in string)


def read_cluster_file(path: str) -> List:
    """Parse a wenet cluster file: ``<Name> tok tok ... </Name>`` blocks
    (wenet_compute_cer.py:522-549).  Returns [(name, [tokens...]), ...]."""
    clusters: List = []
    name = ""
    toks: List[str] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            for token in line.rstrip("\n").split():
                if (
                    token.startswith("</") and token.endswith(">")
                    and token[2:-1] == name
                ):
                    clusters.append((name, toks))
                    name, toks = "", []
                elif token.startswith("<") and token.endswith(">") and not name:
                    name = token[1:-1]
                    toks = []
                else:
                    toks.append(token)
    return clusters


def wer_percent(c: Dict[str, int]) -> float:
    denom = c["cor"] + c["sub"] + c["del"]
    if denom == 0:
        return 0.0
    return (c["sub"] + c["del"] + c["ins"]) / denom * 100.0


def _write_alignment(
    stream, lab: List[str], rec: List[str], *,
    max_words_per_line: Optional[int] = None, padding_symbol: str = " ",
) -> None:
    """Column-aligned lab/rec printout: each position padded to the wider of
    the two tokens (east-asian-width aware), wrapped every
    ``max_words_per_line`` positions, gaps filled with ``padding_symbol``
    (wenet_compute_cer.py:440-488 semantics)."""
    pad_lab = [max(width(a), width(b)) - width(a) for a, b in zip(lab, rec)]
    pad_rec = [max(width(a), width(b)) - width(b) for a, b in zip(lab, rec)]
    n = len(lab)
    maxw = max_words_per_line if max_words_per_line else n or 1
    lo = 0
    while lo < n or lo == 0:
        hi = min(n, lo + maxw)
        stream.write("lab: ")
        for idx in range(lo, hi):
            stream.write(lab[idx] + padding_symbol * pad_lab[idx] + " ")
        stream.write("\nrec: ")
        for idx in range(lo, hi):
            stream.write(rec[idx] + padding_symbol * pad_rec[idx] + " ")
        stream.write("\n\n")
        lo = hi
        if lo >= n:
            break


def read_keyed_file(path: str) -> Dict[str, str]:
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            if "\t" in line:
                key, text = line.split("\t", 1)
            else:
                parts = line.split(maxsplit=1)
                key = parts[0]
                text = parts[1] if len(parts) > 1 else ""
            out[key.strip()] = text.strip()
    return out


def score_files(
    ref_path: str, hyp_path: str, *, char: bool = True,
    case_sensitive: bool = False, verbose: bool = False,
    remove_tag: bool = True, ignore_words=frozenset(),
    split: Optional[Dict[str, List[str]]] = None,
    max_words_per_line: Optional[int] = None,
    padding_symbol: str = " ",
    cluster_file: Optional[str] = None,
    stream=sys.stdout,
) -> Dict:
    refs = read_keyed_file(ref_path)
    hyps = read_keyed_file(hyp_path)
    if not case_sensitive:
        ignore_words = {w.upper() for w in ignore_words}
    calc = Calculator()
    missing = 0
    for key, ref_text in refs.items():
        hyp_text = hyps.get(key)
        if hyp_text is None:
            missing += 1
            hyp_text = ""
        if not case_sensitive:
            ref_text = ref_text.upper()
            hyp_text = hyp_text.upper()
        lab = characterize(ref_text) if char else ref_text.split()
        rec = characterize(hyp_text) if char else hyp_text.split()
        lab = normalize(lab, ignore_words, case_sensitive, split, remove_tag)
        rec = normalize(rec, ignore_words, case_sensitive, split, remove_tag)
        result = calc.calculate(lab, rec)
        if verbose:
            stream.write(f"utt: {key}\n")
            stream.write(
                "WER: {:4.2f} % N={} C={} S={} D={} I={}\n".format(
                    wer_percent(result), result["all"], result["cor"],
                    result["sub"], result["del"], result["ins"],
                )
            )
            _write_alignment(
                stream, result["lab"], result["rec"],
                max_words_per_line=max_words_per_line,
                padding_symbol=padding_symbol,
            )

    overall = calc.overall()
    stream.write("=" * 60 + "\n")
    stream.write(
        "Overall -> {:4.2f} % N={} C={} S={} D={} I={}\n".format(
            wer_percent(overall), overall["all"], overall["cor"],
            overall["sub"], overall["del"], overall["ins"],
        )
    )
    for name in ("Mandarin", "English", "Japanese", "Korean", "Other"):
        c = calc.cluster(name)
        if c["all"] or c["ins"]:
            stream.write(
                "{} -> {:4.2f} % N={} C={} S={} D={} I={}\n".format(
                    name, wer_percent(c), c["all"], c["cor"], c["sub"],
                    c["del"], c["ins"],
                )
            )
    if cluster_file:
        for name, toks in read_cluster_file(cluster_file):
            c = calc.overall(toks)
            stream.write(
                "{} -> {:4.2f} % N={} C={} S={} D={} I={}\n".format(
                    name, wer_percent(c), c["all"], c["cor"], c["sub"],
                    c["del"], c["ins"],
                )
            )
    if missing:
        stream.write(f"(missing hypotheses for {missing} utts)\n")
    return {"wer": wer_percent(overall), **overall}


def _read_ignore_file(path: str) -> set:
    out = set()
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.add(line)
    return out


def _read_split_file(path: str) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            words = line.strip().split()
            if len(words) >= 2:
                out[words[0]] = words[1:]
    return out


def main(argv=None):
    """Option surface mirrors the wenet CLI (wenet_compute_cer.py:296-380):
    --char, --v, --cs, --rt (tag strip, default ON), --ig=<file>,
    --splitfile=<file>, --maxw=<n>, --padding-symbol={space,underline},
    --cluster=<file>."""
    argv = argv if argv is not None else sys.argv[1:]
    char = True
    verbose = False
    case_sensitive = False
    remove_tag = True
    ignore_words: set = set()
    split: Optional[Dict[str, List[str]]] = None
    max_words_per_line: Optional[int] = None
    padding_symbol = " "
    cluster_file: Optional[str] = None
    paths = []
    for a in argv:
        if a.startswith("--char"):
            char = a.split("=")[-1] in ("1", "true", "")
        elif a.startswith("--ig="):
            ignore_words = _read_ignore_file(a.split("=", 1)[1])
        elif a.startswith("--splitfile="):
            split = _read_split_file(a.split("=", 1)[1])
        elif a.startswith("--maxw="):
            max_words_per_line = int(a.split("=", 1)[1])
        elif a.startswith("--padding-symbol"):
            # wenet accepts only the two named symbols (':376-378); anything
            # else (or a bare flag) is a usage error, not a silent fallback
            val = a.split("=", 1)[1].lower() if "=" in a else ""
            if val == "underline":
                padding_symbol = "_"
            elif val == "space":
                padding_symbol = " "
            else:
                print(
                    "--padding-symbol must be 'space' or 'underline' "
                    f"(got {val!r})"
                )
                return 2
        elif a.startswith("--cluster="):
            cluster_file = a.split("=", 1)[1]
        elif a.startswith("--rt"):
            remove_tag = a.split("=")[-1] in ("1", "true", "")
        elif a.startswith("-v") or a.startswith("--v"):
            verbose = a.split("=")[-1] in ("1", "true", "-v", "")
        elif a.startswith("--cs"):
            case_sensitive = a.split("=")[-1] in ("1", "true")
        else:
            paths.append(a)
    if len(paths) != 2:
        print(
            "usage: python -m ps_slm_tpu_torch.tools.wer [--char=1] [-v=1] "
            "[--cs=0] [--rt=1] [--ig=ignore_file] [--splitfile=splits] "
            "[--maxw=n] [--padding-symbol=space|underline] "
            "[--cluster=cluster_file] ref hyp"
        )
        return 2
    if split and not case_sensitive:
        split = {k: [w.upper() for w in v] for k, v in split.items()}
    score_files(
        paths[0], paths[1], char=char, verbose=verbose,
        case_sensitive=case_sensitive, remove_tag=remove_tag,
        ignore_words=ignore_words, split=split,
        max_words_per_line=max_words_per_line,
        padding_symbol=padding_symbol, cluster_file=cluster_file,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
