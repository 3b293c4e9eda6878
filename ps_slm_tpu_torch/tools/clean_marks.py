"""In-place punctuation stripper for ``key\\ttext`` decode files.

A copy of ``ps_slm_tpu/tools/clean_marks.py`` (the port imports nothing of
the JAX package); tests hold the two to the same output.

Same scoring-prep semantics as the reference's cleaner step
(``scripts/decode_sensevoice.sh:94-96``): drop ASCII+CJK punctuation,
unprintable characters, and characters without a Unicode name from the text
column; keys and tab-less lines pass through untouched.

Fidelity note: the reference's punctuation set lists ``'——'`` — a two-char
string that a single-character membership test can never match — so em
dashes survive cleaning there; this implementation reproduces that (single
``—`` is deliberately absent from ``_STRIP``).
"""

from __future__ import annotations

import functools
import pathlib
import string
import sys
import unicodedata

_STRIP = frozenset(
    string.punctuation + "，。！？：；、（）“”‘’【】《》…\\"
)


@functools.lru_cache(maxsize=None)
def _keep(ch: str) -> bool:
    if ch in _STRIP or not ch.isprintable():
        return False
    try:
        unicodedata.name(ch)
    except ValueError:
        return False
    return True


def clean_text(text: str) -> str:
    return "".join(filter(_keep, text))


def clean_line(line: str) -> str:
    key, tab, text = line.partition("\t")
    return key + tab + clean_text(text) if tab else line


def clean_file(path: str) -> None:
    p = pathlib.Path(path).expanduser()
    if not p.exists():
        print(f"file does not exist: {p}")
        raise SystemExit(1)
    cleaned = [clean_line(ln) for ln in p.read_text("utf-8").splitlines()]
    p.write_text("\n".join(cleaned) + "\n", "utf-8")


# scoring scripts may import the reference-era name
strip_all_punct = clean_file


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("usage: python -m ps_slm_tpu_torch.tools.clean_marks <file>")
        return 2
    clean_file(argv[0])
    print("cleaned.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
