"""Write ``ps_slm_tpu_torch/data/_unicode_classes.py``: the code-point
ranges of ``\\p{L}`` (letters) and ``\\p{N}`` (numbers) as the third-party
``regex`` module classes them.

The port's byte-level BPE compiles Qwen's pre-tokenizer pattern with the
standard ``re``, which lacks these classes; the table fixes them to the
``regex`` module's Unicode version, not the interpreter's ``unicodedata``.
Run from the repository root, where ``regex`` is installed:

    python scripts/gen_unicode_classes.py
"""

import os
import sys

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "ps_slm_tpu_torch", "data", "_unicode_classes.py")


def regex_version():
    from importlib.metadata import version

    return version("regex")


def regex_unicode_version():
    """The Unicode version the installed ``regex`` names in its metadata."""
    import re
    from importlib.metadata import metadata

    m = re.search(r"supports Unicode (\d+\.\d+\.\d+)", metadata("regex").get_payload() or "")
    return m.group(1) if m else "unknown"


def class_ranges(prop: str):
    """Sorted inclusive ``(lo, hi)`` ranges of every code point in
    ``\\p{prop}``, from one ``findall`` over a string of all of them."""
    import regex

    every = "".join(map(chr, range(sys.maxunicode + 1)))
    cps = [ord(c) for c in regex.findall(rf"\p{{{prop}}}", every)]
    ranges = []
    for cp in cps:
        if ranges and ranges[-1][1] == cp - 1:
            ranges[-1][1] = cp
        else:
            ranges.append([cp, cp])
    return tuple(map(tuple, ranges))


def render(letters, numbers) -> str:
    def table(name, ranges):
        rows = [f"    (0x{lo:05X}, 0x{hi:05X})," for lo, hi in ranges]
        return f"{name} = (\n" + "\n".join(rows) + "\n)\n"

    return (
        '"""Code-point ranges of ``\\\\p{L}`` and ``\\\\p{N}`` (inclusive), generated by\n'
        "``scripts/gen_unicode_classes.py`` from the ``regex`` module "
        f"{regex_version()}\n(Unicode {regex_unicode_version()}). Do not edit by hand.\n"
        '"""\n\n'
        f'UNICODE_VERSION = "{regex_unicode_version()}"\n'
        f'REGEX_VERSION = "{regex_version()}"\n\n'
        + table("LETTER_RANGES", letters) + "\n" + table("NUMBER_RANGES", numbers)
    )


def main():
    with open(OUT, "w") as f:
        f.write(render(class_ranges("L"), class_ranges("N")))
    print(OUT)


if __name__ == "__main__":
    main()
