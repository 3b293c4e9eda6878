"""PyTorch port: its copies of the WER scorer and the punctuation cleaner
against the JAX package's modules, on fixture files written to tmp_path
(mixed CJK / English / kana / hangul text, <tags>, punctuation, missing
and extra keys)."""

import io
import os
import subprocess
import sys

import pytest

from ps_slm_tpu.tools import clean_marks as jclean
from ps_slm_tpu.tools import wer as jwer
from ps_slm_tpu_torch.tools import clean_marks, wer

REF = (
    "u1\t今天天气很好，我们去公园。\n"
    "u2\tHello World, it's a <|en|> test!\n"
    "u3\tthe cat sat on the mat\n"
    "u4\tカタカナ と 한국어 mixed 123\n"
    "u5\t<noise> uh hello\n"
    "u6\tmissing in the hypothesis\n"
)
HYP = (
    "u1\t今天天很好我们去公园了\n"
    "u2\thello word its a <|en|> test\n"
    "u3\tthe cat sit on mat\n"
    "u4\tカタカナ 한국 mixed 124\n"
    "u5\tuh hello there\n"
    "u7\tan extra key\n"
)
CLUSTER = "<Animals> CAT MAT </Animals>\n<Greet> HELLO WORLD </Greet>\n"
IGNORE = "UH\n<NOISE>\n"
SPLIT = "IT'S IT IS\n"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _files(tmp_path):
    paths = {}
    for name, text in (("ref", REF), ("hyp", HYP), ("cluster", CLUSTER), ("ignore", IGNORE),
                       ("split", SPLIT)):
        paths[name] = tmp_path / name
        paths[name].write_text(text, "utf-8")
    return paths


@pytest.mark.parametrize("options", [
    [], ["--char=1", "-v=1"], ["--char=0", "-v=1"], ["--cs=1", "-v=1", "--rt=0"],
    ["-v=1", "--ig={ignore}", "--splitfile={split}", "--cluster={cluster}"],
    ["-v=1", "--maxw=3", "--padding-symbol=underline"], ["--padding-symbol=dots"],
])
def test_wer_cli_prints_what_the_jax_scorer_prints(tmp_path, options):
    paths = _files(tmp_path)
    argv = [o.format(**paths) for o in options] + [str(paths["ref"]), str(paths["hyp"])]
    outs = [subprocess.run([sys.executable, "-m", module.__name__, *argv], cwd=ROOT,
                           capture_output=True, text=True, timeout=60)
            for module in (jwer, wer)]
    want, got = ((r.returncode, r.stdout) for r in outs)
    assert got == want and want[1]


def test_wer_scores_and_alignment_match(tmp_path):
    paths = _files(tmp_path)
    got, want = io.StringIO(), io.StringIO()
    kw = dict(verbose=True, cluster_file=str(paths["cluster"]))
    r_got = wer.score_files(str(paths["ref"]), str(paths["hyp"]), stream=got, **kw)
    r_want = jwer.score_files(str(paths["ref"]), str(paths["hyp"]), stream=want, **kw)
    assert r_got == r_want and got.getvalue() == want.getvalue()
    assert 0 < r_got["wer"] < 100 and "Mandarin" in got.getvalue() and "English" in got.getvalue()
    for text in ("今天 hello <tag> it's 123!", "カタカナ, 한국어"):
        assert wer.characterize(text) == jwer.characterize(text)


def test_clean_marks_cleans_as_the_jax_cleaner(tmp_path, capsys):
    text = REF + "no tab line, kept as is!\n" + "u8\tem——dash… 【括号】 «x» \x07bell\n"
    outs = []
    for module in (jclean, clean_marks):
        path = tmp_path / f"decode_{module.__name__.split('.')[0]}"
        path.write_text(text, "utf-8")
        rc = module.main([str(path)])
        outs.append((rc, capsys.readouterr().out, path.read_text("utf-8")))
    assert outs[0] == outs[1]
    assert "，" not in outs[1][2] and "——" in outs[1][2]
    assert clean_marks.main([]) == jclean.main([]) == 2
