"""PyTorch port: the host data pipeline against the JAX package's.

The config parser, the audio readers (WAV, Kaldi ark, FLAC, header-only
lengths, resampling), the tokenizers (byte-level BPE, sentencepiece BPE,
the stub) and the dataset's batches are copies; each is held equal, bit
for bit or id for id, to the JAX package's on the same files and text,
made here from a numpy seed.
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest

from ps_slm_tpu import config as jconfig
from ps_slm_tpu.data import audio_io as jaudio
from ps_slm_tpu.data import bbpe as jbbpe
from ps_slm_tpu.data import dataset as jdataset
from ps_slm_tpu.data import flac as jflac
from ps_slm_tpu.data import spm as jspm
from ps_slm_tpu.data import tokenizer as jtok
from ps_slm_tpu_torch import config
from ps_slm_tpu_torch.data import audio_io, bbpe, dataset, flac, spm, tokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DECODE_SH_ARGV = [
    "++model_config.llm_path=/models/Qwen2.5-1.5B-Instruct",
    "++model_config.llm_dim=1536",
    "++model_config.encoder_path=/models/SenseVoiceSmall",
    "++model_config.encoder_dim=25055",
    "++model_config.encoder_projector=linear-silu",
    "++train_config.ctc_posterior=true",
    "++train_config.do_psd=true",
    "++train_config.num_beams=4",
    "++train_config.max_new_tokens=200",
    "++dataset_config.multitask_prompt_path=conf/multiprompt.jsonl",
    "++dataset_config.test_scp_file_path=/data/test/",
    "ckpt_path=exp/text_only/step_15000/pytorch_model.bin",
    "decode_log=exp/decode/test",
]

TEXT = [
    "Hello, world! It's a test: 12345 apples cost $3.50.",
    "  leading spaces,\ttabs\nand new lines\r\n  ",
    "中文测试，你好世界。混合 English 和 数字 42",
    "Ünïcödé café naïve — “quotes” ‘single’ … ½ ² Ⅻ",
    "日本語のテキスト、カタカナとひらがな。한국어 문장입니다.",
    "emoji 😀🎉 and symbols ©®™ ∑∫√ <|im_start|>user\n<speech><|im_end|>",
    "é decomposed vs é composed; I'M YOU'RE we'll they'd",
    "\x1c\x1d odd \x1f separators 　 ideographic   thin",
]


@pytest.mark.parametrize("extra", [
    [],
    ["++train_config.num_beams=1", "++train_config.mixed_precision=false",
     "++dataset_config.fbank.lfr_m=5", "++train_config.val_batch_size=3",
     "++train_config.batching_strategy=padding", "++dataset_config.append_info_tasks=[\"a\",\"b\"]",
     '++model_config.encoder_config_overrides={"input_size": 560}', "--local_rank",
     "train_config.top_p=0.9", "++dataset_config.waveform_dtype=float32"],
])
def test_parse_cli_matches_jax_on_shared_fields(extra, tmp_path):
    cfg_file = tmp_path / "c.json"
    cfg_file.write_text(json.dumps({"train_config": {"seed": 7}, "decode_log": "x"}))
    argv = ["--config", str(cfg_file)] + DECODE_SH_ARGV + extra
    got = config.to_dict(config.parse_cli(argv))
    want = config.to_dict(jconfig.parse_cli(argv))
    assert set(got) == set(want)
    for key, value in got.items():
        if isinstance(value, dict):
            assert set(value) <= set(want[key]), key
            assert value == {k: want[key][k] for k in value}, key
        else:
            assert value == want[key], key
    with pytest.raises(KeyError):
        config.parse_cli(["++train_config.no_such_knob=1"])


def test_config_defaults_equal_jax():
    def leaves(d, prefix=""):
        for k, v in d.items():
            if isinstance(v, dict) and k != "encoder_config_overrides":
                yield from leaves(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v

    want = dict(leaves(config.to_dict(jconfig.RunConfig())))
    got = dict(leaves(config.to_dict(config.RunConfig())))
    assert {k: want[k] for k in got} == got


# the JAX configs' fields that belong to a ROADMAP.md queue 1 item not
# ported yet (the port has no such field; an override of one is refused):
# none since the parallelism slice brought fsdp_min_size and pp_microbatches
LATER_FIELDS = {}


def _config_fields(cfg, prefix=""):
    for f in dataclasses.fields(cfg):
        value = getattr(cfg, f.name)
        if dataclasses.is_dataclass(value):
            yield from _config_fields(value, f"{prefix}{f.name}.")
        else:
            yield f"{prefix}{f.name}", value


def test_every_jax_config_field_parses_or_names_its_roadmap_item():
    """Every field of the JAX configs takes an override in the port, to
    the JAX parser's value, or is in ``LATER_FIELDS`` under the title of
    the ROADMAP.md queue 1 item that brings it (and is refused)."""
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        roadmap = f.read()
    queue1 = roadmap[roadmap.index("### Queue 1"):roadmap.index("### Queue 2")]
    seen = set()
    for key, default in _config_fields(jconfig.RunConfig()):
        seen.add(key)
        arg = f"++{key}={json.dumps(default) if isinstance(default, (list, dict)) else default}"
        want = jconfig.parse_cli([arg])
        if key in LATER_FIELDS:
            assert f"**{LATER_FIELDS[key]}.**" in queue1, key
            with pytest.raises(KeyError):
                config.parse_cli([arg])
            continue
        got = config.parse_cli([arg])
        section, _, name = key.rpartition(".")
        owner = lambda c: functools.reduce(getattr, section.split("."), c) if section else c  # noqa: E731
        assert getattr(owner(got), name) == getattr(owner(want), name), key
    assert set(LATER_FIELDS) <= seen
    assert config.parse_cli(["++model_config.llm_name=qwen"]).model_config.llm_name == "qwen"
    assert config.parse_cli(["++train_config.model_name=m"]).train_config.model_name == "m"


# ----------------------------------------------------------------------------
# audio readers
# ----------------------------------------------------------------------------

def _wav_bytes(rate, pcm, channels=1, extra_chunk=False):
    data = pcm.astype("<i2").tobytes()
    fmt = (b"fmt " + (16).to_bytes(4, "little") + (1).to_bytes(2, "little")
           + channels.to_bytes(2, "little") + rate.to_bytes(4, "little")
           + (rate * 2 * channels).to_bytes(4, "little") + (2 * channels).to_bytes(2, "little")
           + (16).to_bytes(2, "little"))
    chunks = fmt + (b"LIST" + (3).to_bytes(4, "little") + b"abc\x00" if extra_chunk else b"")
    chunks += b"data" + len(data).to_bytes(4, "little") + data
    return b"RIFF" + (4 + len(chunks)).to_bytes(4, "little") + b"WAVE" + chunks


@pytest.fixture(scope="module")
def audio_files(tmp_path_factory):
    """WAV (mono, stereo with an odd chunk, 8 kHz), a Kaldi wav-ark, a
    Kaldi float matrix ark and FLAC files (16 kHz mono, 8 kHz stereo)."""
    d = tmp_path_factory.mktemp("audio")
    rng = np.random.default_rng(0)
    paths = {}
    pcm = rng.integers(-32768, 32768, size=7001).astype(np.int16)
    (d / "mono.wav").write_bytes(_wav_bytes(16000, pcm))
    paths["mono.wav"] = str(d / "mono.wav")
    st = rng.integers(-20000, 20000, size=(3001, 2)).astype(np.int16)
    (d / "stereo.wav").write_bytes(_wav_bytes(16000, st.reshape(-1), channels=2, extra_chunk=True))
    paths["stereo.wav"] = str(d / "stereo.wav")
    (d / "low.wav").write_bytes(_wav_bytes(8000, pcm[:4003]))
    paths["low.wav"] = str(d / "low.wav")
    entries = {f"u{i}": (16000, rng.normal(size=int(rng.integers(300, 5000))).astype(np.float32) * 0.2)
               for i in range(3)}
    offsets = jaudio.write_kaldi_wav_ark(str(d / "wav.ark"), entries)
    for k, off in offsets.items():
        paths[k] = f"{d / 'wav.ark'}:{off}"
    mat = rng.normal(size=(7, 5)).astype("<f4")
    with open(d / "feats.ark", "wb") as f:
        f.write(b"utt ")
        paths["feats"] = (str(d / "feats.ark"), f.tell())
        f.write(b"\x00BFM \x04" + (7).to_bytes(4, "little") + b"\x04" + (5).to_bytes(4, "little")
                + mat.tobytes())
    x = (rng.normal(size=9000) * 0.1).astype(np.float32)
    jflac.write_flac(str(d / "a.flac"), 16000, x, block_size=4096)
    paths["a.flac"] = str(d / "a.flac")
    xs = (rng.normal(size=(5000, 2)) * 0.1).astype(np.float32)
    jflac.write_flac(str(d / "b.flac"), 8000, xs, block_size=1152)
    paths["b.flac"] = str(d / "b.flac")
    return paths


@pytest.mark.parametrize("name", ["mono.wav", "stereo.wav", "low.wav", "u0", "u1", "u2",
                                  "a.flac", "b.flac"])
def test_audio_readers_equal_jax(audio_files, name):
    path = audio_files[name]
    got, want = audio_io.load_audio(path), jaudio.load_audio(path)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert audio_io.audio_num_samples(path) == jaudio.audio_num_samples(path) == len(want)
    fpath, off = audio_io.parse_path(path)
    reader = audio_io.read_flac if name.endswith(".flac") else audio_io.read_wav
    jreader = jaudio.read_flac if name.endswith(".flac") else jaudio.read_wav
    (r1, a1), (r2, a2) = reader(fpath, off), jreader(fpath, off)
    assert r1 == r2 and np.array_equal(a1, a2)


def test_kaldi_matrix_and_flac_stream_info_equal_jax(audio_files):
    path, off = audio_files["feats"]
    assert np.array_equal(audio_io.read_kaldi_matrix(path, off), jaudio.read_kaldi_matrix(path, off))
    for name in ("a.flac", "b.flac"):
        assert flac.stream_info(audio_files[name]) == jflac.stream_info(audio_files[name])


def test_flac_writer_equals_jax_and_round_trips(tmp_path):
    rng = np.random.default_rng(1)
    x = np.round(rng.normal(size=6000) * 3000).astype(np.float32) / 32768.0
    flac.write_flac(str(tmp_path / "p.flac"), 16000, x)
    jflac.write_flac(str(tmp_path / "j.flac"), 16000, x)
    assert (tmp_path / "p.flac").read_bytes() == (tmp_path / "j.flac").read_bytes()
    rate, y = flac.read_flac(str(tmp_path / "p.flac"))
    assert rate == 16000 and np.array_equal(y, x)


def test_native_helper_absent_means_pure_python(monkeypatch):
    monkeypatch.setenv("PS_NATIVE_LIB", "/nonexistent/libps_native.so")
    from ps_slm_tpu_torch.data import _native_lib

    assert _native_lib.find_native_lib() is None


# ----------------------------------------------------------------------------
# tokenizers
# ----------------------------------------------------------------------------

def _train_merges(text, rounds=300):
    """Byte-level BPE merges learned from ``text`` (most frequent pair
    first), so the test vocabulary merges real sub-words."""
    enc = jbbpe.bytes_to_unicode()
    words = [[enc[b] for b in w.encode()] for t in text for w in t.split()] * 3
    vocab = {c: b for b, c in enc.items()}
    merges = []
    for _ in range(rounds):
        counts = {}
        for w in words:
            for a, b in zip(w, w[1:]):
                counts[(a, b)] = counts.get((a, b), 0) + 1
        if not counts:
            break
        pair = max(sorted(counts), key=lambda p: counts[p])
        merges.append(pair)
        vocab.setdefault(pair[0] + pair[1], len(vocab))
        words = [_merge(w, pair) for w in words]
    return vocab, merges


def _merge(w, pair):
    out, i = [], 0
    while i < len(w):
        if i + 1 < len(w) and (w[i], w[i + 1]) == pair:
            out.append(w[i] + w[i + 1])
            i += 2
        else:
            out.append(w[i])
            i += 1
    return out


@pytest.fixture(scope="module")
def bpe_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("bpe")
    vocab, merges = _train_merges(TEXT)
    n = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False), encoding="utf-8")
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges), encoding="utf-8")
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "Qwen2Tokenizer", "eos_token": "<|im_end|>",
        "pad_token": "<|endoftext|>",
        "added_tokens_decoder": {str(n + i): {"content": t, "special": True} for i, t in
                                 enumerate(["<|endoftext|>", "<|im_start|>", "<|im_end|>"])},
    }))
    return str(d)


@pytest.mark.parametrize("pattern", ["QWEN_PATTERN", "GPT2_PATTERN"])
def test_stdlib_pattern_matches_regex_module(pattern):
    import regex

    src = getattr(bbpe, pattern)
    assert src == getattr(jbbpe, pattern)
    import re

    ours, theirs = re.compile(bbpe.to_stdlib_pattern(src)), regex.compile(src)
    rng = np.random.default_rng(0)
    alphabet = list("aZé中ア한 1٣½\t\n\r\x1c　 .,!'s'LL-_😀") + [" ", "  "]
    samples = TEXT + ["".join(rng.choice(alphabet, size=40)) for _ in range(300)]
    for t in samples:
        assert ours.findall(t) == theirs.findall(t), repr(t)


@pytest.mark.parametrize("cls", [r"\p{L}", r"\p{N}", r"\s"])
def test_unicode_classes_equal_regex_module_on_every_code_point(cls):
    """Each class the port writes out for ``re`` takes exactly the code
    points the ``regex`` module's takes, over all of 0..0x10FFFF (one
    ``findall`` over a string of every code point)."""
    import re
    import sys

    import regex

    every = "".join(map(chr, range(sys.maxunicode + 1)))
    assert re.findall(bbpe.to_stdlib_pattern(cls), every) == regex.findall(cls, every)


def test_unicode_17_ideographs_pretokenize_as_jax(bpe_dir):
    """A CJK Extension I ideograph (Unicode 17.0, unassigned in the
    interpreter's 15.0 tables) joins its neighbours in one pre-token, as
    in the JAX package, and the ids agree."""
    text = "我们\U0002EBF0的"
    ours = bbpe.ByteLevelBPE({}, []).pat.findall(text)
    assert ours == jbbpe.ByteLevelBPE({}, []).pat.findall(text) == [text]
    assert tokenizer.load_tokenizer(bpe_dir).encode(text) == jtok.load_tokenizer(bpe_dir).encode(text)


def test_byte_level_bpe_equals_jax(bpe_dir):
    got = tokenizer.load_tokenizer(bpe_dir)
    want = jtok.load_tokenizer(bpe_dir)
    assert type(got).__name__ == type(want).__name__ == "OwnBPETokenizer"
    for attr in ("speech_token_id", "eos_token_id", "pad_token_id", "vocab_size"):
        assert getattr(got, attr) == getattr(want, attr), attr
    rng = np.random.default_rng(0)
    for t in TEXT:
        ids = got.encode(t)
        assert ids == want.encode(t), t
        assert got.decode(ids) == want.decode(ids)
        assert got.decode(ids, False) == want.decode(ids, False)
        # ids the vocabulary lacks are skipped, as in the JAX package
        noisy = ids + rng.integers(0, 3 * got.vocab_size, size=20).tolist()
        assert got.batch_decode([noisy]) == want.batch_decode([noisy])
    gpt2 = bbpe.ByteLevelBPE.from_pretrained(bpe_dir, pattern=bbpe.GPT2_PATTERN)
    jgpt2 = jbbpe.ByteLevelBPE.from_pretrained(bpe_dir, pattern=jbbpe.GPT2_PATTERN)
    for t in TEXT:
        assert gpt2.encode(t) == jgpt2.encode(t)


def test_hf_tokenizer_raises_import_error(tmp_path, monkeypatch):
    (tmp_path / "tokenizer.json").write_text("{}")
    with pytest.raises(ImportError, match="transformers"):
        tokenizer.load_tokenizer(str(tmp_path))
    monkeypatch.setenv("PS_USE_HF_TOKENIZER", "1")
    with pytest.raises(ImportError, match="transformers"):
        tokenizer.load_tokenizer(str(tmp_path))


def test_stub_tokenizer_equals_jax():
    got, want = tokenizer.load_tokenizer(None), jtok.load_tokenizer(None)
    for t in ("transcribe: <speech> hello world", "a b c <speech>"):
        ids = got.encode(t)
        assert ids == want.encode(t)
        assert got.decode(ids + [3, 255, 254]) == want.decode(ids + [3, 255, 254])


def _spm_model(path):
    """A sentencepiece BPE model: control and unknown pieces, byte
    fallback pieces, characters and scored merges."""
    pieces = [("<blank>", 0.0, spm.TYPE_CONTROL), ("<unk>", 0.0, spm.TYPE_UNKNOWN),
              ("</s>", 0.0, spm.TYPE_CONTROL), ("<pad>", 0.0, spm.TYPE_CONTROL)]
    pieces += [(f"<0x{b:02X}>", 0.0, spm.TYPE_BYTE) for b in range(256)]
    words = ["hello", "world", "the", "cat", "sat", "mat", "speech"]
    chars = sorted({c for w in words for c in w} | {"▁"})
    pieces += [(c, -10.0, spm.TYPE_NORMAL) for c in chars]
    seen = {p for p, _, _ in pieces}
    for w in words:
        for k in range(2, len(w) + 2):
            p = ("▁" + w)[:k]
            if p not in seen:
                seen.add(p)
                pieces.append((p, -5.0 + k + 0.01 * len(seen), spm.TYPE_NORMAL))
    blob = spm.serialize_model_proto(pieces)
    assert blob == jspm.serialize_model_proto(pieces)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "chn_jpn_yue_eng_ko_spectok.bpe.model"), "wb") as f:
        f.write(blob)
    return path


def test_sentencepiece_bpe_equals_jax(tmp_path):
    d = _spm_model(str(tmp_path / "enc"))
    got, want = spm.SenseVoiceTokenizer(d), jspm.SenseVoiceTokenizer(d)
    assert (got.vocab_size, got.pad_id, got.eos_id) == (want.vocab_size, want.pad_id, want.eos_id)
    for t in ["hello world the cat", "the mat sat speech", "héllo 中 unknown", "", "  a  b "]:
        ids = got.encode(t)
        assert ids == want.encode(t), t
        assert got.decode(ids + [2, 3]) == want.decode(ids + [2, 3])
    path = os.path.join(d, "chn_jpn_yue_eng_ko_spectok.bpe.model")
    assert spm.parse_model_proto(open(path, "rb").read()) == jspm.parse_model_proto(
        open(path, "rb").read())


# ----------------------------------------------------------------------------
# dataset and batching
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def manifest(tmp_path_factory, audio_files):
    """A multitask manifest over ark, wav and flac audio (one too short for
    the 0.1 s filter), ASR / translation / hotword tasks, GT with escapes
    and non-ASCII text, and a prompt file."""
    d = tmp_path_factory.mktemp("manifest")
    rng = np.random.default_rng(0)
    entries = {f"r{i}": (16000, (rng.normal(size=int(rng.integers(1000, 30000))) * 0.1
                                 ).astype(np.float32)) for i in range(9)}
    entries["short"] = (16000, np.zeros(800, np.float32))
    offsets = jaudio.write_kaldi_wav_ark(str(d / "wav.ark"), entries)
    rows = []
    tasks = ["ASR", "ZH2EN", "hotword", "ASR"]
    for i, (k, off) in enumerate(offsets.items()):
        row = {"key": k, "path": f"{d / 'wav.ark'}:{off}", "target": f"Hello, World {i}! it's",
               "GT": "caf\\u00e9 hello" if i % 2 else "你好 world", "task": tasks[i % 4]}
        if row["task"] == "hotword":
            row["hotword"] = "cat"
        rows.append(row)
    rows.append({"key": "wavfile", "path": audio_files["mono.wav"], "target": "the cat",
                 "GT": None, "task": "ASR"})
    rows.append({"key": "flacfile", "path": audio_files["a.flac"], "target": "the mat",
                 "GT": "the mat", "task": "ASR"})
    for split in ("train", "test"):
        (d / split).mkdir()
        (d / split / "multitask.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
    (d / "prompts.jsonl").write_text("".join(json.dumps(r) + "\n" for r in [
        {"task": "ASR", "prompt": "transcribe:"}, {"task": "ASR", "prompt": "write it down"},
        {"task": "ZH2EN", "prompt": "translate:"},
        {"task": "hotword", "prompt": "hotword {} please:"}]))
    _spm_model(str(d / "enc"))
    return d


def _cfgs(d, **over):
    pc, jc = config.DataConfig(), jconfig.DataConfig()
    for c in (pc, jc):
        c.multitask_prompt_path = str(d / "prompts.jsonl")
        c.train_scp_file_path = str(d / "train")
        c.test_scp_file_path = str(d / "test")
        c.feature_bucket, c.token_bucket = 4, 8
        c.train_max_frame_length, c.eval_max_frame_length = 60, 90
        for k, v in over.items():
            setattr(c, k, v)
    return pc, jc


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("split,fixed,hosts,wire", [
    ("test", None, 1, "int16"), ("test", 3, 1, "int16"), ("test", None, 2, "float32"),
    ("train", None, 2, "int16"), ("train", 4, 1, "float32"),
])
def test_batches_equal_jax(manifest, split, fixed, hosts, wire):
    pc, jc = _cfgs(manifest, waveform_dtype=wire)
    tok, jt = tokenizer.StubTokenizer(), jtok.StubTokenizer()
    enc = spm.SenseVoiceTokenizer(str(manifest / "enc"))
    jenc = jspm.SenseVoiceTokenizer(str(manifest / "enc"))
    for host in range(hosts):
        got = list(dataset.get_speech_dataset(
            pc, tok, split, encoder_tokenizer=enc, num_hosts=hosts, host_id=host,
            fixed_batch_size=fixed, seed=5))
        want = list(jdataset.get_speech_dataset(
            jc, jt, split, encoder_tokenizer=jenc, num_hosts=hosts, host_id=host,
            fixed_batch_size=fixed, seed=5))
        _assert_batches_equal(got, want)
        assert "waveform" in got[0] and got[0]["waveform"].dtype == np.dtype(wire)


def test_dynamic_batches_and_lazy_audio_equal_jax(manifest):
    pc, jc = _cfgs(manifest)
    tok, jt = tokenizer.StubTokenizer(), jtok.StubTokenizer()
    got = [[s.key for s in b] for b in dataset.dynamic_batches(
        iter(dataset.MultiTaskDataset(pc, tok, "test", lazy_audio=True)), 90, 8)]
    want = [[s.key for s in b] for b in jdataset.dynamic_batches(
        iter(jdataset.MultiTaskDataset(jc, jt, "test", lazy_audio=True)), 90, 8)]
    assert got == want and len(got) > 1
    assert "short" not in sum(got, [])
    skipped = list(dataset.get_speech_dataset(pc, tok, "train", skip_batches=1))
    jskipped = list(jdataset.get_speech_dataset(jc, jt, "train", skip_batches=1))
    assert skipped[0] == {"batch_skipped": True}
    _assert_batches_equal(skipped[1:], jskipped[1:])


def test_whisper_front_end_names_its_roadmap_item(manifest):
    """The whisper front end, which raised until the parallelism slice,
    collates the JAX package's batch: the mel features within
    tests/test_torch_whisper.py's 5e-5 (the STFT in float64 against fp32),
    every other field exactly."""
    pc, jc = _cfgs(manifest, encoder="whisper")
    got = next(iter(dataset.get_speech_dataset(pc, tokenizer.StubTokenizer(), "test")))
    want = next(iter(jdataset.get_speech_dataset(jc, jtok.StubTokenizer(), "test")))
    assert sorted(got) == sorted(want) and got["input_features"].shape[1:] == (3000, 128)
    np.testing.assert_allclose(got["input_features"], want["input_features"], rtol=0, atol=5e-5)
    for k in want:
        if k != "input_features":
            assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k


def test_registry_builtins():
    from ps_slm_tpu_torch import registry

    assert registry.get_dataset_factory("multitask") is dataset.get_speech_dataset
    from ps_slm_tpu_torch.models import tasu

    assert registry.get_model_factory("tasu") is tasu.model_factory
    with pytest.raises(KeyError, match="unknown model factory"):
        registry.get_model_factory("nope")


def test_multiprompt_file_loads_equal():
    path = os.path.join(ROOT, "conf", "multiprompt.jsonl")
    assert dataset.load_multiprompt(path) == jdataset.load_multiprompt(path)


def test_step_timer_and_logger(tmp_path):
    from ps_slm_tpu_torch.utils.logging import setup_logger
    from ps_slm_tpu_torch.utils.profiler import StepTimer

    t = StepTimer(window=None)
    for _ in range(60):
        t.start()
        t.stop(2.0)
    assert len(t._times) == 60 and t.audio_sec_per_sec > 0 and t.seconds > 0
    log = setup_logger("t", str(tmp_path / "sub" / "x.log"))
    log.info("hello")
    assert "hello" in (tmp_path / "sub" / "x.log").read_text()
