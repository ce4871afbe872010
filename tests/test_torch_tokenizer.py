"""fitclip_torch/models/clip/tokenizer.py against the JAX package's tokenizer:
ids equal on a seeded mixed-script corpus, the word scanner equal to the
``regex`` pattern on every code point that Python's ``unicodedata`` assigns,
the same BPE merges and vocabulary files, decode round trips, and an import
that needs no ``regex``."""

import os
import subprocess
import sys
import unicodedata
from pathlib import Path

import numpy as np
import pytest
import torch

from fitclip_tpu.models.clip import tokenizer as jax_tok
from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder as JaxClipEncoder
from fitclip_tpu.models.clip.model import CLIPConfig as JaxClipConfig
from fitclip_tpu.models.slip import SlipConfig as JaxSlipConfig
from fitclip_tpu.models.slip import SlipVideoTextEncoder as JaxSlipEncoder
from fitclip_torch.models.clip import tokenizer as tok
from fitclip_torch.models.clip.encoder import ClipVideoTextEncoder
from fitclip_torch.models.clip.model import CLIPConfig
from fitclip_torch.models.slip import SlipConfig, SlipVideoTextEncoder

REPO = Path(__file__).resolve().parent.parent

WORDS = ["hello", "hello", "hello", "world", "world", "a", "photo", "photo", "of", "of",
         "of", "a", "a", "cat", "dog", "playing", "playing", "the", "the", "café", "café",
         "über", "naïve", "日本", "日本", "видео", "видео", "βίντεο", "βίντεο"]

# Pieces the seeded corpus draws from: words of several scripts, digits of
# other scripts (Arabic-Indic, Devanagari, fullwidth, superscript, Roman
# numerals), contractions in both cases, U+001C-U+001F (str.isspace says yes,
# the pattern's \s says no), U+0345 (matched by no alternative), the long s
# (case-folds to s), HTML entities, the specials in both cases, and unusual
# White_Space.
PIECES = ["a", "photo", "of", "cat", "Dog", "PLAYING", "café", "ÜBER", "日本語", "видео",
          "ΒΊΝΤΕΟ", "مرحبا", "नमस्ते", "한국어", "٣٤", "३", "３", "²", "Ⅻ", "42", "7",
          "'s", "'S", "'t", "'RE", "'ve", "'M", "'ll", "'D", "it's", "WE'RE", "''s", "'x",
          "\x1c", "\x1d", "\x1e", "\x1f", "ͅ", "ſ", "'ſ", "&amp;", "&lt;b&gt;",
          "&amp;amp;", "<|startoftext|>", "<|ENDOFTEXT|>", "<|endoftext", "!?", "...", "—",
          "😀", "　", "\u0085", " ", "\t", "\n", " ", "  "]


def _corpus(n: int = 300, seed: int = 0):
    rng = np.random.default_rng(seed)
    return ["".join(PIECES[i] + ("" if rng.random() < 0.4 else " ")
                    for i in rng.integers(0, len(PIECES), size=rng.integers(1, 14)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    directory = tmp_path_factory.mktemp("vocab")
    return jax_tok.write_tiny_test_vocab(str(directory), WORDS)


@pytest.fixture(scope="module")
def pair(vocab):
    merges, vocab_json = vocab
    return (tok.ClipTokenizer(bpe_path=merges, vocab_path=vocab_json, context_length=77),
            jax_tok.ClipTokenizer(bpe_path=merges, vocab_path=vocab_json, context_length=77))


def test_ids_match_jax_on_a_mixed_script_corpus(pair):
    port, ref = pair
    corpus = _corpus()
    for text in corpus:
        assert port.encode(text) == ref.encode(text), repr(text)
    np.testing.assert_array_equal(port(corpus), ref(corpus))
    np.testing.assert_array_equal(port(corpus, context_length=8), ref(corpus, context_length=8))
    with pytest.raises(ValueError):
        port(["a photo of a cat " * 10], context_length=8, truncate=False)


def test_scanner_matches_the_pattern_on_every_assigned_code_point():
    """Every code point that unicodedata assigns, seven at a time, between
    contractions, a letter and a digit, in both orders."""
    cps = [cp for cp in range(0x110000)
           if not 0xD800 <= cp < 0xE000 and unicodedata.category(chr(cp)) != "Cn"]
    for k in range(0, len(cps), 7):
        chunk = "".join(map(chr, cps[k:k + 7]))
        text = f"a'{chunk}'ſT x{chunk[::-1]} 3'RE"
        cleaned = tok._clean_text(text)
        assert cleaned == jax_tok._clean_text(text), [hex(c) for c in cps[k:k + 7]]
        assert tok.split_words(cleaned.lower()) == jax_tok._TOKEN_PATTERN.findall(
            cleaned.lower()), [hex(c) for c in cps[k:k + 7]]


def test_white_space_is_the_patterns():
    """U+001C-U+001F are str.isspace() but not the pattern's \\s: they stay
    (as punctuation) where the pattern keeps them."""
    for cp in range(0x10000):
        char = chr(cp)
        assert (char in tok._WHITE_SPACE) == bool(jax_tok.re.fullmatch(r"\s", char)), hex(cp)
    assert tok.split_words("a\x1cb") == jax_tok._TOKEN_PATTERN.findall("a\x1cb") == \
        ["a", "\x1c", "b"]


def test_bpe_merges_and_vocab_files_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    words = [w for w in _corpus(80, seed=2) for w in w.split()] + \
        list(rng.choice(WORDS, size=200))
    for num_merges in (16, 64, 400):
        assert tok.train_bpe_merges(words, num_merges=num_merges) == \
            jax_tok.train_bpe_merges(words, num_merges=num_merges)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    for a, b in zip(tok.write_tiny_test_vocab(str(tmp_path / "port"), words),
                    jax_tok.write_tiny_test_vocab(str(tmp_path / "jax"), words)):
        assert Path(a).read_bytes() == Path(b).read_bytes()
    merges = tok.train_bpe_merges(words, num_merges=100)
    for name in ("openai.txt", "openai.txt.gz"):
        tok.write_openai_format_vocab(str(tmp_path / f"port_{name}"), merges)
        jax_tok.write_openai_format_vocab(str(tmp_path / f"jax_{name}"), merges)
        port = tok.ClipTokenizer(bpe_path=str(tmp_path / f"port_{name}"))
        ref = jax_tok.ClipTokenizer(bpe_path=str(tmp_path / f"jax_{name}"))
        assert port.encoder == ref.encoder and port.vocab_size == ref.vocab_size
        np.testing.assert_array_equal(port(_corpus(40)), ref(_corpus(40)))


def test_decode_round_trips(pair):
    port, ref = pair
    for text in ["a photo of a cat", "Hello   World!", "café über 日本 видео", "it's 42"]:
        ids = port.encode(text)
        assert port.decode(ids) == ref.decode(ids)
        assert port.decode(ids).strip() == " ".join(tok.split_words(
            tok._clean_text(text).lower()))
    row = port(["a photo of a cat"])[0]
    assert port.decode(row[1: list(row).index(port.eot_id)]) == "a photo of a cat "


def test_encoders_tokenize_and_decode_as_jax(vocab):
    """CLIP's and SLIP's get_tokenizer and decode_text (bpe_path only: the vocab
    follows the merges' order, as write_tiny_test_vocab's vocab.json does)."""
    merges, _ = vocab
    texts = _corpus(20, seed=5)
    for port_enc, jax_enc in (
            (ClipVideoTextEncoder(CLIPConfig.tiny_test(), bpe_path=merges),
             JaxClipEncoder(JaxClipConfig.tiny_test(), bpe_path=merges)),
            (SlipVideoTextEncoder(SlipConfig.tiny_test(), bpe_path=merges),
             JaxSlipEncoder(JaxSlipConfig.tiny_test(), bpe_path=merges))):
        ids = port_enc.get_tokenizer()(texts)
        np.testing.assert_array_equal(ids, jax_enc.get_tokenizer()(texts))
        assert ids.shape == (20, 16)
        assert list(port_enc.decode_text(ids)) == list(jax_enc.decode_text(ids))


def test_teacher_student_prompts_tokenize_as_jax(vocab, tmp_path):
    """run_train's prompts: each tower's tokenizer over the file's lines."""
    from fitclip_tpu.cli.train_runner import _load_prompts as jax_load_prompts
    from fitclip_tpu.models.clip.load import load_tiny_test_encoder as jax_tiny
    from fitclip_torch.models.clip.load import load_tiny_test_encoder
    from fitclip_torch.training.train_runner import load_prompts

    merges, vocab_json = vocab
    path = tmp_path / "prompts.txt"
    path.write_text("a photo of a cat\n\n  hello world  \nit's a dog\n")
    port = load_tiny_test_encoder(bpe_path=merges, vocab_path=vocab_json, device="cpu")
    ref = jax_tiny(bpe_path=merges, vocab_path=vocab_json)
    got = load_prompts(str(path), port, port, "cpu")
    want = jax_load_prompts(str(path), ref, ref)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and g.shape == (3, 16)
        np.testing.assert_array_equal(g.numpy(), w)


def test_imports_and_runs_without_regex(vocab):
    merges, vocab_json = vocab
    code = ("import sys; sys.modules['regex'] = None\n"
            "from fitclip_torch.models.clip.tokenizer import ClipTokenizer\n"
            f"t = ClipTokenizer(bpe_path={merges!r}, vocab_path={vocab_json!r})\n"
            "print(t.encode(\"it's a cat\"))\n"
            "assert 'regex' not in [m for m in sys.modules if sys.modules[m] is not None]\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    merges_ref = jax_tok.ClipTokenizer(bpe_path=merges, vocab_path=vocab_json)
    assert proc.stdout.strip() == str(merges_ref.encode("it's a cat"))
