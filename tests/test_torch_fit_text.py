"""The port's WordPiece tokenizer (fitclip_torch/text/wordpiece.py) gives the
JAX package's ids on a vocab the test writes, and the FiT encoder reaches it
through get_tokenizer."""

import numpy as np
import pytest
import torch

from fitclip_tpu.text.wordpiece import WordPieceTokenizer as JaxWordPiece
from fitclip_torch.convert.from_jax import fit_params_from_jax
from fitclip_torch.models.frozen_in_time.encoder import (FrozenInTimeConfig,
                                                         FrozenInTimeVideoTextEncoder)
from fitclip_torch.models.frozen_in_time.load import init_fit_params
from fitclip_torch.text.wordpiece import WordPieceTokenizer

TINY_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "cat", "video", "of", "the",
              "##s", "##ing", "play", "dog", "un", "##know", "##n", ",", ".", "!", "person",
              "caf", "##e", "中"]


@pytest.fixture()
def vocab_file(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(TINY_VOCAB))
    return str(path)


@pytest.mark.parametrize("text", [
    "a cat video", "the cats playing!", "unknown", "A CAT, of the video.",
    "completely oov words", "", "Café 中 person\tdogs", "a " * 40])
def test_wordpiece_ids_match_jax(vocab_file, text):
    mine, ref = (cls(vocab_path=vocab_file, max_tokens=16) for cls in (WordPieceTokenizer,
                                                                      JaxWordPiece))
    for prefix_sep in (False, True):
        got, want = mine([text], prefix_sep=prefix_sep), ref([text], prefix_sep=prefix_sep)
        np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
        np.testing.assert_array_equal(got["attention_mask"], want["attention_mask"])
    assert mine.decode(got["input_ids"][0]) == ref.decode(want["input_ids"][0])


def test_encoder_tokenizes_with_its_vocab(vocab_file):
    config = FrozenInTimeConfig.tiny_test(len(TINY_VOCAB))
    enc = FrozenInTimeVideoTextEncoder(config, num_frames=2, max_tokens=12,
                                       vocab_path=vocab_file)
    enc.load_state_dict(fit_params_from_jax(init_fit_params(config, 0), config))
    tokenize = enc.get_tokenizer()
    ids = tokenize(["a cat video", "playing dogs"])
    assert ids.shape == (2, 12) and ids[0, 0] == TINY_VOCAB.index("[CLS]")
    np.testing.assert_array_equal(ids, JaxWordPiece(vocab_path=vocab_file, max_tokens=12)(
        ["a cat video", "playing dogs"])["input_ids"])
    with torch.no_grad():
        emb = enc.encode_text(torch.from_numpy(ids).long())
    np.testing.assert_allclose(emb.norm(dim=1).numpy(), 1.0, atol=1e-5)
    with pytest.raises(ValueError, match="vocab"):
        FrozenInTimeVideoTextEncoder(FrozenInTimeConfig.tiny_test()).get_tokenizer()
