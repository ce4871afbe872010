"""BERT WordPiece tokenizer, from scratch (no HF/Rust tokenizers dependency):
the port's own copy of ``fitclip_tpu/text/wordpiece.py``, pure Python.

Used by the Frozen-in-Time (distilbert) text tower.
Implements the standard pipeline: clean -> basic tokenize (whitespace, CJK
isolation, punctuation split, optional lowercase + accent strip) -> greedy
longest-match-first WordPiece with '##' continuations -> [CLS]/[SEP] framing,
fixed-length padding + attention mask.

Vocabulary is data: pass a local ``vocab.txt`` (one token per line, HF
format). The JAX package's copy is tested for exact id parity against HF's
pure-python BertTokenizer; this one is held to that copy's ids.
"""

import unicodedata
from typing import Dict, List, Optional, Sequence

import numpy as np


def load_vocab(vocab_path: str) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(vocab_path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            token = line.rstrip("\n")
            if token:
                vocab[token] = i
    return vocab


def _is_punctuation(char: str) -> bool:
    cp = ord(char)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(char).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


def basic_tokenize(text: str, lowercase: bool = True) -> List[str]:
    # Clean: drop control chars, normalize whitespace.
    cleaned = []
    for char in text:
        cp = ord(char)
        if cp == 0 or cp == 0xFFFD or unicodedata.category(char) in ("Cc", "Cf"):
            continue
        cleaned.append(" " if char.isspace() else char)
    text = "".join(cleaned)
    # Isolate CJK characters.
    text = "".join(f" {c} " if _is_cjk(ord(c)) else c for c in text)

    tokens: List[str] = []
    for token in text.split():
        if lowercase:
            token = token.lower()
            token = "".join(c for c in unicodedata.normalize("NFD", token)
                            if unicodedata.category(c) != "Mn")
        # Split on punctuation.
        current: List[str] = []
        for char in token:
            if _is_punctuation(char):
                if current:
                    tokens.append("".join(current))
                    current = []
                tokens.append(char)
            else:
                current.append(char)
        if current:
            tokens.append("".join(current))
    return tokens


class WordPieceTokenizer:
    def __init__(self, vocab_path: Optional[str] = None,
                 vocab: Optional[Dict[str, int]] = None,
                 lowercase: bool = True, max_tokens: int = 77,
                 unk_token: str = "[UNK]", cls_token: str = "[CLS]",
                 sep_token: str = "[SEP]", pad_token: str = "[PAD]",
                 max_chars_per_word: int = 100) -> None:
        if vocab is None:
            if vocab_path is None:
                raise ValueError("Pass vocab or vocab_path (a BERT vocab.txt)")
            vocab = load_vocab(vocab_path)
        self.vocab = vocab
        self.ids_to_tokens = {i: t for t, i in vocab.items()}
        self.lowercase = lowercase
        self.max_tokens = max_tokens
        self.unk_id = vocab[unk_token]
        self.cls_id = vocab[cls_token]
        self.sep_id = vocab[sep_token]
        self.pad_id = vocab[pad_token]
        self.max_chars_per_word = max_chars_per_word

    def wordpiece(self, word: str) -> List[int]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_id]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece_id = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    piece_id = self.vocab[piece]
                    break
                end -= 1
            if piece_id is None:
                return [self.unk_id]
            ids.append(piece_id)
            start = end
        return ids

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in basic_tokenize(text, self.lowercase):
            ids.extend(self.wordpiece(word))
        return ids

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        specials = {self.cls_id, self.sep_id, self.pad_id}
        tokens = [self.ids_to_tokens[int(i)] for i in ids
                  if not (skip_special and int(i) in specials)]
        text = " ".join(tokens).replace(" ##", "")
        return text

    def __call__(self, texts, max_tokens: Optional[int] = None,
                 prefix_sep: bool = False) -> Dict[str, np.ndarray]:
        """Batch tokenize to fixed length with [CLS] ... [SEP] framing
        (``prefix_sep`` prepends an extra [SEP] after [CLS] — the VideoCLIP
        convention, videoclip_video_text_encoder.py:59-61).
        Returns {"input_ids", "attention_mask"}."""
        if isinstance(texts, str):
            texts = [texts]
        length = max_tokens or self.max_tokens
        input_ids = np.full((len(texts), length), self.pad_id, dtype=np.int32)
        attention_mask = np.zeros((len(texts), length), dtype=np.int32)
        for row, text in enumerate(texts):
            body = self.encode(text)
            frame = [self.cls_id] + ([self.sep_id] if prefix_sep else [])
            budget = length - len(frame) - 1
            ids = frame + body[:budget] + [self.sep_id]
            input_ids[row, : len(ids)] = ids
            attention_mask[row, : len(ids)] = 1
        return {"input_ids": input_ids, "attention_mask": attention_mask}
