"""CLIP byte-level BPE tokenizer (port of ``fitclip_tpu/models/clip/tokenizer.py``).

GPT-2-style byte-to-unicode encoding, end-of-word ``</w>`` merges,
``<|startoftext|>``/``<|endoftext|>`` specials, HTML unescaping, lowercasing
and whitespace folding, and truncate-to-77 with a forced EOT in the last slot.

The JAX package splits words with the ``regex`` module's pattern
``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``
(case-insensitive). This port scans the same pattern by hand over the
standard library's ``unicodedata``, so it needs no third-party package:

- ``\\s`` is Unicode's White_Space property (``_WHITE_SPACE``), not
  ``str.isspace()``, which also says yes to U+001C-U+001F;
- letters and numbers are the general categories L* and N*;
- case-insensitive literals match a character whose case fold is the
  literal's letter (U+017F LONG S matches ``s``), as the pattern's simple
  case folding does;
- under that folding, a character outside L and N whose case variant is a
  letter or number (U+0345) is matched by no alternative, and is skipped.

Where ``unicodedata``'s tables are older than ``regex``'s, code points that
Unicode assigned since then are unassigned here: the two then split such text
differently.

Vocabulary files are data: an OpenAI-format merges file
(``bpe_simple_vocab_16e6.txt.gz``; ids follow from construction order) or an
HF-format ``vocab.json`` + ``merges.txt`` pair. ``FITCLIP_BPE_PATH`` gives a
default location.
"""

import functools
import gzip
import heapq
import html
import json
import os
import unicodedata
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

SOT_TOKEN = "<|startoftext|>"
EOT_TOKEN = "<|endoftext|>"

_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")

# Unicode's White_Space property: what the pattern's \s matches.
_WHITE_SPACE = frozenset(map(chr, (
    0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
    0x2028, 0x2029, 0x202F, 0x205F, 0x3000)))


def _is_letter_or_number(char: str) -> bool:
    return unicodedata.category(char)[0] in "LN"


@functools.lru_cache(maxsize=None)
def _char_class(char: str) -> str:
    """"L" letter, "N" number, "O" neither (the punctuation runs), or "" for a
    character that no alternative of the pattern matches."""
    if char in _WHITE_SPACE:
        return ""
    category = unicodedata.category(char)[0]
    if category in "LN":
        return category
    variants = {char.lower(), char.upper(), char.casefold(), char.title()}
    if any(len(v) == 1 and _is_letter_or_number(v) for v in variants):
        return ""
    return "O"


def _literal_at(text: str, i: int, literal: str) -> bool:
    """Whether ``literal`` (ASCII, lowercase) matches text[i:] case-insensitively."""
    if i + len(literal) > len(text):
        return False
    return all(c == want or c.casefold() == want for c, want in zip(text[i:], literal))


def split_words(text: str) -> List[str]:
    """``regex.findall`` of the pattern above over ``text``."""
    words: List[str] = []
    i, n = 0, len(text)
    while i < n:
        match = next((lit for lit in (SOT_TOKEN, EOT_TOKEN, *_CONTRACTIONS)
                      if _literal_at(text, i, lit)), None)
        if match is not None:
            words.append(text[i: i + len(match)])
            i += len(match)
            continue
        kind = _char_class(text[i])
        if not kind:
            i += 1
            continue
        j = i + 1
        if kind != "N":
            while j < n and _char_class(text[j]) == kind:
                j += 1
        words.append(text[i:j])
        i = j
    return words


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode map."""
    printable = (list(range(ord("!"), ord("~") + 1))
                 + list(range(ord("¡"), ord("¬") + 1))
                 + list(range(ord("®"), ord("ÿ") + 1)))
    mapping = dict.fromkeys(printable)
    offset = 0
    for byte in range(256):
        if byte in mapping:
            mapping[byte] = chr(byte)
        else:
            mapping[byte] = chr(256 + offset)
            offset += 1
    return mapping


def _get_pairs(word: Tuple[str, ...]) -> set:
    return set(zip(word[:-1], word[1:]))


def _clean_text(text: str) -> str:
    return _fold_white_space(html.unescape(html.unescape(text))).strip()


def _fold_white_space(text: str) -> str:
    """Every run of White_Space characters -> one space (``re.sub(r"\\s+", " ")``)."""
    out: List[str] = []
    in_run = False
    for char in text:
        if char in _WHITE_SPACE:
            if not in_run:
                out.append(" ")
            in_run = True
        else:
            out.append(char)
            in_run = False
    return "".join(out)


def _read_merges(path: str) -> List[Tuple[str, str]]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
        lines = f.read().split("\n")
    merges = []
    for line in lines:
        line = line.strip()
        if not line or line.startswith("#version"):
            continue
        parts = tuple(line.split())
        if len(parts) == 2:
            merges.append(parts)
    # The OpenAI release caps at 48894 usable merges (49152 - 256 - 2).
    return merges[: 49152 - 256 - 2]


class ClipTokenizer:
    def __init__(self, bpe_path: Optional[str] = None, vocab_path: Optional[str] = None,
                 context_length: int = 77) -> None:
        bpe_path = bpe_path or os.environ.get("FITCLIP_BPE_PATH")
        if bpe_path is None or not os.path.exists(bpe_path):
            raise FileNotFoundError(
                "CLIP BPE merges file not found. Provide `bpe_path` or set "
                "FITCLIP_BPE_PATH to bpe_simple_vocab_16e6.txt(.gz) or an HF merges.txt")
        self.context_length = context_length
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        merges = _read_merges(bpe_path)
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}

        if vocab_path:
            with open(vocab_path, encoding="utf-8") as f:
                self.encoder: Dict[str, int] = json.load(f)
        else:
            vocab = list(self.byte_encoder.values())
            vocab.extend(v + "</w>" for v in list(self.byte_encoder.values()))
            vocab.extend("".join(pair) for pair in merges)
            vocab.extend([SOT_TOKEN, EOT_TOKEN])
            self.encoder = {token: i for i, token in enumerate(vocab)}
        self.decoder = {i: token for token, i in self.encoder.items()}
        self.sot_id = self.encoder[SOT_TOKEN]
        self.eot_id = self.encoder[EOT_TOKEN]
        self._bpe_cache: Dict[str, str] = {SOT_TOKEN: SOT_TOKEN, EOT_TOKEN: EOT_TOKEN}

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def _bpe(self, token: str) -> str:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    merged.extend(word[i:])
                    break
                merged.extend(word[i:j])
                if j < len(word) - 1 and word[j + 1] == second:
                    merged.append(first + second)
                    i = j + 2
                else:
                    merged.append(word[j])
                    i = j + 1
            word = tuple(merged)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        result = " ".join(word)
        self._bpe_cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        """Text -> BPE ids (no specials, no padding)."""
        ids: List[int] = []
        for token in split_words(_clean_text(text).lower()):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[piece] for piece in self._bpe(token).split(" "))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(self, texts, context_length: Optional[int] = None,
                 truncate: bool = True) -> np.ndarray:
        """Texts -> a (B, context_length) int32 array, SOT/EOT framed and zero
        padded (``clip.tokenize(truncate=True)``)."""
        if isinstance(texts, str):
            texts = [texts]
        length = context_length or self.context_length
        result = np.zeros((len(texts), length), dtype=np.int32)
        for row, text in enumerate(texts):
            ids = [self.sot_id] + self.encode(text) + [self.eot_id]
            if len(ids) > length:
                if not truncate:
                    raise ValueError(f"Input {row} too long for context length {length}")
                ids = ids[:length]
                ids[-1] = self.eot_id
            result[row, : len(ids)] = ids
        return result


def _inverted_lex_key(pair: Tuple[str, str]) -> Tuple[int, ...]:
    """A key that orders ascending where ``pair`` orders descending, so a
    min-heap pops the count-tie winner that ``max(counts.items())`` picks: each
    string becomes its negated code points plus a ``1`` terminator, which sorts
    a prefix after its extensions."""
    first, second = pair
    return (tuple(-ord(c) for c in first) + (1,)
            + tuple(-ord(c) for c in second) + (1,))


def _merge_word(word: Tuple[str, ...], first: str, second: str,
                fused: str) -> Tuple[str, ...]:
    out: List[str] = []
    i, n = 0, len(word)
    while i < n:
        if i < n - 1 and word[i] == first and word[i + 1] == second:
            out.append(fused)
            i += 2
        else:
            out.append(word[i])
            i += 1
    return tuple(out)


def train_bpe_merges(words: Sequence[str], num_merges: int = 64,
                     min_count: int = 2) -> List[Tuple[str, str]]:
    """BPE training: fuse the most frequent adjacent symbol pair (ties to the
    largest pair) until ``num_merges`` merges exist or no pair repeats. Words
    are byte-encoded first, as the tokenizer sees them. Incremental: unique
    words with counts, a pair -> {word id} index and a lazily invalidated heap."""
    byte_encoder = bytes_to_unicode()
    encoded = ("".join(byte_encoder[b] for b in w.encode("utf-8")) for w in words)
    word_freq = Counter(tuple(w[:-1]) + (w[-1] + "</w>",) for w in encoded if w)
    corpus = list(word_freq.keys())
    freqs = [word_freq[w] for w in corpus]

    pair_counts: Dict[Tuple[str, str], int] = {}
    pair_words: Dict[Tuple[str, str], set] = {}
    for wid, word in enumerate(corpus):
        for p in zip(word[:-1], word[1:]):
            pair_counts[p] = pair_counts.get(p, 0) + freqs[wid]
            pair_words.setdefault(p, set()).add(wid)

    heap = [(-c, _inverted_lex_key(p), p) for p, c in pair_counts.items()]
    heapq.heapify(heap)

    merges: List[Tuple[str, str]] = []
    while len(merges) < num_merges and heap:
        neg_count, _, pair = heapq.heappop(heap)
        count = pair_counts.get(pair, 0)
        if count != -neg_count:
            continue  # stale: every count change pushed a fresh entry
        if count < min_count:
            break
        first, second = pair
        fused = first + second
        merges.append(pair)

        touched: set = set()
        for wid in list(pair_words.get(pair, ())):
            word = corpus[wid]
            new_word = _merge_word(word, first, second, fused)
            f = freqs[wid]
            old_pairs = Counter(zip(word[:-1], word[1:]))
            new_pairs = Counter(zip(new_word[:-1], new_word[1:]))
            for p in old_pairs.keys() | new_pairs.keys():
                delta = new_pairs.get(p, 0) - old_pairs.get(p, 0)
                if delta:
                    pair_counts[p] = pair_counts.get(p, 0) + f * delta
                    touched.add(p)
                    if pair_counts[p] <= 0:
                        del pair_counts[p]
                if new_pairs.get(p, 0) and not old_pairs.get(p, 0):
                    pair_words.setdefault(p, set()).add(wid)
                elif old_pairs.get(p, 0) and not new_pairs.get(p, 0):
                    pair_words[p].discard(wid)
            corpus[wid] = new_word
        pair_words.pop(pair, None)
        for p in touched:
            c = pair_counts.get(p, 0)
            if c > 0:
                heapq.heappush(heap, (-c, _inverted_lex_key(p), p))
    return merges


def write_openai_format_vocab(path: str, merges: Sequence[Tuple[str, str]]) -> str:
    """Merges in the OpenAI ``bpe_simple_vocab_16e6.txt.gz`` layout: a header
    line, then one pair a line (gzipped if ``path`` ends in .gz), with no
    trailing newline, which CLIP's reader would take for an empty merge."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2")
        for a, b in merges:
            f.write(f"\n{a} {b}")
    return path


def write_tiny_test_vocab(directory: str, words: Sequence[str]) -> Tuple[str, str]:
    """A small valid merges.txt + vocab.json pair trained on ``words``."""
    merges = train_bpe_merges(words, num_merges=64)

    merges_path = os.path.join(directory, "merges.txt")
    with open(merges_path, "w", encoding="utf-8") as f:
        f.write("#version: tiny\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")

    byte_vocab = list(bytes_to_unicode().values())
    vocab = byte_vocab + [v + "</w>" for v in byte_vocab] + ["".join(m) for m in merges] \
        + [SOT_TOKEN, EOT_TOKEN]
    vocab_path = os.path.join(directory, "vocab.json")
    with open(vocab_path, "w", encoding="utf-8") as f:
        json.dump({t: i for i, t in enumerate(vocab)}, f)
    return merges_path, vocab_path
