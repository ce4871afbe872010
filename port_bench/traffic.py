"""The one generator of every traffic mix: seeded clips and captions, made on
the device in a few large calls. A mix is a data file of parameters
(``traffic/<name>.json``); a configuration gives the frame count and size and
its tokenizer's special ids (``tokens``).

Seeds: the run's ``--seed`` and a tag name each stream, so the video, the
captions and the weights draw from streams of their own, and a seed of any
size (more than 32 bits) is taken whole.
"""

import hashlib

import torch


def derived_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of the run's ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derived_seed(seed, tag))


def clips(count: int, frames: int, size: int, gen: torch.Generator, device) -> torch.Tensor:
    """(count, frames, size, size, 3) uint8 pixels."""
    return torch.randint(0, 256, (count, frames, size, size, 3), generator=gen,
                         dtype=torch.uint8, device=device)


def caption_lengths(count: int, spec: dict, gen: torch.Generator, device) -> torch.Tensor:
    """Token counts (start and end tokens included) from ``min`` + an
    exponential of mean ``mean - min``, cut at ``max``: short captions mostly,
    a tail of long ones."""
    scale = float(spec["mean"]) - int(spec["min"])
    tail = torch.empty(count, device=device).exponential_(1.0 / scale, generator=gen)
    return torch.clamp(int(spec["min"]) + tail.floor().long(), max=int(spec["max"]))


def captions(count: int, context: int, spec: dict, tokens: dict, gen: torch.Generator,
             device) -> torch.Tensor:
    """(count, context) int64 ids: the start token, words drawn uniformly from
    ``tokens['first_word']..tokens['last_word']``, the end token, then
    ``tokens['pad']``; a caption longer than the context is cut to it."""
    lengths = torch.clamp(caption_lengths(count, spec, gen, device), max=context)
    words = torch.randint(int(tokens["first_word"]), int(tokens["last_word"]) + 1,
                          (count, context), generator=gen, device=device)
    position = torch.arange(context, device=device)[None]
    ids = torch.where(position < lengths[:, None] - 1, words, int(tokens["pad"]))
    ids[:, 0] = int(tokens["start"])
    ids[torch.arange(count, device=device), lengths - 1] = int(tokens["end"])
    return ids
