"""Tiny versions of the benchmark's cells for CPU tests: the cell as
BENCHMARK.json resolves it, with small sizes in place of the configuration's
and a small mix in place of the traffic's; the precision, the limits and the
loop are the cell's own."""

import copy

from port_bench import harness

CLIP = {"embed_dim": 32,
        "vision": {"image_size": 32, "patch_size": 16, "width": 64, "layers": 2, "heads": 1},
        "text": {"context_length": 16, "vocab_size": 100, "width": 64, "layers": 2, "heads": 1},
        "tokens": {"start": 98, "end": 99, "pad": 0, "first_word": 1, "last_word": 97}}
FIT = {"projection_dim": 16, "max_tokens": 16,
       "video": {"embed_dim": 64, "depth": 2, "num_heads": 1, "patch_size": 16, "img_size": 32},
       "text": {"vocab_size": 200, "dim": 64, "hidden_dim": 128, "n_layers": 2, "n_heads": 1,
                "max_position_embeddings": 32},
       "tokens": {"start": 101, "end": 102, "pad": 0, "first_word": 103, "last_word": 199}}
SIZES = {"clip": CLIP, "fit": FIT}
MIXES = {"eval": {"clips": 10, "batch": 4, "calibration_batches": 2},
         "train": {"labeled": 4, "unlabeled": 4, "pool_steps": 5}}


def cell(name: str) -> harness.Cell:
    out = copy.deepcopy(harness.resolve(name))
    out.config.update(copy.deepcopy(SIZES[out.config["family"]]))
    out.traffic.update(MIXES[out.traffic["kind"]])
    return out


def run(name: str, seed: int = 2 ** 33 + 5, fault=None):
    import torch

    torch.manual_seed(0)
    tiny = cell(name)
    _, reading = harness.run(name, seed, 0.2, False, 0.0, device="cpu", cell=tiny, fault=fault)
    return tiny, reading
