"""The plain reference on tiny hand-built cases: attention against loops,
FiT's divided attention against each query's key set built by hand, the
text pooling, the losses and AdamW against their closed forms, and the
control's rounding."""

import math

import torch

from port_bench.reference import clip, common, fit, quant, train
from port_bench.tests import tiny


def test_causal_attention_against_a_loop():
    torch.manual_seed(0)
    q, k, v = torch.randn(3, 5, 4, dtype=torch.float64).unbind(0)
    mask = torch.ones(5, 5, dtype=torch.bool).tril()
    out = common.softmax_attention(q, k, v, mask)
    for i in range(5):
        logits = torch.stack([q[i] @ k[j] / 2.0 for j in range(i + 1)])
        weights = torch.exp(logits - logits.max())
        expected = sum(w * v[j] for j, w in enumerate(weights / weights.sum()))
        assert torch.allclose(out[i], expected, atol=1e-12)


def _divided_by_hand(h, w, prefix, frames, mode):
    """Each query row's keys listed one by one: the CLS row over every row;
    a patch row over the CLS row and its group (same location for time, same
    frame for space). One head."""
    qkv = h @ w[prefix + ".qkv.weight"].T + w[prefix + ".qkv.bias"]
    d = h.shape[-1]
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    n = h.shape[1]
    patches = (n - 1) // frames
    out = torch.zeros_like(h)
    for b in range(h.shape[0]):
        for row in range(n):
            if row == 0:
                keys = list(range(n))
            else:
                f, p = divmod(row - 1, patches)
                group = ([1 + g * patches + p for g in range(frames)] if mode == "time"
                         else [1 + f * patches + r for r in range(patches)])
                keys = [0] + group
            logits = torch.stack([q[b, row] @ k[b, j] for j in keys]) / math.sqrt(d)
            weights = torch.softmax(logits, dim=0)
            out[b, row] = sum(wt * v[b, j] for wt, j in zip(weights, keys))
    return out @ w[prefix + ".proj.weight"].T + w[prefix + ".proj.bias"]


def test_fit_divided_attention_against_each_querys_keys():
    torch.manual_seed(1)
    d, frames, patches = 8, 2, 4
    w = {"a.qkv.weight": torch.randn(3 * d, d) / 3, "a.qkv.bias": torch.randn(3 * d),
         "a.proj.weight": torch.randn(d, d), "a.proj.bias": torch.randn(d)}
    h = torch.randn(2, 1 + frames * patches, d)
    for mode in ("time", "space"):
        got = fit.divided_attention(h, w, "a", 1, frames, mode, None)
        assert torch.allclose(got, _divided_by_hand(h, w, "a", frames, mode), atol=1e-5)


def test_clip_text_reads_the_end_token_row_only():
    cfg = tiny.cell("clip_b16.msrvtt_zs_int8").config
    from port_bench.families import clip as family

    weights = family.make_weights(cfg, 3, "weights", "cpu")
    ids = torch.tensor([[98, 5, 6, 99, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]])
    after = ids.clone()
    after[0, 4:] = 7  # tokens after the end token: the causal mask hides them
    a, b = clip.encode_text(weights, ids, cfg), clip.encode_text(weights, after, cfg)
    assert torch.allclose(a, b, atol=1e-6)
    assert torch.allclose(a.norm(dim=-1), torch.ones(1), atol=1e-6)


def test_nce_and_kl_closed_forms():
    scores = torch.eye(2, dtype=torch.float64)
    assert math.isclose(float(train.nce(scores)), 2 * math.log(1 + math.exp(-1)), rel_tol=1e-12)
    s = torch.randn(3, 3, dtype=torch.float64)
    assert abs(float(train.kl_batchmean(s, s))) < 1e-12
    t = torch.tensor([[0.0, math.log(3.0)]], dtype=torch.float64)   # teacher (1/4, 3/4)
    st = torch.zeros(1, 2, dtype=torch.float64)                      # student (1/2, 1/2)
    expected = 0.25 * math.log(0.5) + 0.75 * math.log(1.5)
    assert math.isclose(float(train.kl_batchmean(st, t)), expected, rel_tol=1e-12)


def test_adamw_first_step_closed_form():
    p = {"w": torch.tensor([1.0, -2.0], dtype=torch.float64),
         "logit_scale": torch.tensor([3.0], dtype=torch.float64),
         "ts_logit_scale": torch.tensor([9.0], dtype=torch.float64)}
    g = {"w": torch.tensor([0.5, -4.0], dtype=torch.float64),
         "logit_scale": torch.tensor([1.0], dtype=torch.float64),
         "ts_logit_scale": torch.tensor([-1.0], dtype=torch.float64)}
    opt = train.AdamW(p, lr=0.1, weight_decay=0.01, betas=(0.9, 0.999), eps=1e-8,
                      max_logit_scale=5.0)
    opt.step(p, g)
    # First step: m / bc1 = g, v / bc2 = g^2, so the update is g / (|g| + eps).
    expected = torch.tensor([1.0 - 0.1 * (0.5 / (0.5 + 1e-8) + 0.01),
                             -2.0 - 0.1 * (-4.0 / (4.0 + 1e-8) - 0.02)], dtype=torch.float64)
    assert torch.allclose(p["w"], expected, atol=1e-12)
    assert float(p["ts_logit_scale"]) == 5.0   # clamped to the bound
    assert math.isclose(float(p["logit_scale"]), 3.0 - 0.1 * (1 / (1 + 1e-8) + 0.03),
                        rel_tol=1e-12)


def test_control_rounding():
    x = torch.tensor([[1.0, -0.5, 0.25, 0.0]])
    w = torch.tensor([[127.0, 0.0, 100.0, 0.0]])
    assert torch.equal(quant.linear(x, w, None, None), torch.tensor([[152.0]]))
    # 8 bits: x's step is 1/127 (0.25 -> 32/127), w's is 1 (exact).
    assert torch.allclose(quant.linear(x, w, None, 8), torch.tensor([[127 + 100 * 32 / 127]]))
    # 4 bits: x's step is 1/7 (0.25 -> 2/7), w's 127/7 (100 -> 6 steps).
    four = 127 + (2 / 7) * (6 * 127 / 7)
    assert torch.allclose(quant.linear(x, w, None, 4), torch.tensor([[four]]))
