"""Repairs of the port's open faults, the parts that show on the CPU.

- TF32 in the fp32 patch embeddings: both ``patch_tokens`` methods run their
  convolution with cuDNN's TF32 off (the reference computes them at
  Precision.HIGHEST) and restore the global setting after.
- The lost FiT gradient: the trainer refuses an encoder whose divided
  attention would run K5 and K6, which are forward only.
- head_dim 32: the attention wrappers take ViT-S/16's head_dim 32 beside 64;
  the FiT kernels stay at 64.
The card's side of each is in tests/test_torch_kernels.py.
"""

import pytest
import torch
import torch.nn.functional as F

from fitclip_torch.ops import attention as A


@pytest.fixture
def conv_tf32_seen(monkeypatch):
    """F.conv2d wrapped to record cuDNN's allow_tf32 at each call."""
    seen = []
    conv2d = F.conv2d

    def recording(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(F, "conv2d", recording)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)  # the library default
    return seen


def _clip_vision():
    from fitclip_torch.models.clip.model import CLIPConfig, CLIPModel, TextConfig, VisionConfig

    config = CLIPConfig(embed_dim=16,
                        vision=VisionConfig(image_size=32, patch_size=16, width=64, layers=1,
                                            heads=1),
                        text=TextConfig(context_length=8, vocab_size=32, width=64, layers=1,
                                        heads=1))
    return CLIPModel(config).visual


def _fit_video():
    from fitclip_torch.models.frozen_in_time.encoder import (FrozenInTimeConfig,
                                                             FrozenInTimeVideoTextEncoder)

    cfg = FrozenInTimeConfig.tiny_test()
    return FrozenInTimeVideoTextEncoder(cfg, num_frames=cfg.num_frames).video, cfg


def test_clip_patch_embedding_runs_without_tf32(conv_tf32_seen):
    vision = _clip_vision()
    vision.patch_tokens(torch.rand(2, 32, 32, 3))
    assert conv_tf32_seen == [False]
    assert torch.backends.cudnn.allow_tf32 is True


def test_fit_patch_embedding_runs_without_tf32(conv_tf32_seen):
    video, cfg = _fit_video()
    video.patch_tokens(torch.rand(2, cfg.img_size, cfg.img_size, 3))
    assert conv_tf32_seen == [False]
    assert torch.backends.cudnn.allow_tf32 is True


def test_tf32_setting_is_restored_after_an_error(monkeypatch):
    from fitclip_torch.utils.precision import fp32_convolutions

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with pytest.raises(KeyError):
        with fp32_convolutions():
            assert torch.backends.cudnn.allow_tf32 is False
            raise KeyError("inside")
    assert torch.backends.cudnn.allow_tf32 is True


@pytest.mark.parametrize("device,fused,refused", [("meta", True, True), ("cpu", True, False),
                                                  ("meta", False, False)])
def test_trainer_refuses_fit_with_forward_only_attention(device, fused, refused):
    """Off the CPU a FiT encoder with fused_attention runs K5/K6, which have
    no backward: training it would drop the attention's gradient silently."""
    from fitclip_torch.models.frozen_in_time.encoder import (FrozenInTimeConfig,
                                                             FrozenInTimeVideoTextEncoder)
    from fitclip_torch.training.train_runner import _refuse_untrainable

    cfg = FrozenInTimeConfig.tiny_test()
    enc = FrozenInTimeVideoTextEncoder(cfg, num_frames=cfg.num_frames,
                                       fused_attention=fused).to(device)
    if refused:
        with pytest.raises(ValueError, match="K5 and K6"):
            _refuse_untrainable("student", enc)
    else:
        _refuse_untrainable("student", enc)


def test_head_dims_the_attention_kernels_take():
    qkv = torch.zeros(1, 5, 3 * 6 * 32)
    assert A._check_head_dim(qkv, 6) == 32
    assert A._check_head_dim(torch.zeros(1, 5, 3 * 12 * 64), 12) == 64
    with pytest.raises(ValueError, match="32 or 64"):
        A._check_head_dim(torch.zeros(1, 5, 3 * 4 * 16), 4)
    with pytest.raises(ValueError, match="head_dim 64"):
        A._check_head_dim(qkv, 6, (A.HEAD_DIM,))  # the FiT kernels' head_dim


def test_the_backward_plain_version_is_the_plain_attention_gradient():
    """The backward kernel's plain version (every L and head_dim it serves,
    here head_dim 32) is the autograd VJP of the plain attention."""
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(2, 9, 3 * 2 * 32, generator=gen)
    grad = torch.randn(2, 9, 2 * 32, generator=gen)
    leaf = qkv.clone().requires_grad_()
    A.attention_core_plain(leaf, 2, 32 ** -0.5, True).backward(grad)
    torch.testing.assert_close(leaf.grad,
                               A.attention_backward_plain(qkv, grad, 2, 32 ** -0.5, True),
                               atol=1e-5, rtol=1e-5)
