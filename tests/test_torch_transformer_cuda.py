"""The transformer prior on the card against the CPU.

Every test needs a CUDA device (the ``cuda`` marker) and skips without
one. The file imports no JAX, so it runs on a GPU host without it:
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_transformer_cuda.py``.

The preset's width (512 tokens, embed 256, 4 layers, 4 heads, 16
positions, 10 classes), seeded weights, dropout 0, full f32 (TF32 off):

- logits of a full forward within 1e-5 of their row's largest magnitude
  (the two devices sum the products in different orders);
- the card's KV-cache step against its own full-prefix forward, within
  the same bound;
- greedy (top_k = 1) sampling of 100 sequences: tokens equal to the CPU's
  except after a near-tie (the top two logits within 1e-5 relative).
"""
import pytest
import torch

from vqvae_tpu_torch.device import resolve_device
from vqvae_tpu_torch.models.transformer import Transformer, transformer_init_
from vqvae_tpu_torch.train.transformer_engine import sample_autoregressive

PRESET = dict(num_classes=10, num_tokens=512, embed_dim=256, n_layers=4,
              n_head=4, max_seq_len=16, dropout=0.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (card vs CPU)")
    return resolve_device("cuda")  # full f32


def _models(device):
    cpu = transformer_init_(Transformer(**PRESET),
                            torch.Generator().manual_seed(0)).eval()
    card = transformer_init_(Transformer(**PRESET),
                             torch.Generator().manual_seed(0)).to(
                                 device).eval()
    return cpu, card


def _close(a, b):
    scale = b.abs().amax(dim=-1, keepdim=True)
    return bool(((a.cpu() - b).abs() <= 1e-5 * scale + 1e-7).all())


@pytest.mark.cuda
def test_forward_on_card_matches_cpu(cuda_device):
    cpu, card = _models(cuda_device)
    g = torch.Generator().manual_seed(1)
    x = torch.randint(0, 512, (64, 15), generator=g)
    y = torch.randint(0, 10, (64,), generator=g)
    with torch.no_grad():
        want = cpu(x, y=y)
        got = card(x.to(cuda_device), y=y.to(cuda_device))
    assert _close(got, want)


@pytest.mark.cuda
def test_kv_cache_on_card_matches_full_prefix(cuda_device):
    _, card = _models(cuda_device)
    g = torch.Generator().manual_seed(2)
    x = torch.randint(0, 512, (32, 16), generator=g).to(cuda_device)
    y = torch.randint(0, 10, (32,), generator=g).to(cuda_device)
    with torch.no_grad():
        full = card(x, y=y)
        cache = card.init_cache(32)
        for i in range(16):
            step = card(x[:, i:i + 1], y=y, cache=cache)[:, 0]
            assert _close(step, full[:, i].cpu()), i


@pytest.mark.cuda
def test_greedy_sampling_on_card_matches_cpu(cuda_device):
    cpu, card = _models(cuda_device)
    g = torch.Generator().manual_seed(3)
    first = torch.randint(0, 512, (100, 1), generator=g)
    y = torch.arange(10).repeat_interleave(10)
    got = sample_autoregressive(
        card, first.to(cuda_device), 15,
        torch.Generator(device=cuda_device).manual_seed(0), top_k=1,
        labels=y.to(cuda_device)).cpu()
    want = sample_autoregressive(cpu, first, 15,
                                 torch.Generator().manual_seed(0), top_k=1,
                                 labels=y)
    for r in torch.nonzero((got != want).any(1)).flatten().tolist():
        # the first differing position must be a near-tie on the CPU
        c = int(torch.nonzero(got[r] != want[r])[0])
        with torch.no_grad():
            logits = cpu(want[r:r + 1, :c], y=y[r:r + 1])[0, -1]
        top2 = torch.topk(logits, 2).values
        assert float(top2[0] - top2[1]) <= 1e-5 * float(top2[0].abs())
