"""The plain reference's parts against direct forms: the chunked SSD
against the recurrence step by step, the depthwise conv against its
sum, the AdamW schedule."""
import pytest
import torch

from cardbench.reference import lm


@pytest.mark.parametrize("S,chunk,G", [(16, 4, 1), (13, 4, 2), (8, 8, 1)])
def test_chunked_ssd_is_the_recurrence(S, chunk, G):
    g = torch.Generator().manual_seed(S)
    B, H, P, N = 2, 4, 3, 5
    x = torch.randn(B, S, H, P, generator=g)
    dt = torch.rand(B, S, H, generator=g) * 0.5
    A = -torch.rand(H, generator=g) - 0.5
    Bm = torch.randn(B, S, G, N, generator=g)
    Cm = torch.randn(B, S, G, N, generator=g)
    y = lm.ssd(x, dt, A, Bm, Cm, chunk)
    h = torch.zeros(B, H, N, P)
    grp = torch.arange(H) // (H // G)
    for t in range(S):
        h = (h * torch.exp(dt[:, t] * A)[..., None, None] +
             (dt[:, t, :, None, None] * Bm[:, t, grp][..., None] *
              x[:, t, :, None, :]))
        yt = torch.einsum("bhn,bhnp->bhp", Cm[:, t, grp], h)
        torch.testing.assert_close(y[:, t], yt, rtol=1e-5, atol=1e-5)


def test_depthwise_causal_conv_is_its_sum():
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(2, 7, 3, generator=g), torch.randn(4, 3, generator=g)
    y = lm.depthwise_causal_conv(x, w)
    for t in range(7):
        want = sum(w[k] * x[:, t - 3 + k] for k in range(4) if t - 3 + k >= 0)
        torch.testing.assert_close(y[:, t], want, rtol=1e-6, atol=1e-6)


def test_learning_rate_schedule():
    o = {"lr": 1.0, "warmup_steps": 10, "total_steps": 110}
    assert lm.learning_rate(o, 0) == pytest.approx(0.1)
    assert lm.learning_rate(o, 9) == pytest.approx(1.0)
    assert lm.learning_rate(o, 60) == pytest.approx(0.55)
    assert lm.learning_rate(o, 500) == pytest.approx(0.1)
